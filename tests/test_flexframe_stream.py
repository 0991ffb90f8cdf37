"""Streaming multi-frame flexframesync: header-dependent payload
geometry resolved mid-stream, every frame decodes exactly once across
block boundaries, under impairments, with mixed schemes — the
reference's callback-per-frame re-arm semantics (reference
src/framing/src/flexframesync.c) realized as a two-stage device pipeline
(jittable header-stage Proc + bucketed payload gather)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from liquid_dsp_tpu.framing.flexframe import (
    flexframegen, flexframesync_stream, FlexFrameSync, FLEXFRAME_H_USER)


def _mkframe(rng, n=64, **kw):
    h = rng.integers(0, 256, FLEXFRAME_H_USER).astype(np.uint8)
    p = rng.integers(0, 256, n).astype(np.uint8)
    return h, p, flexframegen(h, p, **kw)


def _stream(rng, frames, gaps, tail=2000, noise=0.005):
    parts, starts, pos = [], [], 0
    for (h, p, f), gap in zip(frames, gaps):
        parts.append(np.zeros(gap, np.complex64))
        pos += gap
        starts.append(pos)
        parts.append(f)
        pos += len(f)
    parts.append(np.zeros(tail, np.complex64))
    x = np.concatenate(parts)
    x = x + noise * (rng.standard_normal(len(x)) +
                     1j * rng.standard_normal(len(x))).astype(np.complex64)
    return x.astype(np.complex64), starts


def _run(x, block_len=4096, threshold=0.5):
    fs = FlexFrameSync(block_len=block_len, threshold=threshold)
    got = fs.execute(x)
    got += fs.flush()
    return got


class TestMultiFrame:
    def test_k_frames_mixed_schemes_all_decode(self):
        rng = np.random.default_rng(1)
        specs = [dict(n=64, ms="qpsk", fec1="golay2412"),
                 dict(n=40, ms="qam16", fec0="hamming128", fec1="none"),
                 dict(n=100, ms="psk8", fec0="secded7264", fec1="hamming84"),
                 dict(n=17, ms="bpsk", fec1="none")]
        frames = [_mkframe(rng, s.pop("n"), **s) for s in specs]
        gaps = [int(rng.integers(200, 2500)) for _ in frames]
        x, starts = _stream(rng, frames, gaps)
        got = _run(x)
        assert len(got) == 4
        for (h, p, _), (gh, hok, gp, pok, st), s0 in zip(frames, got, starts):
            assert hok and pok
            np.testing.assert_array_equal(gh, h)
            np.testing.assert_array_equal(gp, p)
            assert abs(st["sample_index"] - s0) <= 2

    def test_frame_straddles_block_boundary(self):
        rng = np.random.default_rng(2)
        h, p, f = _mkframe(rng, 56)
        B = 2048
        for start in [B - len(f) - 1, B - len(f) // 2, B - 1, B + 1,
                      2 * B - 300]:
            x = np.zeros(start + len(f) + 3000, np.complex64)
            x[start:start + len(f)] = f
            got = _run(x, block_len=B)
            assert len(got) == 1, (start, len(got))
            gh, hok, gp, pok, st = got[0]
            assert hok and pok and np.array_equal(gp, p), start
            assert abs(st["sample_index"] - start) <= 2

    @pytest.mark.slow
    def test_payload_spans_many_blocks(self):
        # 2000-byte payload ~ 16k+ samples: the payload completes several
        # blocks after its header decodes (pending-candidate path)
        rng = np.random.default_rng(3)
        h, p, f = _mkframe(rng, 2000, ms="qpsk", fec1="none")
        assert len(f) > 4 * 2048
        x = np.zeros(1000 + len(f) + 2000, np.complex64)
        x[1000:1000 + len(f)] = f
        got = _run(x, block_len=2048)
        assert len(got) == 1
        gh, hok, gp, pok, st = got[0]
        assert hok and pok
        np.testing.assert_array_equal(gp, p)

    def test_channel_impairments(self):
        rng = np.random.default_rng(4)
        frames = [_mkframe(rng, 48) for _ in range(3)]
        gaps = [500, 1700, 900]
        x, starts = _stream(rng, frames, gaps, noise=0.0)
        t = np.arange(len(x))
        x = (x * 0.2 * np.exp(1j * (0.008 * t + 1.0))).astype(np.complex64)
        sigma = 0.2 * 10 ** (-15 / 20) / np.sqrt(2)
        x = (x + sigma * (rng.standard_normal(len(x)) +
                          1j * rng.standard_normal(len(x)))
             ).astype(np.complex64)
        got = _run(x)
        assert len(got) == 3
        for (h, p, _), g in zip(frames, got):
            assert g[1] and g[3] and np.array_equal(g[2], p)
            assert abs(g[4]["cfo"] - 0.008) < 5e-4

    def test_back_to_back_frames(self):
        rng = np.random.default_rng(5)
        frames = [_mkframe(rng, 32) for _ in range(4)]
        gaps = [100, 40, 40, 40]
        x, starts = _stream(rng, frames, gaps)
        got = _run(x)
        assert len(got) == 4
        for (h, p, _), g in zip(frames, got):
            assert g[1] and g[3] and np.array_equal(g[2], p)

    def test_no_false_frames_on_noise(self):
        rng = np.random.default_rng(6)
        x = (0.3 * (rng.standard_normal(20000) +
                    1j * rng.standard_normal(20000))).astype(np.complex64)
        got = _run(x)
        assert len(got) == 0

    def test_callback_contract(self):
        rng = np.random.default_rng(7)
        h, p, f = _mkframe(rng, 24)
        hits = []
        fs = FlexFrameSync(callback=lambda *a: hits.append(a))
        fs.execute(np.concatenate([np.zeros(400, np.complex64), f]))
        fs.flush()
        assert len(hits) == 1 and fs.num_frames_detected == 1
        gh, hok, gp, pok, st = hits[0]
        assert hok and pok
        np.testing.assert_array_equal(gh, h)
        np.testing.assert_array_equal(gp, p)

    def test_interop_reference_frames(self):
        """The streaming receiver decodes a stream of three frames the
        REFERENCE flexframegen transmitted (mixed schemes, one golden
        capture each; tools/gen_flexframe_golden.py)."""
        import pathlib
        path = pathlib.Path(__file__).parent / "golden/flexframe_golden.npz"
        if not path.exists():
            pytest.skip("flexframe_golden.npz not generated")
        fg = dict(np.load(path))
        cases = [("ffg_a", 64, 21), ("ffg_b", 40, 33), ("ffg_c", 100, 55)]

        def fill(n, seed):
            s, out = seed, []
            for _ in range(n):
                s = (s * 1103515245 + 12345) & 0xFFFFFFFF
                out.append((s >> 16) & 0xFF)
            return np.asarray(out, np.uint8)

        parts = []
        for tag, n, seed in cases:
            parts.append(np.zeros(700, np.complex64))
            parts.append(fg[tag])
        parts.append(np.zeros(500, np.complex64))
        got = _run(np.concatenate(parts))
        assert len(got) == 3
        for (tag, n, seed), (gh, hok, gp, pok, st) in zip(cases, got):
            assert hok and pok
            np.testing.assert_array_equal(gh, fill(14, seed))
            np.testing.assert_array_equal(gp, fill(n, seed + 1))


class TestStreamProcDirect:
    def test_jit_compiles_and_runs_empty(self):
        proc = flexframesync_stream(2048)
        f = jax.jit(proc.apply)
        c = proc.init()
        out, c = f((), c, jnp.zeros(2048, jnp.complex64))
        assert not bool(np.asarray(out.valid).any())

    def test_vmap_two_channels(self):
        rng = np.random.default_rng(8)
        (h0, p0, f0), (h1, p1, f1) = _mkframe(rng, 20), _mkframe(rng, 20)
        T = 4096
        x = np.zeros((2, 2 * T), np.complex64)
        x[0, 300:300 + len(f0)] = f0
        x[1, 2500:2500 + len(f1)] = f1
        proc = flexframesync_stream(T)
        carry = proc.init(batch_shape=(2,))
        hits = {}
        for b in range(2):
            out, carry = proc.jitted((), carry,
                                     jnp.asarray(x[:, b * T:(b + 1) * T]))
            o = jax.tree_util.tree_map(np.asarray, out)
            for ch in range(2):
                for s in range(o.valid.shape[1]):
                    if o.valid[ch, s]:
                        hits.setdefault(ch, []).append(
                            int(o.sample_index[ch, s]))
        assert len(hits[0]) == 1 and abs(hits[0][0] - 300) <= 2
        assert len(hits[1]) == 1 and abs(hits[1][0] - 2500) <= 2


class TestFlexFullDeviceRX:
    """flexframe_rx_stream: the FULL fixed-config receiver in one jitted
    block step — detect, sync, two-stage header decode (hamming84
    codebook + SECDED syndrome matmuls), payload decode, byte pack +
    CRC all on device."""

    def _drain(self, proc, stream, block):
        import jax
        c = proc.init()
        step = jax.jit(proc.apply)
        found = []
        nb = len(stream) // block
        for b in range(nb):
            out, c = step((), c, jnp.asarray(stream[b*block:(b+1)*block]))
            v = np.asarray(out.valid)
            for p in np.nonzero(v)[0]:
                found.append((int(np.asarray(out.sample_index[p])),
                              bool(np.asarray(out.hdr_ok[p])),
                              np.asarray(out.hdr_bytes[p]).astype(np.uint8),
                              bool(np.asarray(out.pay_ok[p])),
                              np.asarray(out.pay_bytes[p]).astype(np.uint8)))
        return found

    def test_frames_straddle_blocks_decode_once(self):
        from liquid_dsp_tpu.framing.flexframe import flexframe_rx_stream
        rng = np.random.default_rng(0)
        T, PL = 2048, 64
        proc = flexframe_rx_stream(T, PL)
        frames = [_mkframe(rng, PL) for _ in range(3)]
        # place one frame straddling each block boundary
        x, starts = _stream(rng, frames, gaps=[1500, 900, 1100],
                            tail=4000, noise=0.003)
        pad = (-len(x)) % T
        x = np.concatenate([x, np.zeros(pad + 2 * T, np.complex64)])
        found = self._drain(proc, x, T)
        assert len(found) == 3, [f[0] for f in found]
        for (idx, hok, hdr, pok, pay), (h, p, _), s in zip(found, frames,
                                                          starts):
            assert abs(idx - s) <= 2
            assert hok and pok
            assert (hdr[:FLEXFRAME_H_USER] == h).all()
            assert (pay == p).all()

    def test_cfo_noise_margin(self):
        from liquid_dsp_tpu.framing.flexframe import flexframe_rx_stream
        rng = np.random.default_rng(1)
        T, PL = 2048, 40
        proc = flexframe_rx_stream(T, PL)
        h, p, f = _mkframe(rng, PL)
        n = np.arange(len(f))
        f = (f * np.exp(1j * (0.002 * n + 0.7))).astype(np.complex64)
        x, _ = _stream(rng, [(h, p, f)], gaps=[700], tail=3000,
                       noise=0.01)            # ~20 dB SNR
        pad = (-len(x)) % T
        x = np.concatenate([x, np.zeros(pad + 2 * T, np.complex64)])
        found = self._drain(proc, x, T)
        assert len(found) == 1
        _, hok, hdr, pok, pay = found[0]
        assert hok and pok and (pay == p).all()

    def test_wrong_config_header_rejected(self):
        # a frame announcing a DIFFERENT payload config must come back
        # hdr_ok=False (deployed-link semantics), not crash
        from liquid_dsp_tpu.framing.flexframe import flexframe_rx_stream
        rng = np.random.default_rng(2)
        T, PL = 2048, 40
        proc = flexframe_rx_stream(T, PL, ms="qpsk")
        h = rng.integers(0, 256, FLEXFRAME_H_USER).astype(np.uint8)
        p = rng.integers(0, 256, PL).astype(np.uint8)
        f = flexframegen(h, p, ms="qam16")      # wrong modulation
        x, _ = _stream(rng, [(h, p, f)], gaps=[700], tail=3000,
                       noise=0.003)
        pad = (-len(x)) % T
        x = np.concatenate([x, np.zeros(pad + 2 * T, np.complex64)])
        found = self._drain(proc, x, T)
        assert len(found) >= 1
        assert not found[0][1]                  # hdr_ok False

    def test_too_long_config_raises(self):
        from liquid_dsp_tpu.framing.flexframe import flexframe_rx_stream
        # hist override covers long frames: a 256-byte payload builds
        proc = flexframe_rx_stream(2048, 256)
        assert proc is not None


class TestMultiConfigDeviceRX:
    """Header-adaptive full-device receiver (flexframe_rx_stream_multi):
    a registered SET of payload configs decodes in one stream on device;
    unregistered configs report hdr_ok False."""

    CONFIGS = [(48, "crc32", "none", "golay2412", "qpsk"),
               (96, "crc16", "none", "hamming128", "qam16"),
               (32, "crc32", "v27", "none", "qpsk")]

    def _drain(self, proc, stream, block):
        c = proc.init()
        step = jax.jit(proc.apply)
        found = []
        nb = len(stream) // block
        for b in range(nb):
            out, c = step((), c,
                          jnp.asarray(stream[b * block:(b + 1) * block]))
            v = np.asarray(out.valid)
            for p in np.nonzero(v)[0]:
                found.append((
                    int(np.asarray(out.sample_index[p])),
                    bool(np.asarray(out.hdr_ok[p])),
                    int(np.asarray(out.cfg_idx[p])),
                    np.asarray(out.hdr_bytes[p]).astype(np.uint8),
                    bool(np.asarray(out.pay_ok[p])),
                    np.asarray(out.pay_bytes[p]).astype(np.uint8)))
        return found

    def test_mixed_config_stream_decodes(self):
        from liquid_dsp_tpu.framing.flexframe import \
            flexframe_rx_stream_multi
        rng = np.random.default_rng(11)
        T = 4096
        proc = flexframe_rx_stream_multi(T, self.CONFIGS)
        # interleave frames of all three registered configs
        order = [0, 1, 2, 1, 0, 2]
        frames = []
        for j in order:
            pl, crc, fec0, fec1, ms = self.CONFIGS[j]
            h = rng.integers(0, 256, FLEXFRAME_H_USER).astype(np.uint8)
            p = rng.integers(0, 256, pl).astype(np.uint8)
            frames.append((j, h, p, flexframegen(
                h, p, crc=crc, fec0=fec0, fec1=fec1, ms=ms)))
        gaps = [int(rng.integers(900, 2200)) for _ in frames]
        x, starts = _stream(rng, [(h, p, f) for _, h, p, f in frames],
                            gaps, tail=3000, noise=0.004)
        pad = (-len(x)) % T
        x = np.concatenate([x, np.zeros(pad + 3 * T, np.complex64)])
        found = self._drain(proc, x, T)
        assert len(found) == len(frames), [f[0] for f in found]
        for (idx, hok, cidx, hdr, pok, pay), (j, h, p, _), s0 in zip(
                found, frames, starts):
            assert abs(idx - s0) <= 2
            assert hok and pok, (idx, hok, pok)
            assert cidx == j
            np.testing.assert_array_equal(hdr[:FLEXFRAME_H_USER], h)
            np.testing.assert_array_equal(pay[:len(p)], p)

    def test_unregistered_config_rejected(self):
        from liquid_dsp_tpu.framing.flexframe import \
            flexframe_rx_stream_multi
        rng = np.random.default_rng(12)
        T = 4096
        proc = flexframe_rx_stream_multi(T, self.CONFIGS[:2])
        h = rng.integers(0, 256, FLEXFRAME_H_USER).astype(np.uint8)
        p = rng.integers(0, 256, 20).astype(np.uint8)
        f = flexframegen(h, p, ms="psk8")     # not registered
        x, _ = _stream(rng, [(h, p, f)], gaps=[700], tail=3000,
                       noise=0.003)
        pad = (-len(x)) % T
        x = np.concatenate([x, np.zeros(pad + 2 * T, np.complex64)])
        found = self._drain(proc, x, T)
        assert len(found) >= 1
        assert not found[0][1] and found[0][2] == -1
