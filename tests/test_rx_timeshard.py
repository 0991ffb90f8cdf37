"""Time-sharded streaming receiver (parallel/rx.py): N-device output
must decode exactly the frames the 1-device receiver decodes — with
frames deliberately STRADDLING shard boundaries — and the carry
(buffer/watermark) must replicate so multi-block streams stay
equivalent.  Runs on the conftest-forced 8-virtual-device CPU mesh
(SURVEY §2.12 sequence parallelism)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from liquid_dsp_tpu.framing.frame64 import (framegen64, framesync64_stream,
                                            FRAME64_LEN)
from liquid_dsp_tpu.parallel.rx import framesync64_time_sharded


def _mesh(n):
    devs = np.array(jax.devices()[:n]).reshape(n)
    return Mesh(devs, ("t",))


def _capture(T, K, rng, offsets):
    """K blocks with frames at the given absolute sample offsets."""
    x = np.zeros(K * T, np.complex64)
    sent = []
    for s0 in offsets:
        hdr = rng.integers(0, 256, 8, dtype=np.uint8)
        pay = rng.integers(0, 256, 64, dtype=np.uint8)
        f = np.asarray(framegen64(hdr, pay))
        x[s0:s0 + len(f)] += f
        sent.append((s0, hdr, pay))
    x += (0.004 * (rng.standard_normal(len(x))
                   + 1j * rng.standard_normal(len(x)))
          ).astype(np.complex64)
    return x.reshape(K, T), sent


def _run_single(x, T):
    proc = framesync64_stream(T)
    c = proc.init()
    frames = {}
    for k in range(x.shape[0]):
        out, c = jax.jit(proc.apply)((), c, jnp.asarray(x[k]))
        v = np.asarray(out.valid)
        si = np.asarray(out.sample_index)
        sy = np.asarray(out.symbols)
        for p in np.nonzero(v)[0]:
            frames[int(si[p])] = sy[p]
    return frames


def _run_sharded(x, T, n):
    init, step = framesync64_time_sharded(T, _mesh(n))
    jstep = jax.jit(step)
    c = init()
    frames = {}
    for k in range(x.shape[0]):
        out, c = jstep(c, jnp.asarray(x[k]))
        v = np.asarray(out.valid)
        si = np.asarray(out.sample_index)
        sy = np.asarray(out.symbols)
        for p in np.nonzero(v)[0]:
            frames[int(si[p])] = sy[p]
    return frames, c


class TestFrame64TimeShard:
    T = 16384          # 8 shards of 2048 >= the 1561-sample halo

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_matches_single_device(self, n):
        rng = np.random.default_rng(100 + n)
        K = 3
        Tl = self.T // n
        # frame starts chosen to STRADDLE shard boundaries: one just
        # before a boundary (its span crosses into the next shard), one
        # exactly ON a boundary, one mid-shard, one crossing a BLOCK
        # boundary — plus margin from the absolute stream head
        cands = [Tl - FRAME64_LEN // 3,              # straddles shard 0/1
                 2 * Tl % self.T or Tl + 2048,       # starts on a boundary
                 3 * Tl % self.T + 511,              # mid-shard, odd align
                 self.T - FRAME64_LEN // 2,          # block boundary
                 self.T + Tl - FRAME64_LEN + 7,      # straddles, block 2
                 2 * self.T + 1000]
        # keep frames non-overlapping (suppression would drop overlaps
        # identically in both runs, but the count assert wants all)
        offsets, last = [], -(1 << 30)
        for s0 in sorted(set(cands)):
            if s0 - last > FRAME64_LEN + 600 and \
                    s0 + FRAME64_LEN < K * self.T:
                offsets.append(s0)
                last = s0
        x, sent = _capture(self.T, K, rng, offsets)
        ref = _run_single(x, self.T)
        got, carry = _run_sharded(x, self.T, n)
        assert set(got) == set(ref), (
            f"decoded sample_index sets differ: {sorted(got)} vs "
            f"{sorted(ref)}")
        assert len(ref) == len(sent)
        for si in ref:
            np.testing.assert_allclose(got[si], ref[si], atol=2e-5)

    def test_carry_replicates_and_decodes_all(self):
        # the decoded payloads must round-trip the FEC exactly (device
        # decode on the gathered symbols), proving the straddling
        # frames' symbol windows were assembled from real halo data
        from liquid_dsp_tpu.fec.device import qpacket_soft_decoder
        rng = np.random.default_rng(7)
        Tl = self.T // 4
        offsets = [Tl - 300, 2 * Tl - 700, 3 * Tl + 100,
                   self.T + Tl - 400]
        x, sent = _capture(self.T, 3, rng, offsets)
        got, carry = _run_sharded(x, self.T, 4)
        dev, fin = qpacket_soft_decoder(72, "crc24", "none", "golay2412",
                                        "qpsk")
        sent_by_si = {}
        for s0, hdr, pay in sent:
            sent_by_si[s0] = (hdr, pay)
        assert len(got) == len(sent)
        for si, syms in got.items():
            msgs = np.asarray(jax.jit(dev)(jnp.asarray(syms)))
            buf, ok = fin(msgs)
            assert bool(ok), f"CRC failed for frame at {si}"
            hdr, pay = sent_by_si[si]
            np.testing.assert_array_equal(buf[:8], hdr)
            np.testing.assert_array_equal(buf[8:], pay)

    def test_single_shard_mesh_degenerates_cleanly(self):
        # n=1: ppermute is a self-loop and the all-gather is size 1 —
        # the sharded step must equal the plain receiver exactly
        rng = np.random.default_rng(3)
        T = 4096
        x, sent = _capture(T, 2, rng, [1000, T + 2000])
        ref = _run_single(x, T)
        got, _ = _run_sharded(x, T, 1)
        assert set(got) == set(ref) and len(ref) == 2
        for si in ref:
            np.testing.assert_allclose(got[si], ref[si], atol=2e-5)

    def test_watermark_replicates_across_shards(self):
        # regression (r5 review): a frame detected on shard j>0 must
        # advance last_end IDENTICALLY on every shard and match the
        # single-device receiver (the gate used the LOCAL candidate
        # count before the fix, so only the detecting shard advanced)
        rng = np.random.default_rng(0)
        T, n = 16384, 4
        x = np.zeros(T, np.complex64)
        x[2 * 4096:2 * 4096 + FRAME64_LEN] = np.asarray(framegen64(
            np.arange(8, dtype=np.uint8), np.arange(64, dtype=np.uint8)))
        x += (0.004 * (rng.standard_normal(T)
                       + 1j * rng.standard_normal(T))).astype(np.complex64)
        init, step = framesync64_time_sharded(T, _mesh(n))
        out, c = jax.jit(step)(init(), jnp.asarray(x))
        vals = {int(np.asarray(s.data))
                for s in c["last_end"].addressable_shards}
        rx1 = framesync64_stream(T, max_frames=16)
        _, c1 = rx1.apply((), rx1.init(), jnp.asarray(x))
        assert vals == {int(np.asarray(c1["last_end"]))}
