"""Device-resident soft block-FEC decode (fec/device.py): jittable
LLR -> deinterleave-gather -> codebook-matmul -> argmax pipeline,
equivalent to the host soft path and wired into Framesync64."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from liquid_dsp_tpu.fec.device import qpacket_soft_decoder, block_codebook
from liquid_dsp_tpu.framing.qpacket import (qpacketmodem_encode,
                                            qpacketmodem_decode,
                                            qpacketmodem_decode_soft)


def _noisy(syms, snr_db, rng):
    nstd = 10 ** (-snr_db / 20)
    n = (rng.standard_normal(syms.shape) +
         1j * rng.standard_normal(syms.shape))
    return (syms + nstd / np.sqrt(2) * n).astype(np.complex64)


class TestQpacketSoftDecoder:
    def test_matches_host_soft_path_golay(self):
        rng = np.random.default_rng(1)
        dev, fin = qpacket_soft_decoder(72, "crc24", "none", "golay2412",
                                        "qpsk")
        jdev = jax.jit(dev)
        for snr_db in (20.0, 8.0, 6.0):
            for _ in range(6):
                payload = rng.integers(0, 256, 72, dtype=np.uint8)
                noisy = _noisy(np.asarray(qpacketmodem_encode(payload)),
                               snr_db, rng)
                dec, ok = fin(np.asarray(jdev(jnp.asarray(noisy))))
                sb, sok = qpacketmodem_decode_soft(noisy, 72)
                assert bool(ok) == bool(sok)
                if ok:
                    assert np.array_equal(dec, payload)
                    assert np.array_equal(dec, sb)

    def test_soft_beats_hard_under_noise(self):
        # the device path is the soft criterion: at moderate SNR it must
        # decode at least every frame the hard path decodes
        rng = np.random.default_rng(2)
        dev, fin = qpacket_soft_decoder(72, "crc24", "none", "golay2412",
                                        "qpsk")
        jdev = jax.jit(dev)
        wins = ties = 0
        for _ in range(24):
            payload = rng.integers(0, 256, 72, dtype=np.uint8)
            noisy = _noisy(np.asarray(qpacketmodem_encode(payload)), 6.0, rng)
            _, ok = fin(np.asarray(jdev(jnp.asarray(noisy))))
            _, hok = qpacketmodem_decode(noisy, 72)
            assert bool(ok) >= bool(hok)
            wins += bool(ok) and not bool(hok)
            ties += bool(ok) == bool(hok)
        assert wins + ties == 24

    def test_batched_slots_and_channels(self):
        rng = np.random.default_rng(3)
        dev, fin = qpacket_soft_decoder(72, "crc24", "none", "golay2412",
                                        "qpsk")
        pls = [rng.integers(0, 256, 72, dtype=np.uint8) for _ in range(6)]
        S = np.stack([np.asarray(qpacketmodem_encode(p))
                      for p in pls]).reshape(3, 2, 600).astype(np.complex64)
        dec, ok = fin(np.asarray(jax.jit(dev)(jnp.asarray(S))))
        assert dec.shape == (3, 2, 72) and ok.shape == (3, 2)
        assert ok.all()
        for i, p in enumerate(pls):
            assert np.array_equal(dec.reshape(6, 72)[i], p)

    def test_hamming128_config(self):
        rng = np.random.default_rng(4)
        dev, fin = qpacket_soft_decoder(40, "crc32", "none", "hamming128",
                                        "qpsk")
        jdev = jax.jit(dev)
        for _ in range(4):
            payload = rng.integers(0, 256, 40, dtype=np.uint8)
            syms = np.asarray(qpacketmodem_encode(
                payload, "crc32", "none", "hamming128", "qpsk"))
            noisy = _noisy(syms, 14.0, rng)
            dec, ok = fin(np.asarray(jdev(jnp.asarray(noisy))))
            sb, sok = qpacketmodem_decode_soft(
                noisy, 40, "crc32", "none", "hamming128", "qpsk")
            assert bool(ok) == bool(sok)
            if ok:
                assert np.array_equal(dec, payload)

    def test_hamming128_odd_declen_padbits(self):
        # dec_len odd -> 8*enc_len exceeds ncw*n by 4 pad bits; the
        # codeword reshape must slice them off
        rng = np.random.default_rng(7)
        dev, fin = qpacket_soft_decoder(41, "crc16", "none", "hamming128",
                                        "qpsk")
        payload = rng.integers(0, 256, 41, dtype=np.uint8)
        syms = np.asarray(qpacketmodem_encode(
            payload, "crc16", "none", "hamming128", "qpsk"))
        dec, ok = fin(np.asarray(jax.jit(dev)(jnp.asarray(
            _noisy(syms, 18.0, rng)))))
        assert bool(ok) and np.array_equal(dec, payload)

    def test_rejects_unsupported(self):
        with pytest.raises(ValueError):
            qpacket_soft_decoder(72, "crc24", "rep3", "golay2412")
        with pytest.raises(ValueError):
            qpacket_soft_decoder(72, "crc24", "none", "v27")
        with pytest.raises(ValueError):
            qpacket_soft_decoder(72, "crc24", "none", "hamming3126")

    def test_codebook_shape(self):
        bip, n, k = block_codebook("golay2412")
        assert bip.shape == (24, 4096) and (np.abs(bip) == 1).all()


class TestGmskDeviceFec:
    def test_gmsk_stream_block_coded_payload(self):
        # golay2412 payload routes through the LLR-input device decoder
        # (packetizer_soft_decoder); decode must survive noise
        from liquid_dsp_tpu.framing.gmskframe import (GMSKFrameSync,
                                                      gmskframegen)
        rng = np.random.default_rng(11)
        hdr = rng.integers(0, 256, 8, dtype=np.uint8)
        pay = rng.integers(0, 256, 50, dtype=np.uint8)
        y = np.asarray(gmskframegen(hdr, pay, fec1="golay2412"))
        x = np.concatenate([np.zeros(500, np.complex64), y,
                            np.zeros(1200, np.complex64)])
        x = (x + 0.05 * (rng.standard_normal(len(x)) +
                         1j * rng.standard_normal(len(x)))
             ).astype(np.complex64)
        fs = GMSKFrameSync(block_len=4096)
        fs.execute(x)
        fs.flush()
        assert len(fs.frames) == 1
        got_hdr, h_ok, got_pay, p_ok, _ = fs.frames[0]
        assert h_ok and p_ok
        assert np.array_equal(got_hdr, hdr)
        assert np.array_equal(got_pay, pay)
        # the device decoder was actually selected for this config
        assert any(v is not None for v in fs._dev_fec_cache.values())

    def test_llr_decoder_matches_hard_on_clean_bits(self):
        from liquid_dsp_tpu.fec.device import packetizer_soft_decoder
        from liquid_dsp_tpu.fec.packetizer import (packetizer_encode,
                                                   packetizer_decode)
        from liquid_dsp_tpu.fec.block import unpack_bits
        rng = np.random.default_rng(12)
        dfn, fin = packetizer_soft_decoder(30, "crc16", "none", "golay2412")
        msg = rng.integers(0, 256, 30, dtype=np.uint8)
        enc = packetizer_encode(msg, "crc16", "none", "golay2412")
        llr = 2.0 * unpack_bits(enc).astype(np.float32) - 1.0
        dec, ok = fin(np.asarray(jax.jit(dfn)(jnp.asarray(llr))))
        assert bool(ok) and np.array_equal(dec, msg)
        ref, rok = packetizer_decode(enc, 30, "crc16", "none", "golay2412")
        assert bool(rok) and np.array_equal(ref, msg)


class TestFramesync64DeviceFec:
    def test_stream_decodes_with_device_fec(self):
        from liquid_dsp_tpu.framing.frame64 import Framesync64, framegen64

        rng = np.random.default_rng(5)
        frames = []
        stream = [np.zeros(700, np.complex64)]
        for _ in range(3):
            hdr = rng.integers(0, 256, 8, dtype=np.uint8)
            pay = rng.integers(0, 256, 64, dtype=np.uint8)
            frames.append((hdr, pay))
            stream.append(np.asarray(framegen64(hdr, pay)))
            stream.append(np.zeros(rng.integers(300, 900), np.complex64))
        x = np.concatenate(stream)
        x = (x + 0.02 * (rng.standard_normal(len(x)) +
                         1j * rng.standard_normal(len(x)))).astype(np.complex64)

        for device_fec in (True, False):
            fs = Framesync64(block_len=4096, device_fec=device_fec)
            fs.execute(x)
            fs.flush()
            assert len(fs.frames) == 3, device_fec
            for (hdr, pay), f in zip(frames, fs.frames):
                got_hdr, hdr_ok, got_pay, pay_ok, stats = f
                assert hdr_ok and pay_ok
                assert np.array_equal(got_hdr, hdr)
                assert np.array_equal(got_pay, pay)


class TestConvDeviceDecoder:
    """Batched device soft Viterbi (fec/device.py conv_soft_decoder):
    identical decisions to the host scan decoder, full packetizer-config
    round trips, v615 host-only rejection."""

    @pytest.mark.parametrize("scheme", ["v27", "v29", "v39", "v27p23",
                                        "v29p34", "v27p78"])
    def test_matches_host_viterbi(self, scheme):
        import jax
        from liquid_dsp_tpu.fec.conv import conv_encode, conv_decode
        from liquid_dsp_tpu.fec.device import conv_soft_decoder
        from liquid_dsp_tpu.fec.block import unpack_bits
        rng = np.random.default_rng(hash(scheme) % 2**31)
        dec_len = 20
        msg = rng.integers(0, 256, dec_len, dtype=np.uint8)
        enc = conv_encode(scheme, msg)
        bits = unpack_bits(enc).astype(np.float32)
        llr = (2 * bits - 1) * 4.0 + 0.8 * rng.standard_normal(
            len(bits)).astype(np.float32)
        dev_fn, _ = conv_soft_decoder(scheme, dec_len)
        got = np.packbits(np.asarray(jax.jit(dev_fn)(jnp.asarray(llr)))
                          .astype(np.uint8))[:dec_len]
        host = conv_decode(scheme, enc, dec_len, soft=llr)
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(got, msg)

    def test_batched_packet_config_with_crc(self):
        import jax
        from liquid_dsp_tpu.fec.device import conv_packet_soft_decoder
        from liquid_dsp_tpu.fec.packetizer import packetizer_encode
        from liquid_dsp_tpu.fec.block import unpack_bits
        rng = np.random.default_rng(7)
        dfn, fin = conv_packet_soft_decoder(32, "crc32", "v27", "none")
        msgs, llrs = [], []
        for _ in range(5):
            m = rng.integers(0, 256, 32, dtype=np.uint8)
            enc = packetizer_encode(m, "crc32", "v27", "none")
            bits = unpack_bits(enc).astype(np.float32)
            llrs.append((2 * bits - 1) * 4 +
                        rng.standard_normal(len(bits)).astype(np.float32))
            msgs.append(m)
        pl, ok = fin(np.asarray(jax.jit(dfn)(jnp.asarray(np.stack(llrs)))))
        assert ok.all()
        np.testing.assert_array_equal(pl, np.stack(msgs))

    def test_v615_rejected_host_only(self):
        from liquid_dsp_tpu.fec.device import conv_soft_decoder
        with pytest.raises(ValueError, match="16384 states"):
            conv_soft_decoder("v615", 8)

    def test_flexframe_stream_conv_payload_device_path(self):
        """A v27-coded flexframe payload decodes through the streaming
        receiver using the DEVICE Viterbi (the config previously fell
        back to host decode silently)."""
        from liquid_dsp_tpu.framing.flexframe import (flexframegen,
                                                      FlexFrameSync)
        rng = np.random.default_rng(9)
        hdr = rng.integers(0, 256, 14).astype(np.uint8)
        pay = rng.integers(0, 256, 40).astype(np.uint8)
        f = flexframegen(hdr, pay, ms="qpsk", crc="crc32",
                         fec0="v27", fec1="none")
        cap = np.zeros(12288, np.complex64)
        cap[900:900 + len(f)] += f
        cap += (0.01 * (rng.standard_normal(len(cap)) +
                        1j * rng.standard_normal(len(cap)))
                ).astype(np.complex64)
        fs = FlexFrameSync(block_len=4096)
        fs.execute(cap)
        fs.flush()
        assert len(fs.frames) == 1
        got_hdr, hok, got_pay, pok, st = fs.frames[0]
        assert hok and pok
        np.testing.assert_array_equal(got_pay, pay)
        # the decoder actually used was the device conv path
        key = (40, "crc32", "v27", "none", "qpsk")
        assert fs._dev_fec_cache.get(key) is not None


class TestDevicePacketFinish:
    """device_packet_finish must be byte- and verdict-exact vs the host
    finish (byte pack + reference-exact CRC) for every crc scheme and
    both decoder families."""

    @pytest.mark.parametrize("crc", ["none", "checksum", "crc8",
                                     "crc16", "crc24", "crc32"])
    @pytest.mark.parametrize("fec1", ["golay2412", "hamming74",
                                      "hamming1511"])
    def test_block_matches_host(self, crc, fec1):
        from liquid_dsp_tpu.fec.device import (packetizer_soft_decoder,
                                               device_packet_finish)
        from liquid_dsp_tpu.fec.packetizer import packetizer_encode
        rng = np.random.default_rng(
            zlib.crc32(f"{crc}-{fec1}".encode()))
        pl = 29
        dfn, fin = packetizer_soft_decoder(pl, crc, "none", fec1)
        dev_fin = jax.jit(device_packet_finish(pl, crc, "none", fec1))
        payloads = rng.integers(0, 256, (4, pl), dtype=np.uint8)
        llr = np.stack([
            2.0 * np.unpackbits(packetizer_encode(row, crc, "none", fec1))
            .astype(np.float32) - 1.0 for row in payloads])
        # clean + corrupted (first 40 llrs flipped) slots together
        llr = np.concatenate([llr, -llr[:, :]* np.where(
            np.arange(llr.shape[1]) < 40, 1.0, -1.0)], axis=0)
        msgs = np.asarray(dfn(jnp.asarray(llr)))
        pay_h, ok_h = fin(msgs)
        pay_d, ok_d = dev_fin(jnp.asarray(msgs))
        np.testing.assert_array_equal(np.asarray(pay_d), pay_h)
        np.testing.assert_array_equal(np.asarray(ok_d), ok_h)
        assert ok_h[:4].all()          # clean slots decode

    @pytest.mark.parametrize("crc,fec0", [("crc32", "v27"),
                                          ("crc16", "v29p34"),
                                          ("checksum", "v27p78")])
    def test_conv_matches_host(self, crc, fec0):
        from liquid_dsp_tpu.fec.device import (conv_packet_soft_decoder,
                                               device_packet_finish)
        from liquid_dsp_tpu.fec.packetizer import packetizer_encode
        rng = np.random.default_rng(5)
        pl = 21
        dfn, fin = conv_packet_soft_decoder(pl, crc, fec0, "none")
        dev_fin = jax.jit(device_packet_finish(pl, crc, fec0, "none"))
        payloads = rng.integers(0, 256, (3, pl), dtype=np.uint8)
        llr = np.stack([
            2.0 * np.unpackbits(packetizer_encode(row, crc, fec0, "none"))
            .astype(np.float32) - 1.0 for row in payloads])
        bits = np.asarray(dfn(jnp.asarray(llr)))
        pay_h, ok_h = fin(bits)
        pay_d, ok_d = dev_fin(jnp.asarray(bits))
        np.testing.assert_array_equal(np.asarray(pay_d), pay_h)
        np.testing.assert_array_equal(np.asarray(ok_d), ok_h)
        assert ok_h.all()

    def test_rejects_unknown_config(self):
        from liquid_dsp_tpu.fec.device import device_packet_finish
        with pytest.raises(ValueError):
            device_packet_finish(16, "crc16", "golay2412", "golay2412")


class TestPallasCodebookArgmax:
    """The fused codebook-argmax GPU kernel (ops/kernels/
    pallas_codebook.py, run here in interpret mode) must be
    value-identical to the einsum+argmax path it replaces on the GPU
    (same f32 scores, same tie-breaking)."""

    @pytest.mark.parametrize("scheme", ["golay2412", "hamming1511"])
    def test_matches_einsum(self, scheme):
        from liquid_dsp_tpu.fec.device import block_codebook
        from liquid_dsp_tpu.ops.kernels.pallas_codebook import \
            codebook_argmax
        bip, n, k = block_codebook(scheme)
        rng = np.random.default_rng(zlib.crc32(scheme.encode()))
        # 3 leading-dim shapes incl. a non-multiple of the 128 tile
        for shape in ((4, 50), (1, 128), (300,)):
            cw = rng.standard_normal(shape + (n,)).astype(np.float32)
            want = np.argmax(cw @ bip, axis=-1)
            got = np.asarray(codebook_argmax(
                jnp.asarray(cw), jnp.asarray(bip), interpret=True))
            np.testing.assert_array_equal(got, want)

    def test_ties_pick_first(self):
        from liquid_dsp_tpu.ops.kernels.pallas_codebook import \
            codebook_argmax
        # constant rows make every score equal: argmax must return 0
        bip = np.ones((8, 2048), np.float32)
        cw = np.ones((2, 130, 8), np.float32)
        got = np.asarray(codebook_argmax(
            jnp.asarray(cw), jnp.asarray(bip), interpret=True))
        assert (got == 0).all()

    @pytest.mark.parametrize("scheme", ["golay2412", "hamming1511"])
    def test_quantized_scores_and_cross_chunk_ties(self, scheme):
        # soft bits on a 2^-6 grid make every score exact in f32, so any
        # summation order gives the same scores; duplicate codebook
        # columns in different K chunks make exact ties, which must go
        # to the first index
        from liquid_dsp_tpu.fec.device import block_codebook
        from liquid_dsp_tpu.ops.kernels.pallas_codebook import \
            codebook_argmax
        bip, n, k = block_codebook(scheme)
        K = bip.shape[1]
        rng = np.random.default_rng(k)
        cw = (np.round(rng.standard_normal((3, 70, n)) * 64) / 64
              ).astype(np.float32)
        want = np.argmax(cw.astype(np.float64) @ bip, axis=-1)
        bip_t = bip.copy()
        bip_t[:, K - 1] = bip[:, want[0, 0]]     # tie in the last chunk
        got = np.asarray(codebook_argmax(cw, bip_t, interpret=True))
        np.testing.assert_array_equal(got, want)
        assert K in (2048, 4096)

    def test_rejects_codebook_that_does_not_fit(self):
        from liquid_dsp_tpu.ops.kernels.pallas_codebook import \
            codebook_argmax
        with pytest.raises(ValueError):
            codebook_argmax(np.zeros((4, 40), np.float32),
                            np.ones((40, 2048), np.float32),
                            interpret=True)
