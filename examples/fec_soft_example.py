"""Soft-decision FEC beats hard-decision at the same SNR
(reference fec_soft_example.c).

Soft convention: one float per encoded bit, positive = bit 1
(fec_decode_soft docstring)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.fec.dispatch import fec_encode, fec_decode, fec_decode_soft
from liquid_dsp_tpu.fec.block import unpack_bits, pack_bits

rng = np.random.default_rng(21)
scheme, n, trials, sigma = "v27", 32, 40, 0.9

hard_err = soft_err = 0
for _ in range(trials):
    msg = rng.integers(0, 256, n).astype(np.uint8)
    enc = np.asarray(fec_encode(scheme, msg))
    bits = unpack_bits(enc).astype(np.float32)
    rx = (2 * bits - 1) + sigma * rng.standard_normal(bits.size)

    hard = pack_bits((rx > 0).astype(np.uint8))[: len(enc)]
    dec_h = np.asarray(fec_decode(scheme, hard, n))
    hard_err += int(np.sum(np.unpackbits(dec_h[:n]) != np.unpackbits(msg)))

    dec_s = np.asarray(fec_decode_soft(scheme, rx, n))
    soft_err += int(np.sum(np.unpackbits(dec_s[:n]) != np.unpackbits(msg)))

tot = trials * n * 8
snr_db = 20 * np.log10(1 / sigma)
print(f"{scheme} at {snr_db:.1f} dB bit SNR over {trials} packets:")
print(f"  hard-decision BER: {hard_err / tot:.5f}")
print(f"  soft-decision BER: {soft_err / tot:.5f}")
assert soft_err <= hard_err
