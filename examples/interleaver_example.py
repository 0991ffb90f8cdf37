"""Block interleaving spreads burst errors so FEC can correct them
(reference interleaver_example.c / interleaver_scatterplot_example.c).

The interleaver permutes bytes, so it disperses BYTE bursts; paired
with a convolutional code (whose Viterbi decoder handles scattered
errors but not dense runs) the benefit is dramatic."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.fec.interleave import interleave, deinterleave
from liquid_dsp_tpu.fec.dispatch import fec_encode, fec_decode

rng = np.random.default_rng(7)
n = 64
msg = rng.integers(0, 256, n).astype(np.uint8)
enc = np.asarray(fec_encode("v27", msg))

for nb in (3, 8):
    il = np.asarray(interleave(enc))
    burst = il.copy()
    burst[40:40 + nb] ^= 0xFF                  # nb-byte burst on the wire
    dec = np.asarray(fec_decode("v27", deinterleave(burst), n))

    noil = enc.copy()
    noil[40:40 + nb] ^= 0xFF
    dec2 = np.asarray(fec_decode("v27", noil, n))
    print(f"{nb}-byte burst through v27: "
          f"interleaved {int(np.sum(dec != msg))} byte errors, "
          f"without interleaver {int(np.sum(dec2 != msg))}")
assert np.array_equal(dec, msg)
