"""Mu-law companding of real and complex signals
(reference compand_example.c / compand_cf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.quantization import (
    compress_mulaw, expand_mulaw, compress_cf_mulaw, expand_cf_mulaw,
    quantize_adc, quantize_dac)

mu = 255.0
x = np.linspace(-1, 1, 11).astype(np.float32)
y = np.asarray(compress_mulaw(x, mu))
z = np.asarray(expand_mulaw(y, mu))
print("      x       compress   expand")
for xi, yi, zi in zip(x, y, z):
    print(f"  {xi:+8.4f}  {yi:+8.4f}  {zi:+8.4f}")
assert np.allclose(x, z, atol=1e-5)

# companding concentrates quantizer resolution near zero: compare the
# round-trip error of a 4-bit ADC with and without the compander on a
# small-amplitude signal
rng = np.random.default_rng(7)
s = (0.05 * rng.standard_normal(4096)).astype(np.float32).clip(-1, 1)
plain = np.asarray(quantize_dac(quantize_adc(s, 4), 4))
companded = np.asarray(expand_mulaw(
    quantize_dac(quantize_adc(compress_mulaw(s, mu), 4), 4), mu))
e0 = np.sqrt(np.mean((plain - s) ** 2))
e1 = np.sqrt(np.mean((companded - s) ** 2))
print(f"4-bit quantization rmse: plain {e0:.5f}, mu-law companded {e1:.5f} "
      f"({e0 / e1:.1f}x better)")
assert e1 < e0

# complex form operates on re/im independently (reference compand_cf)
c = (0.3 * (rng.standard_normal(64) + 1j * rng.standard_normal(64))
     ).astype(np.complex64).clip(-1, 1)
rc = np.asarray(expand_cf_mulaw(compress_cf_mulaw(c, mu), mu))
assert np.allclose(rc, c, atol=1e-5)
print("complex mu-law round trip max err:", float(np.abs(rc - c).max()))
