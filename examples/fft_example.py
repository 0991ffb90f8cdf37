"""FFT plans for arbitrary sizes (power-of-two, composite, prime) and
real-to-real transforms (reference fft_example.c / fct_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.fft import fft_plan, dct

rng = np.random.default_rng(7)
for n in (64, 60, 127, 509):  # 2^m, composite, primes
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    plan = fft_plan(n)
    y = np.asarray(plan(jnp.asarray(x)))
    err = np.abs(y - np.fft.fft(x)).max()
    kind = "pow2" if n & (n - 1) == 0 else "bluestein"
    print(f"n = {n:4d} ({kind:9s}): max |err| vs direct DFT = {err:.2e}")

x = rng.standard_normal(32).astype(np.float32)
y2 = np.asarray(dct(jnp.asarray(x), type=2))
import scipy.fft as sfft  # available in the image; reference checks vs Octave
print(f"DCT-II max err vs scipy: {np.abs(y2 - sfft.dct(x, type=2)).max():.2e}")
