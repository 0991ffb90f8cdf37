"""Windowed autocorrelation exposes a hidden periodicity
(reference autocorr_cccf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.fir import autocorr

rng = np.random.default_rng(0)
n, period = 2048, 16
base = rng.standard_normal(period) + 1j * rng.standard_normal(period)
x = (np.tile(base, n // period) +
     0.5 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
     ).astype(np.complex64)
q = autocorr(window_size=64, delay=period)
r, _ = q(jnp.asarray(x), batch_shape=())
r0 = autocorr(window_size=64, delay=1)
ra, _ = r0(jnp.asarray(x), batch_shape=())
print(f"mean |rxx| at lag {period} (true period): "
      f"{np.mean(np.abs(np.asarray(r)[200:])):.1f}")
print(f"mean |rxx| at lag 1  (off-period)      : "
      f"{np.mean(np.abs(np.asarray(ra)[200:])):.1f}")
