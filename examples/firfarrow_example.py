"""Farrow fractional-delay filter sweep
(reference firfarrow_rrrf_sample.c): delay a tone by sub-sample amounts
and measure the achieved group delay from the phase slope."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.misc_filters import firfarrow

h_len, p = 19, 17
fc = 0.05
n = 512
t = np.arange(n)
x = np.cos(2 * np.pi * fc * t).astype(np.float32)

for mu in (-0.40, -0.25, 0.0, 0.25, 0.40):
    q = firfarrow(h_len=h_len, mu=mu, fc=0.45, as_db=60.0)
    y, _ = q(jnp.asarray(x))
    y = np.asarray(y)
    # measure delay via cross-correlation phase at the tone frequency
    ph_x = np.angle(np.sum(x[64:] * np.exp(-2j * np.pi * fc * t[64:])))
    ph_y = np.angle(np.sum(y[64:] * np.exp(-2j * np.pi * fc * t[64:])))
    d = (ph_x - ph_y) / (2 * np.pi * fc)
    d = d % (1.0 / fc)
    print(f"mu = {mu:+.2f}: measured delay = {d:6.3f} samples "
          f"(nominal {(h_len - 1) / 2 + mu:6.3f})")
