"""Hilbert transform pair: real signal -> analytic -> back
(reference firhilb_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.fir import firhilb, firhilb_interp

m, as_db = 5, 60.0
n = 512
fc = 0.123
x = np.cos(2 * np.pi * fc * np.arange(n)).astype(np.float32)

# real -> complex 2:1 decimator: tone appears at 2*fc - 0.5... (shifted)
q = firhilb(m, as_db)
y, _ = q(jnp.asarray(x), batch_shape=())
y = np.asarray(y)
f_pk = np.fft.fftfreq(len(y))[np.argmax(np.abs(np.fft.fft(y)))]
print(f"r2c decim: {n} real -> {len(y)} complex, peak at {f_pk:+.3f} "
      f"(expect {2*fc:+.3f})")

# complex -> real 1:2 interpolator back
qi = firhilb_interp(m, as_db)
z, _ = qi(jnp.asarray(y), batch_shape=())
z = np.asarray(z)
F = np.abs(np.fft.rfft(z))
print(f"c2r interp: {len(y)} complex -> {len(z)} real, peak at "
      f"{np.argmax(F)/len(z):.3f} (expect {fc:.3f})")
