"""Complex-coefficient FIR: a Kaiser lowpass heterodyned to +0.2
cycles/sample becomes a single-sideband bandpass that keeps one tone of
a two-tone input and drops the other (reference firfilt_cccf_example.c;
the complex-tap planar path runs as a 3-convolution Karatsuba split,
ops/fir.py)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.design.firdes import firdes_kaiser
from liquid_dsp_tpu.ops.fir import firfilt

n, f_keep, f_drop = 4096, 0.20, -0.31        # cycles... rad/2pi units
t = np.arange(n)
x = (np.exp(2j * np.pi * f_keep * t) +
     np.exp(2j * np.pi * f_drop * t)).astype(np.complex64)

h0 = firdes_kaiser(91, 0.05, 70.0)
h0 = h0 / h0.sum()
h = (h0 * np.exp(2j * np.pi * f_keep * np.arange(len(h0)))
     ).astype(np.complex64)                  # heterodyne to +f_keep

q = firfilt(h)
y, _ = q(jnp.asarray(x), batch_shape=())
y = np.asarray(y)[200:]

Y = np.abs(np.fft.fft(y))
f = np.fft.fftfreq(len(y))
p_keep = Y[np.argmin(np.abs(f - f_keep))]
p_drop = Y[np.argmin(np.abs(f - f_drop))]
print(f"complex bandpass at {f_keep:+.2f}: "
      f"kept tone {20*np.log10(p_keep):6.1f} dB, "
      f"rejected tone {20*np.log10(p_drop):6.1f} dB "
      f"({20*np.log10(p_keep/p_drop):.1f} dB selectivity)")
assert p_keep / p_drop > 300
