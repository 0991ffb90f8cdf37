"""Complex-coefficient IIR filtering: a one-pole complex resonator at
+w0 passes the positive-frequency tone and rejects its negative-
frequency image — something no real-coefficient filter can do
(reference iirfilt_cccf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.iir import iirfilt

r, w0, n = 0.95, 0.35, 4096
t = np.arange(n)
# real input = positive- plus negative-frequency components
x = np.cos(w0 * t).astype(np.complex64)

b = np.array([1 - r], np.complex64)
a = np.array([1.0, -r * np.exp(1j * w0)], np.complex64)
q = iirfilt(b, a)
y, _ = q(jnp.asarray(x), batch_shape=())
y = np.asarray(y)[500:]                      # past the transient

Y = np.fft.fft(y)
f = np.fft.fftfreq(len(y), 1 / (2 * np.pi))
p_pos = np.abs(Y[np.argmin(np.abs(f - w0))])
p_neg = np.abs(Y[np.argmin(np.abs(f + w0))])
print(f"complex one-pole resonator at w0={w0}, r={r}")
print(f"  +w0 component: {20*np.log10(p_pos):6.1f} dB")
print(f"  -w0 image    : {20*np.log10(p_neg):6.1f} dB "
      f"({20*np.log10(p_pos/p_neg):.1f} dB image rejection)")
assert p_pos / p_neg > 10
