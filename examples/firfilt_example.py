"""Kaiser lowpass FIR filtering (reference firfilt_crcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.design.firdes import firdes_kaiser
from liquid_dsp_tpu.ops.fir import firfilt

h = firdes_kaiser(64, 0.15, 60.0)
h = h / h.sum()
q = firfilt(h)
t = np.arange(4096)
x = (np.exp(2j * np.pi * 0.05 * t) +
     np.exp(2j * np.pi * 0.35 * t)).astype(np.complex64)
y, _ = q(jnp.asarray(x), batch_shape=())
Y = np.fft.fftshift(np.fft.fft(np.asarray(y)[200:]))
f = np.linspace(-0.5, 0.5, len(Y))
peak = f[np.argmax(np.abs(Y))]
print(f"designed {len(h)}-tap Kaiser lowpass fc=0.15")
print(f"in-band tone (0.05) kept: peak at f={peak:+.3f}")
rej = 20 * np.log10(np.abs(Y)[np.abs(f - 0.35) < 0.01].max() /
                    np.abs(Y).max())
print(f"out-of-band tone (0.35) rejected by {rej:.1f} dB")
