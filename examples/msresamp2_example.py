"""Dyadic multi-stage halfband resampler on a chirp
(reference msresamp2_crcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.resample import msresamp2

stages, n = 3, 4096                      # 8x up then 8x back down
t = np.arange(n)
f0, f1 = 0.0, 0.05
phase = 2 * np.pi * (f0 * t + 0.5 * (f1 - f0) * t ** 2 / n)
x = np.exp(1j * phase).astype(np.complex64)

qi = msresamp2("interp", stages, fc=0.4, as_db=80.0)
qd = msresamp2("decim", stages, fc=0.4, as_db=80.0)
u, _ = qi(jnp.asarray(x), batch_shape=())
assert u.shape[-1] == n * (1 << stages)
y, _ = qd(u, batch_shape=())
y = np.asarray(y)
assert y.shape[-1] == n

# the cascade delay is fractional at the output rate (each halfband
# stage contributes its semi-length at a different rate): estimate it
# from the cross-spectrum phase slope over the occupied band, undo it
# with a frequency-domain shift, then compare
X, Y = np.fft.fft(x), np.fft.fft(y)
f = np.fft.fftfreq(n)
band = (f > 0.002) & (f < 0.045)          # chirp's occupied band
ph = np.unwrap(np.angle(Y[band] * np.conj(X[band])))
d = -np.polyfit(f[band], ph, 1)[0] / (2 * np.pi)
y_al = np.fft.ifft(Y * np.exp(2j * np.pi * f * d))
err = np.abs(y_al[256:-256] - x[256:-256])
print(f"{1 << stages}x interp -> {1 << stages}x decim of a chirp:")
print(f"  cascade delay {d:.2f} samples, rms error "
      f"{np.sqrt(np.mean(err ** 2)):.2e}, max {err.max():.2e}")
assert np.sqrt(np.mean(err ** 2)) < 2e-3
