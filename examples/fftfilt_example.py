"""FFT-based block filtering (overlap-save) vs direct FIR
(reference fftfilt_crcf_example.c: asserts the two agree)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.design.firdes import firdes_kaiser
from liquid_dsp_tpu.ops.fftfilt import fftfilt
from liquid_dsp_tpu.ops.fir import firfilt

h = firdes_kaiser(57, 0.2, 60.0).astype(np.float32)
rng = np.random.default_rng(1)
x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)

y_fft, _ = fftfilt(h)(jnp.asarray(x))
y_fir, _ = firfilt(h)(jnp.asarray(x))
rmse = np.sqrt(np.mean(np.abs(np.asarray(y_fft) - np.asarray(y_fir)) ** 2))
print(f"fftfilt vs firfilt rmse: {rmse:.2e} (reference example contends < 1e-3)")
