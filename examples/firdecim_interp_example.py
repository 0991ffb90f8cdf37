"""Polyphase M:1 decimation and 1:M interpolation
(reference firdecim_crcf_example.c / firinterp_crcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.design.firdes import firdes_kaiser
from liquid_dsp_tpu.ops.fir import firdecim, firinterp

M = 4
h = firdes_kaiser(8 * M + 1, 0.5 / M, 60.0).astype(np.float32)
n = 1024
t = np.arange(n)
x = np.exp(2j * np.pi * 0.02 * t).astype(np.complex64)

y_up, _ = firinterp(M, (M * h / h.sum()).astype(np.float32))(jnp.asarray(x))
y_dn, _ = firdecim(M, h)(jnp.asarray(np.asarray(y_up)))
print(f"interp 1:{M}: {n} -> {np.asarray(y_up).shape[-1]} samples")
print(f"decim {M}:1 : {np.asarray(y_up).shape[-1]} -> {np.asarray(y_dn).shape[-1]} samples")
# tone survives the round trip at the original frequency
Y = np.fft.fft(np.asarray(y_dn)[64:])
f_peak = np.fft.fftfreq(len(Y))[np.argmax(np.abs(Y))]
print(f"recovered tone frequency: {f_peak:.4f} cycles/sample (expected 0.02)")
