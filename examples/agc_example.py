"""Automatic gain control convergence on a weak tone
(reference agc_crcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.agc import agc

n = 2000
t = np.arange(n)
x = (0.01 * np.exp(2j * np.pi * 0.05 * t)).astype(np.complex64)  # -40 dBFS
q = agc(bandwidth=0.01)
y, carry = q(jnp.asarray(x), batch_shape=())
y = np.asarray(y)
print(f"input rms  : {20*np.log10(np.sqrt(np.mean(np.abs(x)**2))):.1f} dB")
print(f"output rms (last 25%): "
      f"{20*np.log10(np.sqrt(np.mean(np.abs(y[-n//4:])**2))):.1f} dB "
      f"(target 0 dB)")
