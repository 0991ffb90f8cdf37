"""Automatic gain control of a real-valued signal
(reference agc_rrrf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.agc import agc, rssi_from_carry

n = 2000
t = np.arange(n)
# weak real sinusoid: -30 dBFS
x = (0.0316 * np.cos(2 * np.pi * 0.043 * t)).astype(np.float32)
q = agc(bandwidth=0.01)
y, carry = q(jnp.asarray(x), batch_shape=())
y = np.asarray(y)
rms_in = np.sqrt(np.mean(x ** 2))
rms_out = np.sqrt(np.mean(y[-n // 4:] ** 2))
print(f"input rms            : {20 * np.log10(rms_in):6.1f} dB")
print(f"output rms (settled) : {20 * np.log10(rms_out):6.1f} dB "
      f"(target 0 dB: unit output energy)")
print(f"rssi estimate        : {float(rssi_from_carry(carry)):6.1f} dB")
