"""First-order IIR DC blocker removes a bias without touching the signal
(reference iirfilt_crcf_dcblocker_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.iir import iirfilt

alpha = 0.05                     # blocker bandwidth
b = np.array([1.0, -1.0], np.float32) * (1 - alpha / 2)
a = np.array([1.0, -(1 - alpha)], np.float32)
q = iirfilt(b, a)

rng = np.random.default_rng(12)
n = 4000
tone = np.exp(1j * 0.3 * np.arange(n))
x = (tone + (0.5 + 0.25j)).astype(np.complex64)   # strong DC offset
y, _ = q(jnp.asarray(x), batch_shape=())
y = np.asarray(y)[1000:]
print(f"input : DC {np.abs(np.mean(x)):.3f}, tone power "
      f"{np.mean(np.abs(x - np.mean(x)) ** 2):.3f}")
print(f"output: DC {np.abs(np.mean(y)):.4f}, tone power "
      f"{np.mean(np.abs(y - np.mean(y)) ** 2):.3f}")
assert np.abs(np.mean(y)) < 0.02
