"""Linear prediction fits an all-pole model to a filtered process
(reference lpc_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.iir import iirfilt
from liquid_dsp_tpu.ops.misc_filters import lpc

rng = np.random.default_rng(11)
# AR(4) process: white noise through an all-pole filter
a_true = np.array([1.0, -1.3, 0.9, -0.3, 0.1], np.float32)
q = iirfilt(np.array([1.0], np.float32), a_true)
w = rng.standard_normal(8000).astype(np.float32)
x, _ = q(jnp.asarray(w), batch_shape=(), dtype=jnp.float32)
x = np.asarray(x)

a_hat, e = lpc(x[200:], 4)
print("true  a:", np.round(a_true, 3))
print("lpc   a:", np.round(a_hat, 3))
print("prediction error variance by order:",
      np.round(e / e[0], 3), "(monotone decreasing)")
assert np.abs(a_hat - a_true).max() < 0.05
