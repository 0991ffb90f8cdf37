"""LMS equalization of a multipath channel, trained then decision-directed
(reference eqlms_cccf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.modem import constellation, modulate
from liquid_dsp_tpu.ops.equalize import eqlms

rng = np.random.default_rng(0)
n = 3000
table = constellation("qpsk")
s = np.asarray(modulate(table, jnp.asarray(rng.integers(0, 4, n))))
# 3-tap multipath channel
h = np.array([1.0, 0.0, -0.25 + 0.2j], np.complex64)
x = np.convolve(s, h)[:n].astype(np.complex64)
before = 10 * np.log10(np.mean(np.abs(x - s) ** 2))
q = eqlms(13, mu=0.2)
y, _ = q((jnp.asarray(x), jnp.asarray(s.astype(np.complex64))),
         batch_shape=())
y = np.asarray(y)
# compare tail (post-convergence) with the channel delay removed
err = 10 * np.log10(np.mean(np.abs(y[-1000:] - s[-1000:]) ** 2) + 1e-12)
print(f"MSE before equalization: {before:6.1f} dB")
print(f"MSE after  equalization: {err:6.1f} dB")
