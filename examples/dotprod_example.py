"""Kernel-layer primitives: dot products, windowed sums, vector math
(reference dotprod_rrrf_example.c / dotprod_cccf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.dotprod import dotprod, sumsq, conv1d

rng = np.random.default_rng(4)
h = rng.standard_normal(16).astype(np.float32)
x = rng.standard_normal(16).astype(np.float32)
print(f"dotprod_rrrf: {float(dotprod(jnp.asarray(h), jnp.asarray(x))):+.5f} "
      f"(numpy {np.dot(h, x):+.5f})")

hc = (rng.standard_normal(16) + 1j * rng.standard_normal(16)
      ).astype(np.complex64)
xc = (rng.standard_normal(16) + 1j * rng.standard_normal(16)
      ).astype(np.complex64)
d = complex(np.asarray(dotprod(jnp.asarray(hc), jnp.asarray(xc))))
print(f"dotprod_cccf: {d:+.5f} (numpy {np.sum(hc * xc):+.5f})")
assert abs(d - np.sum(hc * xc)) < 1e-3

e = float(sumsq(jnp.asarray(xc)))
print(f"sumsq: {e:.5f} (numpy {float(np.sum(np.abs(xc) ** 2)):.5f})")

# the streaming form of a dot product is convolution — the same
# primitive the FIR layer lowers to a banded matmul
# (valid mode: y[t] = sum_j h[j] x[t+L-1-j])
y = np.asarray(conv1d(jnp.asarray(xc), jnp.asarray(hc)))
ref = np.convolve(xc, hc)[len(hc) - 1: len(xc)]
print(f"conv1d vs np.convolve (valid) max err: {np.abs(y - ref).max():.2e}")
assert np.abs(y - ref).max() < 1e-4
