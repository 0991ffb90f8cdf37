"""RLS vs LMS equalizer convergence on a multipath channel
(reference eqrls_cccf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.equalize import eqlms, eqrls

rng = np.random.default_rng(5)
n, L = 600, 9
s2 = np.sqrt(0.5)
d = ((rng.integers(0, 2, n) * 2 - 1) * s2 +
     1j * (rng.integers(0, 2, n) * 2 - 1) * s2).astype(np.complex64)
h = np.array([1.0, 0.0, -0.25 + 0.2j, 0.0, 0.1], np.complex64)
x = np.convolve(d, h)[:n].astype(np.complex64)
delay = 0  # channel is causal with main tap first

for name, q in (("lms", eqlms(h_len=L, mu=0.2)),
                ("rls", eqrls(h_len=L, lam=0.99))):
    y, _ = q((jnp.asarray(x), jnp.asarray(d)), batch_shape=())
    err = np.abs(np.asarray(y) - d) ** 2
    mse_head = 10 * np.log10(np.mean(err[:100]) + 1e-12)
    mse_tail = 10 * np.log10(np.mean(err[-100:]) + 1e-12)
    print(f"{name}: MSE first 100 syms {mse_head:6.1f} dB -> "
          f"last 100 syms {mse_tail:6.1f} dB")
