"""Arbitrary/optimized constellations: arb16opt, arb64vt, V.29, SQAM
(reference modem_arb_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.modem.linear import (constellation, modulate,
                                         demodulate, bits_per_symbol)
from liquid_dsp_tpu.utils.random import jax_crandn
import jax

for scheme in ("v29", "arb16opt", "arb32opt", "arb64vt", "sqam32"):
    table = constellation(scheme)
    bps = bits_per_symbol(scheme)
    M = 1 << bps
    # unit average energy by construction (reference modem_arb.c:205-210)
    e = float(np.mean(np.abs(np.asarray(table)) ** 2))
    rng = np.random.default_rng(5)
    syms = rng.integers(0, M, 4000)
    x = modulate(table, jnp.asarray(syms))
    # light AWGN: nearest-point demod must round-trip
    noise = 0.02 * jax_crandn(jax.random.PRNGKey(0), x.shape)
    s_hat = np.asarray(demodulate(table, x + noise))
    ser = float(np.mean(s_hat != syms))
    print(f"{scheme:9s} M={M:3d}  avg energy {e:.4f}  SER @ 34dB = {ser:.4f}")
    assert abs(e - 1.0) < 1e-3 and ser < 0.01
