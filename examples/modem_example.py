"""Linear modem sweep: modulate/demodulate round trip + EVM under noise
(reference modem_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.modem import (constellation, bits_per_symbol,
                                  modulate, demodulate)

rng = np.random.default_rng(0)
n = 4096
for ms in ("bpsk", "qpsk", "psk8", "qam16", "qam64", "apsk32", "V29"):
    table = constellation(ms)
    s = rng.integers(0, len(table), n)
    x = np.asarray(modulate(table, jnp.asarray(s)))
    x_noisy = x + 0.03 * (rng.standard_normal(n) +
                          1j * rng.standard_normal(n))
    s_hat = np.asarray(demodulate(table, jnp.asarray(
        x_noisy.astype(np.complex64))))
    ser = np.mean(s_hat != s)
    evm = 10 * np.log10(np.mean(np.abs(x_noisy - x) ** 2))
    print(f"{ms:7s} {bits_per_symbol(ms)} bits/sym  "
          f"EVM {evm:5.1f} dB  SER {ser:.4f}")
