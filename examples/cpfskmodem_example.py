"""CPFSK round trips over the four pulse shapes
(reference cpfskmodem_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.modem.cpm import cpfsk_modulator, cpfsk_demodulator

rng = np.random.default_rng(4)
bps, h, k, m = 1, 0.5, 4, 3
syms = rng.integers(0, 2 ** bps, 200)
for kind in ("square", "rcos-full", "rcos-half", "gmsk"):
    mod = cpfsk_modulator(bps, h, k, m, kind)
    dem = cpfsk_demodulator(bps, h, k, m, kind)
    x, _ = mod(jnp.asarray(syms.astype(np.int32)), batch_shape=())
    s_hat, _ = dem(x, batch_shape=())
    s_hat = np.asarray(s_hat)
    # align for filter delay and compare the steady-state middle
    best = min(range(0, 8), key=lambda d: np.mean(
        s_hat[d + 20:d + 150] != syms[20:150]))
    err = int(np.sum(s_hat[best + 20:best + 150] != syms[20:150]))
    print(f"pulse={kind:10s}: delay {best} symbols, {err} errors")
    assert err == 0
