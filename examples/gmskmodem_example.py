"""GMSK modulation round trip at several bandwidth-time products
(reference gmskmodem_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.modem.cpm import gmsk_modulator, gmsk_demodulator

rng = np.random.default_rng(3)
bits = rng.integers(0, 2, 400).astype(np.uint8)
k, m = 2, 3
for bt in (0.3, 0.5):
    mod = gmsk_modulator(k=k, m=m, bt=bt)
    dem = gmsk_demodulator(k=k, m=m, bt=bt)
    x, _ = mod(jnp.asarray(bits.astype(np.float32)), batch_shape=())
    rx, _ = dem(x, batch_shape=())
    rxb = np.asarray(rx) > 0
    # demod has 2m symbols of filter delay
    d = 2 * m
    err = np.sum(rxb[d:len(bits)] != bits[: len(bits) - d])
    print(f"BT={bt}: {len(bits)} bits, {err} errors after delay compensation")
    assert err == 0
