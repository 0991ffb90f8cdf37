"""M-ary FSK modulation and FFT-peak demodulation with noise
(reference fskmodem_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.modem.cpm import fsk_modulator, fsk_demodulator

rng = np.random.default_rng(0)
m, k = 3, 64                 # 8-FSK, 64 samples/symbol
n_sym = 500
s = rng.integers(0, 1 << m, n_sym)
mod = fsk_modulator(m, k, bandwidth=0.25)
x, _ = mod(jnp.asarray(s), batch_shape=())
x = np.asarray(x)
x = x + 0.1 * (rng.standard_normal(x.shape) +
               1j * rng.standard_normal(x.shape))
dem = fsk_demodulator(m, k, bandwidth=0.25)
s_hat, _ = dem(jnp.asarray(x.astype(np.complex64)), batch_shape=())
s_hat = np.asarray(s_hat)
print(f"8-FSK, {n_sym} symbols, 14 dB SNR: "
      f"SER = {np.mean(s_hat != s):.4f}")
