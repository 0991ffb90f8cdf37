"""Analog AM (DSB + SSB) and FM round trips
(reference ampmodem_example.c / freqmod_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.modem.analog import (amp_modulator, amp_demodulator,
                                         freq_modulator, freq_demodulator)

n = 4096
t = np.arange(n)
msg = (0.5 * np.sin(2 * np.pi * 0.0037 * t)).astype(np.float32)

for kind in ("dsb", "usb", "lsb"):
    mod = amp_modulator(0.8, kind=kind)
    dem = amp_demodulator(0.8, kind=kind)
    x, _ = mod(jnp.asarray(msg), batch_shape=())
    m_hat, _ = dem(jnp.asarray(np.asarray(x)), batch_shape=())
    m_hat = np.asarray(m_hat)
    # align for the Hilbert filters' group delay before comparing
    lags = [(np.mean((m_hat[200 + d: 3000 + d] - msg[200:3000]) ** 2), d)
            for d in range(0, 40)]
    err2, d = min(lags)
    print(f"AM {kind}: rms demod error {np.sqrt(err2):.4f} "
          f"(delay {d} samples)")

fm = freq_modulator(0.1)
fd = freq_demodulator(0.1)
x, _ = fm(jnp.asarray(msg), batch_shape=())
m_hat, _ = fd(jnp.asarray(np.asarray(x)), batch_shape=())
m_hat = np.asarray(m_hat)
err = np.sqrt(np.mean((m_hat[10:] - msg[10:]) ** 2))
print(f"FM: rms demod error {err:.4f}")
