"""AGC in front of a QPSK demodulator: recovers the level, preserves
the constellation (reference agc_crcf_qpsk_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.agc import agc, rssi_from_carry
from liquid_dsp_tpu.modem import constellation, modulate, demodulate

rng = np.random.default_rng(22)
n = 4000
table = constellation("qpsk")
s = rng.integers(0, 4, n)
x = np.asarray(modulate(table, jnp.asarray(s)))

for gain_db in (-30.0, -10.0, +10.0):
    g = 10 ** (gain_db / 20)
    rx = (g * x + 0.001 * (rng.standard_normal(n) +
                           1j * rng.standard_normal(n))).astype(np.complex64)
    q = agc(bandwidth=0.02)
    y, c = q(jnp.asarray(rx), batch_shape=())
    s_hat = np.asarray(demodulate(table, y))
    ser = np.mean(s_hat[500:] != s[500:])        # after AGC settling
    print(f"input {gain_db:+5.1f} dB: rssi estimate "
          f"{float(rssi_from_carry(c)):+6.1f} dB, "
          f"post-AGC SER {ser:.4f}")
    assert ser < 1e-3
