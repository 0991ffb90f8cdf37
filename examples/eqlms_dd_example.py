"""Decision-directed LMS equalization after a short training burst
(reference eqlms_cccf_decisiondirected_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.equalize import eqlms
from liquid_dsp_tpu.modem.linear import constellation, modulate, demodulate

rng = np.random.default_rng(6)
table = constellation("qpsk")
n_train, n_data = 400, 4000
syms = rng.integers(0, 4, n_train + n_data)
s = np.asarray(modulate(table, jnp.asarray(syms)))

# static 3-tap ISI channel + light noise
h_chan = np.array([1.0, 0.35 - 0.2j, -0.12 + 0.05j], np.complex64)
x = np.convolve(s, h_chan)[: len(s)].astype(np.complex64)
x += (0.01 * (rng.standard_normal(x.shape)
              + 1j * rng.standard_normal(x.shape))).astype(np.complex64)

h_len = 13

# phase 1: trained on the known preamble (tuple input = trained mode)
q_train = eqlms(h_len, mu=0.2)
y1, c = q_train((jnp.asarray(x[:n_train]),
                 jnp.asarray(s[:n_train].astype(np.complex64))),
                batch_shape=())

# phase 2: decision-directed on the unknown payload — same carry, a
# gentler step size, and the default unit-energy QPSK slicer
q_dd = eqlms(h_len, mu=0.05)
y2, _ = q_dd(jnp.asarray(x[n_train:]), carry=c)
y2 = np.asarray(y2)

got = np.asarray(demodulate(jnp.asarray(table), jnp.asarray(y2)))
want = syms[n_train:]
ser = float(np.mean(got[200:] != want[200:]))
evm = float(np.sqrt(np.mean(np.abs(
    y2[200:] - s[n_train + 200:]) ** 2)))
print(f"3-tap ISI channel, {h_len}-tap LMS: trained {n_train} syms then "
      f"decision-directed")
print(f"payload SER {ser:.4f}, EVM {20 * np.log10(evm + 1e-12):.1f} dB")
assert ser < 0.01
