"""Block-based LMS equalizer training: adapt on a training block, then
freeze the weights and filter the payload (reference
eqlms_cccf_block_example.c — _execute_block batch interface)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.modem import constellation, modulate
from liquid_dsp_tpu.ops.equalize import eqlms, eqlms_run

rng = np.random.default_rng(7)
n_train, n_data = 600, 2000
table = constellation("qpsk")
s = np.asarray(modulate(table, jnp.asarray(
    rng.integers(0, 4, n_train + n_data))))
h = np.array([1.0, 0.12 - 0.2j, -0.22 + 0.18j], np.complex64)  # multipath
x = np.convolve(s, h)[:len(s)].astype(np.complex64)

h_len, mu = 11, 0.3
q = eqlms(h_len, mu=mu)
carry = q.init(batch_shape=())

# block 1: adapt on the training prefix (known symbols)
y_tr, carry = eqlms_run(None, mu, carry, jnp.asarray(x[:n_train]),
                        d=jnp.asarray(s[:n_train].astype(np.complex64)))
w_trained = np.asarray(carry["w"])

# block 2: freeze (mu=0 -> no weight updates) and equalize the payload
s2 = np.float32(np.sqrt(0.5))
slicer = lambda y: jnp.sign(y.real) * s2 + 1j * jnp.sign(y.imag) * s2
y, _ = eqlms_run(None, 0.0, carry, jnp.asarray(x[n_train:]), slicer=slicer)
y = np.asarray(y)
d = s[n_train:]
mse_before = 10 * np.log10(np.mean(np.abs(x[n_train:] - d) ** 2))
mse_after = 10 * np.log10(np.mean(np.abs(y[200:] - d[200:]) ** 2) + 1e-12)
print(f"trained weights (center taps): {np.round(w_trained[4:7], 3)}")
print(f"payload MSE unequalized : {mse_before:6.1f} dB")
print(f"payload MSE equalized   : {mse_after:6.1f} dB (frozen weights)")
