"""Blind decision-directed LMS equalization — no training sequence
(reference eqlms_cccf_blind_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.equalize import eqlms

rng = np.random.default_rng(6)
n = 2000
s2 = np.sqrt(0.5)
d = ((rng.integers(0, 2, n) * 2 - 1) * s2 +
     1j * (rng.integers(0, 2, n) * 2 - 1) * s2).astype(np.complex64)
h = np.array([1.0, 0.12 - 0.09j, -0.08 + 0.05j], np.complex64)
x = np.convolve(d, h)[:n].astype(np.complex64)

# decision point at the NEWEST window slot: the channel is causal, so
# its inverse needs taps on PAST samples relative to the decided symbol
w0 = np.zeros(7, np.complex64)
w0[-1] = 1.0
q = eqlms(h_len=7, mu=0.05, h=w0)  # plain array input -> QPSK sign slicer
y, _ = q(jnp.asarray(x), batch_shape=())
y = np.asarray(y)
evm = lambda seg: 20 * np.log10(np.sqrt(np.mean(np.abs(  # noqa: E731
    seg - (np.sign(seg.real) + 1j * np.sign(seg.imag)) * s2) ** 2)))
print(f"EVM before equalizer   : {evm(x[100:]):6.1f} dB")
print(f"EVM first 200 symbols  : {evm(y[:200]):6.1f} dB")
print(f"EVM last  200 symbols  : {evm(y[-200:]):6.1f} dB (blind converged)")
assert evm(y[-200:]) < evm(x[100:]) - 3
