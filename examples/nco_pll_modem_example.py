"""Carrier recovery on modulated data: PLL tracks phase/frequency offset
on a QPSK stream using the decision-directed phase error
(reference nco_pll_modem_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from jax import lax
from liquid_dsp_tpu.modem import constellation, modulate, demodulate
from liquid_dsp_tpu.ops.nco import pll_step

rng = np.random.default_rng(5)
n = 4000
table_np = np.asarray(constellation("qpsk"))
syms = rng.integers(0, 4, n)
s = np.asarray(modulate(jnp.asarray(table_np), jnp.asarray(syms)))

dphi_true, phi_true = 0.021, 0.8     # unknown carrier offset
x = (s * np.exp(1j * (dphi_true * np.arange(n) + phi_true))
     ).astype(np.complex64)
table = jnp.asarray(table_np)


def step(c, xi):
    theta, dtheta = c
    v = xi * jnp.exp(-1j * theta)
    # decision-directed error: phase of v relative to nearest QPSK point
    sym = jnp.argmin(jnp.abs(v - table))
    err = jnp.angle(v * jnp.conj(table[sym]))
    theta, dtheta = pll_step(theta, dtheta, err, bandwidth=0.02)
    return (theta + dtheta, dtheta), v


(_, dtheta), y = lax.scan(
    step, (jnp.float32(0), jnp.float32(0)), jnp.asarray(x))
y = np.asarray(y)
dec = np.asarray(demodulate(jnp.asarray(table_np), jnp.asarray(y)))
# QPSK phase ambiguity: the DD loop can lock 90 deg rotated; compare
# against the symbol indices each fixed rotation would produce
errs = 4 * n
for r in range(4):
    rot = table_np[syms[-2000:]] * np.exp(1j * r * np.pi / 2)
    expect = np.argmin(np.abs(rot[:, None] - table_np[None, :]), axis=1)
    errs = min(errs, int(np.sum(dec[-2000:] != expect)))
evm = 10 * np.log10(np.mean(np.abs(np.abs(y[-500:]) - 1.0) ** 2) + 1e-12)
print(f"true carrier offset : {dphi_true:+.4f} rad/sample")
print(f"PLL estimate        : {float(dtheta):+.4f} rad/sample")
print(f"symbol errors (last 2000, best rotation): {errs}")
