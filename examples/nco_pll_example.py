"""NCO mixing and PLL carrier recovery of a frequency-offset tone
(reference nco_pll_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from jax import lax
from liquid_dsp_tpu.ops.nco import pll_step

n = 1200
dphi_true = 0.0307           # unknown carrier offset, rad/sample
phi_true = 1.1
t = np.arange(n)
x = np.exp(1j * (dphi_true * t + phi_true)).astype(np.complex64)


def step(c, xi):
    theta, dtheta = c
    v = xi * jnp.exp(-1j * theta)
    err = jnp.angle(v)
    theta, dtheta = pll_step(theta, dtheta, err, bandwidth=0.05)
    theta = theta + dtheta          # NCO step (reference nco_crcf_step)
    return (theta, dtheta), dtheta


(_, dtheta), hist = lax.scan(step, (jnp.float32(0), jnp.float32(0)),
                             jnp.asarray(x))
print(f"true carrier offset      : {dphi_true:+.4f} rad/sample")
print(f"PLL estimate (converged) : {float(dtheta):+.4f} rad/sample")
lock = int(np.argmax(np.abs(np.asarray(hist) - dphi_true) < 1e-3))
print(f"locked after ~{lock} samples")
