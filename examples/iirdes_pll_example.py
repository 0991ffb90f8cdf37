"""PLL loop-filter design: active-lag and active-PI second-order loop
filters, then lock a carrier with each (reference iirdes_pll_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from jax import lax
from liquid_dsp_tpu.design.iirdes import (
    iirdes_pll_active_lag, iirdes_pll_active_pi)
from liquid_dsp_tpu.ops.iir import iirfilt

w, zeta, K = 0.05, 0.707, 1000.0   # loop bandwidth, damping, loop gain
for name, design in [("active lag", iirdes_pll_active_lag),
                     ("active PI ", iirdes_pll_active_pi)]:
    b, a = design(w, zeta, K)
    print(f"{name}: b = {np.round(b, 5)}  a = {np.round(a, 5)}")

# drive a phase-locked loop with the active-lag filter
b, a = iirdes_pll_active_lag(w, zeta, K)
dphi_true, n = 0.02, 800
x = np.exp(1j * dphi_true * np.arange(n)).astype(np.complex64)
loop = iirfilt(b, a)
lf_carry = loop.init(batch_shape=(), dtype=jnp.float32)


def step(c, xi):
    theta, lf = c
    err = jnp.angle(xi * jnp.exp(-1j * theta))
    # the loop filter's output IS the new NCO phase (it integrates
    # internally: double pole at z=1), matching the reference loop
    theta, lf = loop.apply(loop.params, lf, err[None])
    return (theta[0], lf), err


(_, _), errs = lax.scan(step, (jnp.float32(0.0), lf_carry), jnp.asarray(x))
errs = np.asarray(errs)
print(f"carrier offset {dphi_true} rad/sample: "
      f"|phase error| settles to {np.abs(errs[-100:]).mean():.2e} rad "
      f"(first 50 samples: {np.abs(errs[:50]).mean():.2f} rad)")
