"""Automatic gain control as a lax.scan recurrence.

Reference analog (studied, not copied): agc_crcf/rrrf
(reference src/agc/src/agc.c:37-123): log-domain gain loop — one-pole
smoothing of |y|^2, g *= exp(-alpha/2 * log(y2')), clamp at 1e6,
lock/unlock, rssi accessors (API include/liquid.h:93-160).

The per-sample feedback cannot be parallelized across time without
changing the algorithm (SURVEY.md §7 hard-parts #1), so it runs as a
lax.scan over the block with the (g, y2_prime) carry — batch/channel axes
vectorize freely, which is where the device parallelism lives.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core import Proc, scan_unroll

__all__ = ["agc", "agc_scan", "rssi_from_carry"]

AGC_DEFAULT_BW = 1e-2


def agc_scan(alpha, carry, x, locked: bool = False):
    """Run the AGC recurrence over a block.  carry = {g, y2_prime}.

    The scan body is ALL-REAL: the loop only needs the instantaneous
    power p = |x|^2 (y2 = g^2 p — identical recurrence), so per-sample
    gains come out of a real scalar scan and the complex input is
    scaled elementwise OUTSIDE the scan: the scan step is the whole
    cost, and a complex multiply per step would triple it."""
    p = (x * jnp.conj(x)).real if jnp.iscomplexobj(x) else x * x
    pt = jnp.moveaxis(p, -1, 0)

    def step(c, pp):
        g, y2p = c
        y2p = (1.0 - alpha) * y2p + alpha * (g * g) * pp
        g_out = g
        if not locked:
            g = jnp.where(y2p > 1e-6,
                          g * jnp.exp(-0.5 * alpha * jnp.log(y2p)), g)
            g = jnp.minimum(g, 1e6)
        return (g, y2p), g_out

    (g, y2p), gt = lax.scan(step, (carry["g"], carry["y2_prime"]), pt,
                            unroll=scan_unroll(16))
    s = jnp.moveaxis(gt, 0, -1)
    from .. import debug
    debug.tap("agc.gain", g)          # converged gain per block
    return x * s.astype(x.dtype), {"g": g, "y2_prime": y2p}


def agc(bandwidth: float = AGC_DEFAULT_BW, locked: bool = False,
        name: str = "agc") -> Proc:
    """Streaming AGC Proc.  Output: gain-normalized signal (unit energy).

    carry: {g: gain, y2_prime: smoothed output energy} — the analog of the
    reference struct fields (agc.c:37-51).
    """
    if bandwidth < 0:
        raise ValueError("agc bandwidth must be positive")
    alpha = float(bandwidth)

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"g": jnp.ones(batch_shape, jnp.float32),
                "y2_prime": jnp.ones(batch_shape, jnp.float32)}

    def apply(params, carry, x):
        return agc_scan(alpha, carry, x, locked=locked)

    def planar_init(batch_shape=(), dtype=jnp.float32):
        return init(batch_shape=batch_shape)

    def planar_apply(params, carry, x):
        # planar form (planar.py): the loop only needs the instantaneous
        # POWER p = r^2 + i^2 (y2 = g^2 p — identical recurrence), so the
        # scan body is all-real scalar math emitting per-sample gains,
        # and the planes are scaled elementwise outside the scan.
        r, i = x
        p = jnp.moveaxis(r * r + i * i, -1, 0)

        def step(c, pt):
            g, y2p = c
            y2p = (1.0 - alpha) * y2p + alpha * (g * g) * pt
            g_out = g
            if not locked:
                g = jnp.where(y2p > 1e-6,
                              g * jnp.exp(-0.5 * alpha * jnp.log(y2p)), g)
                g = jnp.minimum(g, 1e6)
            return (g, y2p), g_out

        (g, y2p), gt = lax.scan(step, (carry["g"], carry["y2_prime"]), p,
                                unroll=scan_unroll(16))
        s = jnp.moveaxis(gt, 0, -1)
        return (r * s, i * s), {"g": g, "y2_prime": y2p}

    return Proc(params={}, init=init, apply=apply, name=name,
                planar_apply=planar_apply, planar_init=planar_init)


def rssi_from_carry(carry):
    """Received signal strength [dB] (reference agc_crcf_get_rssi):
    rssi = -20 log10(g)."""
    return -20.0 * jnp.log10(jnp.maximum(carry["g"], 1e-16))
