"""Numerically-controlled oscillator: block mixing with explicit phase carry.

Reference analog: src/nco/src/nco.c — per-sample phase accumulator with a
256-entry sine table (LIQUID_NCO) or direct sinf/cosf (LIQUID_VCO), stepped
one sample at a time (nco.c:134), mixed via nco_crcf_mix_down (nco.c:255).

Design: the phase recurrence theta[t] = theta0 + t*dphi is affine in the
sample index, so a whole block's oscillator is one closed-form vector
exp(j(theta0 + t*dphi)) — no sequential dependency, and the carry advance
across a time-sharded block is likewise closed-form (carry_advance), which
is what lets the mixer shard across devices with no communication at all.

The in-block phase t*dphi is computed the way the reference keeps its
accumulator: as an integer phase step of 2^-32 turns (nco.c's uint32
theta), multiplied by the sample index in wrapping int32 arithmetic and
only then scaled to radians.  The float32 form theta0 + t*dphi loses
~1e-3 rad by t = 2^18 (its magnitude reaches 3e4 rad); the integer form
stays within ~2e-7 rad at any t.  The carry theta is wrapped to
[-pi, pi) every block.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..core import Proc

__all__ = ["nco", "mix_up", "mix_down", "nco_block_phases", "pll_step",
           "phase_step", "step_phase",
           "unwrap_phase", "unwrap_phase2"]

TWO_PI = 2.0 * jnp.pi
# radians per unit of the int32 phase step (2^-32 turns)
RAD_PER_STEP = float(2.0 * np.pi / 2.0 ** 32)


def _wrap(theta):
    return jnp.mod(theta + jnp.pi, TWO_PI) - jnp.pi


def phase_step(dphi: float) -> int:
    """dphi (rad/sample) as a signed int32 phase step of 2^-32 turns,
    rounded on the host in float64."""
    u = int(np.round(float(dphi) / (2.0 * np.pi) * 2.0 ** 32)) % (1 << 32)
    return u - (1 << 32) if u >= (1 << 31) else u


def step_phase(n, step):
    """Radians in [-pi, pi) of n samples at int32 `step`: n*step wraps
    mod 2^32 in int32 arithmetic (exact), then scales to radians."""
    k = jnp.asarray(n, jnp.int32) * jnp.asarray(step, jnp.int32)
    return k.astype(jnp.float32) * np.float32(RAD_PER_STEP)


def nco_block_phases(theta0, step, T: int):
    """Phases for one block: theta0 + [0..T)*dphi (wrapped), plus the
    next theta0; `step` is the int32 phase step (phase_step)."""
    ph = step_phase(jnp.arange(T, dtype=jnp.int32), step)
    if jnp.ndim(theta0):
        ph = theta0[..., None] + ph
    else:
        ph = theta0 + ph
    theta_next = _wrap(theta0 + step_phase(T, step))
    return _wrap(ph), theta_next


def nco(dphi: float, theta0: float = 0.0, direction: str = "down",
        table: bool = False, name: str = "nco") -> Proc:
    """Block mixer proc: y = x * exp(-+j theta[t]) ('down' negates).

    carry: {'theta': scalar phase (per batch element)}.
    table=True reproduces the reference's LIQUID_NCO 256-entry sine
    table exactly (index = theta*256/(2 pi) + 512.5 masked to 8 bits,
    cos from index+64; reference nco.c compute_sincos_nco) — a gather
    instead of two transcendentals, and bit-matched to reference chains
    built on the default nco type.  table=False is the LIQUID_VCO
    (exact sincos) behavior.
    """
    sgn = -1.0 if direction == "down" else 1.0
    step = phase_step(dphi)
    sintab = np.sin(2.0 * np.pi * np.arange(256) / 256.0
                    ).astype(np.float32)

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"theta": jnp.full(batch_shape, theta0, dtype=jnp.float32)}

    def apply(params, carry, x):
        T = x.shape[-1]
        ph, theta_next = nco_block_phases(carry["theta"], params["step"], T)
        if table:
            phw = jnp.mod(ph + np.pi, 2 * np.pi) - np.pi
            idx = (phw * np.float32(40.743665) + 512.5
                   ).astype(jnp.int32) & 0xFF
            tab = params["sintab"]
            osc = lax.complex(tab[(idx + 64) & 0xFF], tab[idx])
        else:
            osc = lax.complex(jnp.cos(ph), jnp.sin(ph))
        if sgn < 0:
            osc = jnp.conj(osc)
        return x * osc, {"theta": theta_next}

    def advance(params, carry, n):
        """Closed-form carry after consuming n samples (time-shard support)."""
        return {"theta": _wrap(carry["theta"] + step_phase(n, params["step"]))}

    def planar_apply(params, carry, x):
        # plane-native mix (planar.py): 4 mult + 2 add on contiguous
        # float planes; 'down' folds into negating the sine
        r, i = x
        T = r.shape[-1]
        theta = carry["theta"]
        if table:
            ph, theta_next = nco_block_phases(theta, params["step"], T)
            phw = jnp.mod(ph + np.pi, 2 * np.pi) - np.pi
            idx = (phw * np.float32(40.743665) + 512.5
                   ).astype(jnp.int32) & 0xFF
            tab = params["sintab"]
            c_, s_ = tab[(idx + 64) & 0xFF], tab[idx]
        else:
            # angle addition: cos/sin of the [T] time ramp and the
            # [batch] phase offsets separately, combined with 4 mults —
            # T + B transcendentals instead of T*B
            phit = step_phase(jnp.arange(T, dtype=jnp.int32), params["step"])
            ct, st = jnp.cos(phit), jnp.sin(phit)
            cb, sb = jnp.cos(theta), jnp.sin(theta)
            if jnp.ndim(theta):
                cb, sb = cb[..., None], sb[..., None]
            c_ = cb * ct - sb * st
            s_ = sb * ct + cb * st
            theta_next = _wrap(theta + step_phase(T, params["step"]))
        if sgn < 0:
            s_ = -s_
        return (r * c_ - i * s_, r * s_ + i * c_), {"theta": theta_next}

    def planar_init(batch_shape=(), dtype=jnp.float32):
        return {"theta": jnp.full(batch_shape, theta0, dtype=jnp.float32)}

    return Proc(params={"step": jnp.int32(step),
                        "sintab": jnp.asarray(sintab)},
                init=init, apply=apply,
                rate=(1, 1), name=name, advance=advance,
                planar_apply=planar_apply, planar_init=planar_init,
                meta={"kind": "nco", "dphi": float(dphi), "step": step,
                      "theta0": float(theta0), "sgn": sgn,
                      "table": bool(table)})


def mix_down(x, dphi, theta0=0.0):
    """One-shot block mix-down: y[t] = x[t] * exp(-j(theta0 + t*dphi))
    (reference nco_crcf_mix_block_down, nco.c:311)."""
    T = x.shape[-1]
    t = jnp.arange(T, dtype=jnp.float32)
    ph = theta0 + t * dphi
    return x * lax.complex(jnp.cos(ph), -jnp.sin(ph))


def mix_up(x, dphi, theta0=0.0):
    """y[t] = x[t] * exp(+j(theta0 + t*dphi)) (nco.c:274)."""
    T = x.shape[-1]
    t = jnp.arange(T, dtype=jnp.float32)
    ph = theta0 + t * dphi
    return x * lax.complex(jnp.cos(ph), jnp.sin(ph))


def pll_step(theta, dphi, phase_error, bandwidth: float = 0.1):
    """Second-order PLL update (reference nco_crcf_pll_step, nco.c:220):
    adjusts frequency and phase from one phase-error measurement using the
    standard alpha/beta loop gains derived from the loop bandwidth."""
    alpha = bandwidth
    beta = jnp.sqrt(bandwidth)
    dphi = dphi + alpha * phase_error
    theta = theta + beta * phase_error
    return theta, dphi


def unwrap_phase(theta):
    """Unwrap a phase array along the last axis so successive samples
    never jump by more than pi (reference liquid_unwrap_phase,
    src/nco/src/nco.utilities.c:34-43).  The reference walks the array
    sequentially pulling each sample within pi of its corrected
    predecessor; the closed form below — wrap the first differences
    into (-pi, pi], then cumulative-sum from theta[0] — is identical
    and vectorizes (one cumsum, no scan)."""
    theta = jnp.asarray(theta)
    d = jnp.diff(theta, axis=-1)
    d = jnp.mod(d + jnp.pi, 2 * jnp.pi) - jnp.pi
    return jnp.concatenate(
        [theta[..., :1], theta[..., :1] + jnp.cumsum(d, axis=-1)], axis=-1)


def unwrap_phase2(theta):
    """Bias-aware phase unwrap (reference liquid_unwrap_phase2,
    src/nco/src/nco.utilities.c:45-70): estimate the mean first
    difference dphi over the raw array, then pull each difference into
    (-pi + dphi, pi + dphi] — phase ramps steeper than pi/sample unwrap
    correctly.  Closed form of the reference's sequential walk: the
    per-step 2*pi correction count is floor((d - dphi + pi)/2*pi) of
    the RAW difference (each correction shifts the next comparison by
    exactly its own multiple of 2*pi), so one floor + one cumsum."""
    theta = jnp.asarray(theta)
    d = jnp.diff(theta, axis=-1)
    n = theta.shape[-1]
    dphi = (theta[..., -1] - theta[..., 0])[..., None] / (n - 1)
    k = jnp.floor((d - dphi + jnp.pi) / (2 * jnp.pi))
    return jnp.concatenate(
        [theta[..., :1],
         theta[..., 1:] - 2 * jnp.pi * jnp.cumsum(k, axis=-1)], axis=-1)
