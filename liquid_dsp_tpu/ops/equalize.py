"""Adaptive equalizers: normalized LMS and RLS as lax.scan recurrences.

Reference analogs (studied, not copied):
  * eqlms — src/equalization/src/eqlms.c:34-49 struct; push/execute/step
            at :248-330.  Normalized LMS: w += mu * conj(e) * x / sum|x|^2.
  * eqrls — src/equalization/src/eqrls.c:33+ — recursive least squares
            with P-matrix update.

The per-sample weight update is a sequential recurrence (SURVEY.md §7
hard-parts #1): lax.scan with carry (w, window, x2_sum / P).  Batch axes
vectorize; the inner products are elementwise and matmul work.

Weight/filter convention: the window holds the last h_len inputs oldest-
first; y = sum_i conj(w[i]) * buf[i]  (reference eqlms.c _execute).
Training modes mirror the reference: known training sequence d, or
decision-directed via a slicer callback.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..core import Proc, scan_unroll

__all__ = ["eqlms_init_weights", "eqlms_run", "eqlms", "eqrls_run", "eqrls"]


def eqlms_init_weights(h_len: int, h=None) -> np.ndarray:
    """Default initial weights: delta at the FIRST index (the oldest
    window slot), matching reference eqlms.c create with NULL h."""
    if h is not None:
        return np.asarray(h)
    w = np.zeros(h_len, np.complex64)
    w[0] = 1.0
    return w


def eqlms_lowpass_weights(h_len: int, fc: float = 0.45) -> np.ndarray:
    """Kaiser lowpass initial weights (reference eqlms_create_lowpass:
    liquid_firdes_kaiser(h_len, fc, 40dB))."""
    from ..design.firdes import firdes_kaiser
    return firdes_kaiser(h_len, fc, 40.0).astype(np.complex64)


def eqlms_run(w0, mu: float, carry, x, d=None,
              slicer: Optional[Callable] = None):
    """Run LMS over a block.

    carry: {w: [..., L], buf: [..., L], x2_sum: [...]}
    x: [..., T] input samples; d: [..., T] desired outputs (training), or
    None with a slicer for decision-directed operation.
    Returns (y, carry').
    """
    L = carry["w"].shape[-1]

    def step(c, inputs):
        if d is None:
            xt = inputs
        else:
            xt, dt = inputs
        buf = jnp.concatenate([c["buf"][..., 1:], xt[..., None]], axis=-1)
        x2 = (xt * jnp.conj(xt)).real
        x2_sum = c["x2_sum"] + x2 - (c["buf"][..., 0] *
                                     jnp.conj(c["buf"][..., 0])).real
        y = jnp.sum(jnp.conj(c["w"]) * buf, axis=-1)
        target = dt if d is not None else slicer(y)
        e = target - y
        denom = jnp.maximum(x2_sum, 1e-12)
        # the reference skips weight updates until h_len samples have
        # been pushed (eqlms.c _step buf_full gating)
        n = c["n"] + 1
        gate = (n >= L).astype(denom.dtype)
        w = c["w"] + gate[..., None] * mu * jnp.conj(e)[..., None] * \
            buf / denom[..., None]
        return {"w": w, "buf": buf, "x2_sum": x2_sum, "n": n}, y

    xt = jnp.moveaxis(x, -1, 0)
    if d is not None:
        dt = jnp.moveaxis(d, -1, 0)
        carry, yt = lax.scan(step, carry, (xt, dt), unroll=scan_unroll(8))
    else:
        carry, yt = lax.scan(step, carry, xt, unroll=scan_unroll(8))
    return jnp.moveaxis(yt, 0, -1), carry


def eqlms(h_len: int = 5, mu: float = 0.5, h=None,
          slicer: Optional[Callable] = None,
          name: str = "eqlms") -> Proc:
    """Streaming LMS equalizer Proc.

    With a slicer: decision-directed (blind) adaptation.  Without: the
    block input must be a (x, d) tuple for trained adaptation; a plain
    array runs decision-directed with a hard sign slicer.
    """
    w_init = eqlms_init_weights(h_len, h)
    # default decision device: UNIT-ENERGY QPSK points (+-sqrt(1/2) per
    # rail) to match the framework's modem normalization — a +-1+-1j
    # slicer has 3 dB of systematic scale error and diverges on
    # unit-energy input (reference eqlms blind operation likewise
    # references the unit circle, examples/eqlms_cccf_blind_example.c)
    s2 = np.float32(np.sqrt(0.5))
    default_slicer = slicer or (
        lambda y: (jnp.sign(y.real) * s2 + 1j * jnp.sign(y.imag) * s2)
        if jnp.iscomplexobj(y) else jnp.sign(y))

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"w": jnp.broadcast_to(jnp.asarray(w_init, dtype),
                                      batch_shape + (h_len,)),
                "buf": jnp.zeros(batch_shape + (h_len,), dtype),
                "x2_sum": jnp.zeros(batch_shape, jnp.float32),
                "n": jnp.zeros(batch_shape, jnp.int32)}

    def apply(params, carry, x):
        if isinstance(x, tuple):
            xb, db = x
            return eqlms_run(None, mu, carry, xb, d=db)
        return eqlms_run(None, mu, carry, x, slicer=default_slicer)

    return Proc(params={}, init=init, apply=apply, name=name)


def eqrls_run(lam: float, delta: float, carry, x, d):
    """Recursive least squares over a block (trained).

    carry: {w: [..., L], buf: [..., L], P: [..., L, L]}
    Standard RLS: k = P x / (lam + x^H P x); w += k conj(e);
    P = (P - k x^H P)/lam  (reference eqrls.c:252+).
    """

    def step(c, inputs):
        xt, dt = inputs
        buf = jnp.concatenate([c["buf"][..., 1:], xt[..., None]], axis=-1)
        # a-priori output and error
        y = jnp.sum(jnp.conj(c["w"]) * buf, axis=-1)
        e = dt - y
        Px = jnp.einsum("...ij,...j->...i", c["P"], buf)
        denom = lam + jnp.einsum("...i,...i->...", jnp.conj(buf), Px).real
        k = Px / denom[..., None]
        w = c["w"] + k * jnp.conj(e)[..., None]
        P = (c["P"] - jnp.einsum("...i,...j,...jl->...il",
                                 k, jnp.conj(buf), c["P"])) / lam
        return {"w": w, "buf": buf, "P": P}, y

    xt = jnp.moveaxis(x, -1, 0)
    dt = jnp.moveaxis(d, -1, 0)
    carry, yt = lax.scan(step, carry, (xt, dt), unroll=scan_unroll(8))
    return jnp.moveaxis(yt, 0, -1), carry


def eqrls(h_len: int = 5, lam: float = 0.99, delta: float = 0.1,
          h=None, name: str = "eqrls") -> Proc:
    """Streaming RLS equalizer Proc (trained mode: input = (x, d))."""
    w_init = eqlms_init_weights(h_len, h)

    def init(batch_shape=(), dtype=jnp.complex64):
        eye = jnp.eye(h_len, dtype=dtype) / delta
        return {"w": jnp.broadcast_to(jnp.asarray(w_init, dtype),
                                      batch_shape + (h_len,)),
                "buf": jnp.zeros(batch_shape + (h_len,), dtype),
                "P": jnp.broadcast_to(eye, batch_shape + (h_len, h_len))}

    def apply(params, carry, x):
        xb, db = x
        return eqrls_run(lam, delta, carry, xb, db)

    return Proc(params={}, init=init, apply=apply, name=name)
