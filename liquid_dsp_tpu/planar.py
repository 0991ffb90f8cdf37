"""Planar (structure-of-arrays) execution of complex stream chains.

Layout: a complex64 array is interleaved (re, im) pairs, and elementwise
complex arithmetic lowers to strided vector ops; the same math on two
contiguous float32 planes is unit-stride (it ran about twice as fast on
the accelerator this library was first tuned on; not measured on H100).
Planes are also the input format of the fused chain kernel
(fuse.kernel_fuse).

`planar(proc)` re-expresses a complex->complex chain to carry every
stream as a ``(re, im)`` pair of float arrays:

  * stages that advertise ``Proc.planar_apply`` (mixers, real-tap FIR,
    fused LTI stages) run natively on the planes — no complex values
    exist anywhere in the computation;
  * every other stage is wrapped: ``lax.complex`` at its input,
    re/im split at its output.  XLA fuses these conversions into the
    neighbouring elementwise ops, so a lone wrapped stage costs little.

The reference has no analog — interleaved complex is the only layout C
gives it (liquid_float_complex, reference include/liquid.h:73); the
choice of storage layout is exactly the kind of freedom a from-scratch
design gets to exploit.

Compose with fusion as ``planar(fuse(chain))`` — fuse first, so the
fused stage's planar path is what runs.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from jax import lax

from .core import Proc, chain

__all__ = ["planar", "to_planes", "from_planes"]


def to_planes(x):
    """Complex array -> (re, im) float plane pair."""
    return (jnp.real(x), jnp.imag(x))


def from_planes(x):
    """(re, im) plane pair -> complex array."""
    r, i = x
    return lax.complex(r, i)


def _wrap_stage(p: Proc) -> Proc:
    """Run a complex-native stage inside a planar chain: complex at the
    stage boundary only."""

    def apply(params, carry, x):
        y, c2 = p.apply(params, carry, from_planes(x))
        return to_planes(y), c2

    return dataclasses.replace(p, apply=apply, name=p.name + "_wrapped")


def planar(proc: Proc) -> Proc:
    """Return an equivalent Proc whose streams are (re, im) plane pairs.

    The returned Proc's init builds a FRESH planar carry; transform
    before `init`, not mid-stream.  Only complex->complex chains are
    supported (a real-input or real-output stage inside the chain keeps
    its meaning through the wrapped path only if its complex view was
    already correct)."""
    if proc.children is not None:
        return chain(*[planar(c) for c in proc.children],
                     name=proc.name + "_planar")
    if proc.planar_apply is not None:
        return dataclasses.replace(
            proc, apply=proc.planar_apply,
            init=proc.planar_init if proc.planar_init is not None
            else proc.init,
            name=proc.name + "_planar")
    return _wrap_stage(proc)
