"""Core streaming abstraction of the block-streaming DSP framework.

Design stance (NOT a port of the reference's per-sample object model):
the reference (liquid-dsp) streams one sample at a time through opaque C
objects with hidden ring-buffer state (e.g. ``firfilt_crcf_push/execute``,
reference src/filter/src/firfilt.c:297-336).  That model is the opposite of
what an accelerator runs well.  Here every streaming operation is a *pure function over
blocks with explicit carry state*::

    y_block, carry' = apply(params, carry, x_block)

* ``params`` — designed coefficients (filter taps, constellation tables,
  loop gains).  Traced constants under ``jit``.
* ``carry``  — a small pytree of inter-block state (filter tails, phase
  accumulators, loop-filter registers).  This is exactly the state that is
  exchanged between devices when the time axis is sharded, and exactly what
  is saved for checkpoint/resume.
* ``x_block`` — ``[..., T]`` array: time is the LAST axis, leading axes are
  batch/channel axes (sharded across the device mesh).

Chains compose by function composition (`chain`).  Sequential per-sample
recurrences (AGC, PLL, symbol sync) are expressed as ``lax.scan`` inside a
single ``apply``; block-parallel ops (FIR, FFT, mixing, resampling) are
closed-form over the whole block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import jax

Pytree = Any


@dataclasses.dataclass(frozen=True)
class LTI:
    """Static linear-time-invariant description of a Proc, enabling chain
    fusion (`liquid_dsp_tpu.fuse`):

        y[i] = sum_j taps[j] * x[down*i + d - j]

    with ``taps`` a HOST numpy array (1-D), integer decimation ``down`` >= 1
    and input offset ``0 <= d < down``.  Adjacent LTI stages compose into a
    single strided FIR (taps convolve, downs multiply, offsets accumulate) —
    the analog of the reference's freedom to pick any exact
    implementation for a filter cascade (reference
    examples/fftfilt_crcf_example.c asserts firfilt/fftfilt equivalence).
    """

    taps: Any
    down: int = 1
    d: int = 0


@dataclasses.dataclass(frozen=True)
class Proc:
    """A streaming block processor.

    Attributes:
      params:  pytree of designed coefficients (static under jit if closed over).
      init:    ``init(batch_shape=(), dtype=...) -> carry`` — fresh carry state.
               This is the analog of the reference's ``*_reset()`` methods
               (e.g. reference src/filter/src/firfilt.c:253), except the state
               is explicit and therefore checkpointable/shardable for free.
      apply:   ``apply(params, carry, x) -> (y, carry')`` — pure block step.
      rate:    output/input sample-rate ratio as a Fraction-like tuple
               ``(num, den)`` — e.g. (1, 2) for a 2:1 decimator.  Used by
               chain planners to compute static block shapes.
    """

    params: Pytree
    init: Callable[..., Pytree]
    apply: Callable[[Pytree, Pytree, Any], Tuple[Any, Pytree]]
    rate: Tuple[int, int] = (1, 1)
    name: str = "proc"
    # --- time-sharding metadata (SURVEY.md §2.12 / §5) ---
    # halo: if set, the carry is exactly the last `halo` input samples
    # (overlap-save state) -> sharded via a ppermute halo exchange.
    halo: Optional[int] = None
    # advance: closed-form carry advance `advance(params, carry, n)` after
    # consuming n input samples (e.g. NCO phase, resampler timing phase) ->
    # each shard computes its starting carry with zero communication.
    advance: Optional[Callable[[Pytree, Pytree, int], Pytree]] = None
    # children: set by `chain` so sharding transforms can recurse.
    children: Optional[Tuple["Proc", ...]] = None
    # lti: static FIR/decimator description enabling chain fusion (fuse.py).
    lti: Optional[LTI] = None
    # planar execution support (planar.py): complex streams carried as a
    # (re, im) float-plane pair — structure-of-arrays.  Stages without
    # these fields are wrapped (complex<->planes at the stage boundary)
    # by the `planar` transform.
    planar_apply: Optional[Callable] = None
    planar_init: Optional[Callable[..., Pytree]] = None
    # meta: static op description for pattern-matching transforms (e.g.
    # fuse.kernel_fuse recognizing a mixer ahead of a fused FIR).
    meta: Optional[dict] = None

    @property
    def jitted(self) -> Callable:
        """jit-compiled ``apply``, cached on the instance.  Procs are
        jittable by contract; compiling once is far cheaper than eager
        per-primitive dispatch (16s -> 1.2s for the streaming receivers
        on CPU) and the executable is reused across calls."""
        fn = self.__dict__.get("_jit_apply")
        if fn is None:
            fn = jax.jit(self.apply)
            object.__setattr__(self, "_jit_apply", fn)
        return fn

    def __call__(self, x, carry: Optional[Pytree] = None, **init_kw):
        """Convenience single-shot execution (fresh carry if none given)."""
        if carry is None:
            carry = self.init(**init_kw)
        return self.jitted(self.params, carry, x)

    def scan_blocks(self, x_blocks, carry: Optional[Pytree] = None, **init_kw):
        """Run over ``[N_blocks, ..., T]`` sequentially via lax.scan."""
        if carry is None:
            carry = self.init(**init_kw)

        def step(c, xb):
            yb, c = self.apply(self.params, c, xb)
            return c, yb

        carry, y = jax.lax.scan(step, carry, x_blocks)
        return y, carry


def scan_unroll(n: int) -> int:
    """Unroll factor for sequential time-recurrence scans: the platform
    policy's choice (platform.scan_unroll)."""
    from .platform import scan_unroll as _scan_unroll
    return _scan_unroll(n)


def planar_per_plane(apply: Callable, init: Callable):
    """(planar_apply, planar_init) for an op that is R-linear with REAL
    coefficients and an input-tail carry: filtering a complex stream is
    then exactly filtering each float plane independently (planar.py) —
    two contiguous unit-stride passes instead of one interleaved
    complex pass.  The op's own init/apply run per plane with f32."""
    import jax.numpy as jnp

    def planar_init(batch_shape=(), dtype=jnp.float32):
        return (init(batch_shape=batch_shape, dtype=dtype),
                init(batch_shape=batch_shape, dtype=dtype))

    def planar_apply(params, carry, x):
        (r, i), (cr, ci) = x, carry
        yr, cr2 = apply(params, cr, r)
        yi, ci2 = apply(params, ci, i)
        return (yr, yi), (cr2, ci2)

    return planar_apply, planar_init


def chain(*procs: Proc, name: str = "chain") -> Proc:
    """Compose processors left-to-right: the analog of the user wiring
    liquid objects in sequence (e.g. mixer -> firfilt -> decim in the
    reference's framesync64_step, src/framing/src/framesync64.c:327-365),
    but as one jit-able pure function.
    """
    params = tuple(p.params for p in procs)

    def init(**kw):
        return tuple(p.init(**kw) for p in procs)

    def apply(params, carry, x):
        new_carry = []
        for p, pp, c in zip(procs, params, carry):
            x, c = p.apply(pp, c, x)
            new_carry.append(c)
        return x, tuple(new_carry)

    num = den = 1
    for p in procs:
        num *= p.rate[0]
        den *= p.rate[1]
    return Proc(params=params, init=init, apply=apply, rate=(num, den),
                name=name, children=tuple(procs))
