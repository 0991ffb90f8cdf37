"""Sharded stream execution: run a Proc with the time axis split across
devices, exchanging exactly the state the reference keeps in its ring
buffers.

Mapping from reference mechanisms (SURVEY.md §2.12, §5):
  * firfilt/fftfilt tail state (reference fftfilt.c:259 saved tail) ->
    `halo` procs: each device ppermutes its last `halo` input samples to its
    right time-neighbor; device 0 uses the inter-call carry.  One
    nearest-neighbor hop, overlapping-save semantics, bit-identical to
    the single-device stream.
  * phase accumulators (NCO theta, resamp tau — affine in sample index,
    reference resamp.c:305) -> `advance` procs: each shard computes its
    starting carry in closed form; zero communication.
  * chains -> recurse over children inside ONE shard_map (halos of all
    stages exchange in the same program; XLA overlaps them with compute).

Sequential-carry procs (AGC/PLL/symsync scans) do not time-shard; shard
those over channels ("ch" axis) instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core import Proc

__all__ = ["time_shard_apply", "run_time_sharded", "stream_jit"]


def _tree_select(pred, a, b):
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(pred, x, y), a, b)


def _local_apply(proc: Proc, params, carry, x_local, axis: str, n_shards: int,
                 no_collectives: bool = False):
    """Apply one proc on a time-shard, resolving its carry locally.

    Returns (y_local, carry') with carry' computed identically on every
    device (replicated), so the next block step starts consistent.

    no_collectives=True replaces the ppermute/psum exchange with local
    stand-ins of identical shape — output is WRONG at shard boundaries;
    it exists only so tools/bench_scaling.py can time the same per-shard
    compute without the collectives and isolate communication overhead.
    """
    if proc.children is not None:
        new_carries = []
        for p, pp, c in zip(proc.children, params, carry):
            x_local, c2 = _local_apply(p, pp, c, x_local, axis, n_shards,
                                       no_collectives)
            new_carries.append(c2)
        return x_local, tuple(new_carries)

    idx = lax.axis_index(axis)
    T_local = x_local.shape[-1]

    if proc.halo is not None:
        h = proc.halo
        if h == 0:
            return proc.apply(params, carry, x_local)
        if h > T_local:
            raise ValueError(
                f"halo {h} exceeds local block {T_local}; use longer blocks")
        tail = x_local[..., T_local - h:]
        if no_collectives:
            # measurement-only: same shapes/compute, no communication
            left = tail
            carry_in = _tree_select(idx == 0, carry.astype(x_local.dtype),
                                    left)
            y, _ = proc.apply(params, carry_in, x_local)
            return y, left
        perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        left = lax.ppermute(tail, axis, perm)
        # device 0's "left" is the wrap-around from the LAST device — which
        # is precisely the new inter-block carry; devices >0 use the halo.
        carry_in = _tree_select(idx == 0, carry.astype(x_local.dtype), left)
        y, _ = proc.apply(params, carry_in, x_local)
        # new global carry = last device's tail = what device 0 received;
        # replicate it to all devices with a masked psum.
        new_carry = lax.psum(jnp.where(idx == 0, left, jnp.zeros_like(left)),
                             axis)
        return y, new_carry

    if proc.advance is not None:
        carry_here = proc.advance(params, carry, idx * T_local)
        y, _ = proc.apply(params, carry_here, x_local)
        new_carry = proc.advance(params, carry, n_shards * T_local)
        return y, new_carry

    raise ValueError(
        f"proc {proc.name!r} has neither halo nor advance metadata; "
        "it cannot be time-sharded (shard over channels instead)")


def time_shard_apply(proc: Proc, mesh: Mesh, time_axis: str = "t",
                     channel_axis: Optional[str] = "ch",
                     no_collectives: bool = False):
    """Build a jitted sharded step: (carry, x_global) -> (y_global, carry').

    x_global: [..., T]; its last axis is sharded over `time_axis`, leading
    batch axes (if any) over `channel_axis`.  The carry is replicated.
    Output is bit-equivalent (within float tolerance) to proc.apply on one
    device — asserted by tests/test_parallel.py.
    """
    n_shards = mesh.shape[time_axis]

    def step(carry, x):
        return _local_apply(proc, proc.params, carry, x, time_axis, n_shards,
                            no_collectives)

    # channel_axis may be a TUPLE of mesh axis names — the hierarchical
    # (dcn, ici) layout of SURVEY §5: the leading batch/channel dim is
    # data-parallel over the product of those axes (e.g. hosts x chips),
    # while the time axis halo-exchanges over its own axis.
    ch_axes = (channel_axis if isinstance(channel_axis, (tuple, list))
               else (channel_axis,)) if channel_axis is not None else ()
    if isinstance(channel_axis, (tuple, list)):
        # an EXPLICIT tuple must name real mesh axes — a typo silently
        # dropping one axis would quietly lose data parallelism
        unknown = [a for a in ch_axes if a not in mesh.shape]
        if unknown:
            raise ValueError(f"channel_axis names {unknown} not in mesh "
                             f"axes {tuple(mesh.shape)}")
    ch_axes = tuple(a for a in ch_axes if a in mesh.shape)
    ch_name = (ch_axes if len(ch_axes) > 1 else
               ch_axes[0] if ch_axes else None)

    def x_spec(x):
        names = [None] * (x.ndim - 1) + [time_axis]
        if ch_name is not None and x.ndim > 1:
            names[0] = ch_name
        return P(*names)

    def carry_spec(carry, ch_sharded: bool):
        # carry leaves carry the batch axes in front; shard them over the
        # channel axis alongside the data, replicate over time.
        def leaf_spec(leaf):
            if ch_sharded and jnp.ndim(leaf) >= 1:
                return P(ch_name, *([None] * (jnp.ndim(leaf) - 1)))
            return P()
        return jax.tree_util.tree_map(leaf_spec, carry)

    def run(carry, x):
        ch_sharded = (ch_name is not None and x.ndim > 1 and
                      int(np.prod([mesh.shape[a] for a in ch_axes])) > 1)
        cspec = carry_spec(carry, ch_sharded)
        sm = shard_map(
            step, mesh=mesh,
            in_specs=(cspec, x_spec(x)),
            out_specs=(x_spec(x), cspec),
            check_vma=False,
        )
        return sm(carry, x)

    return run


def run_time_sharded(proc: Proc, mesh: Mesh, x, carry=None, **init_kw):
    """Convenience: place x, run one sharded block step."""
    if carry is None:
        carry = proc.init(**init_kw)
    fn = jax.jit(time_shard_apply(proc, mesh))
    return fn(carry, x)


def stream_jit(proc: Proc, mesh: Optional[Mesh] = None, **shard_kw):
    """jit a Proc's apply, optionally time-sharded over a mesh."""
    if mesh is None:
        return jax.jit(lambda carry, x: proc.apply(proc.params, carry, x))
    return jax.jit(time_shard_apply(proc, mesh, **shard_kw))
