"""Stage pipelining across device groups.

The reference composes DSP objects sequentially in one thread (SURVEY.md
§2.12: "pipeline across chain stages" has no reference analog).  The
design places each stage of a chain on its OWN device (or
device group), with stage state (params + carry) resident on that
device.  Blocks flow stage-to-stage over the interconnect.

Concurrency model: jax dispatch is asynchronous and the runtime tracks
dependencies per buffer, so a host loop that enqueues block i+1 into
stage 0 while block i sits in stage 1 gets true cross-group overlap —
device s computes stage s of block i while device s-1 computes stage
s-1 of block i+1.  No collective is needed; the inter-stage transfer is
a point-to-point device-to-device copy (NVLink between GPUs of a host).

Semantics are identical to running `chain(*procs)` on one device: the
pipeline only changes WHERE each stage executes, asserted by the
equivalence test (tests/test_parallel.py pattern: pipelined ==
single-device == golden).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["StagePipeline"]


class StagePipeline:
    """Run a chain of Procs as a pipeline across device groups.

    procs: list of Proc (arbitrary rates); devices: one jax.Device per
    stage (defaults to the first len(procs) devices, cycling if the
    chain is longer than the device count).

    feed(block) enqueues one block through all stages and returns the
    final-stage output (async — a jax array whose value materializes
    when ready).  run(blocks) maps feed over a [N, ..., T] batch and
    blocks on completion.  Carries live on their stage's device across
    calls; reset() re-initializes them.
    """

    def __init__(self, procs, devices=None, batch_shape=(),
                 dtype=jnp.complex64):
        self.procs = list(procs)
        devs = list(devices if devices is not None else jax.devices())
        if not devs:
            raise ValueError("no devices")
        self._devs = [devs[i % len(devs)] for i in range(len(self.procs))]
        self._batch_shape = batch_shape
        self._dtype = dtype
        # stage params + jitted applies, pinned per device
        self._params = [
            jax.device_put(p.params, d)
            for p, d in zip(self.procs, self._devs)]
        self._applies = [jax.jit(p.apply) for p in self.procs]
        self.reset()

    def reset(self):
        self._carries = [
            jax.device_put(p.init(batch_shape=self._batch_shape,
                                  dtype=self._dtype), d)
            for p, d in zip(self.procs, self._devs)]

    def feed(self, block):
        """Push one block through the pipeline; returns the last
        stage's output (not yet materialized — dispatch is async)."""
        y = block
        for s, (ap, d) in enumerate(zip(self._applies, self._devs)):
            y = jax.device_put(y, d)            # inter-stage transfer
            y, self._carries[s] = ap(self._params[s], self._carries[s], y)
        return y

    def run(self, blocks):
        """Process a [N, ..., T] stack of blocks; returns the stacked
        outputs (waits for completion).  The host loop keeps all stages
        busy: block i+1 enters stage 0 while block i is downstream."""
        outs = [self.feed(jnp.asarray(b)) for b in blocks]
        return np.stack([np.asarray(o) for o in outs])
