"""Streaming runtime: drive a Proc pipeline over a capture or live
block source with one compile and automatic carry management.

The reference library's "runtime" is the user's own C loop pushing
samples through objects (SURVEY.md §1: no scheduler).  Here the
equivalent production loop is provided: fixed-size blocks (one jit
compile), device-resident carry between blocks, optional device-mesh
sharding, and checkpoint/restore of the stream state.

    runner = StreamRunner(chain(nco(0.1), firfilt(h)), batch_shape=())
    for block in io.iq_stream("capture.cs16", "cs16", block=65536):
        y = runner(block)
    runner.save("state.npz")            # resume later via load()
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .core import Proc

__all__ = ["StreamRunner"]


class StreamRunner:
    """One-compile streaming executor for a Proc pipeline.

    Blocks must share one shape (pad the final block — io.iq_stream
    does).  The carry lives on device between blocks; params are passed
    as jit arguments, so one compile serves every block.
    """

    def __init__(self, proc: Proc, batch_shape=(), dtype=jnp.complex64,
                 mesh=None):
        self.proc = proc
        self.batch_shape = tuple(batch_shape)
        self.carry = proc.init(batch_shape=self.batch_shape, dtype=dtype)
        if mesh is None:
            self._step = jax.jit(proc.apply)
            self._sharded = False
        else:
            from .parallel.stream import time_shard_apply
            self._step = jax.jit(time_shard_apply(proc, mesh))
            self._sharded = True
        self.blocks_processed = 0

    def __call__(self, x):
        x = jnp.asarray(x)
        if self._sharded:
            y, self.carry = self._step(self.carry, x)
        else:
            y, self.carry = self._step(self.proc.params, self.carry, x)
        self.blocks_processed += 1
        return y

    def run(self, blocks):
        """Iterate a block source; yields output blocks."""
        for x in blocks:
            yield self(x)

    def reset(self, dtype=jnp.complex64):
        self.carry = self.proc.init(batch_shape=self.batch_shape,
                                    dtype=dtype)
        self.blocks_processed = 0

    def save(self, path) -> None:
        """Checkpoint the stream state (carry + block counter)."""
        from .utils.checkpoint import save_carry
        save_carry(path, {"carry": self.carry,
                          "blocks": np.int64(self.blocks_processed)})

    def load(self, path) -> None:
        """Restore a checkpoint written by save()."""
        from .utils.checkpoint import load_carry
        state = load_carry(path, {"carry": self.carry,
                                  "blocks": np.int64(0)})
        self.carry = state["carry"]
        self.blocks_processed = int(state["blocks"])
