#!/usr/bin/env python
"""Throughput of the full framesync64-style RX chain (BASELINE.md
correctness config #5) — the device-resident streaming receiver Proc
(detect-everywhere + batched refine/mix/MF/pilot-sync), batched over
independent channels.

Methodology matches bench.py: chained carries, a checksum folded through
every trial, host value readback inside the timed region, two-point
dt(2n)-dt(n) calibration.  Host I/O is planar float32; the complex
reassembly runs inside the jit, as in production planar ingest (io.py).

Prints one JSON line:
  {"metric": ("framesync64_full" if os.environ.get("FRAME64_FULL") else "framesync64_stream"), "msps": ..., "batch": B, "block": T,
   "frames_per_block": ...}
"""
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    import os
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.framing.frame64 import (FRAME64_LEN, framegen64,
                                                framesync64_stream)

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 8192
    if os.environ.get("FRAME64_FULL"):
        from liquid_dsp_tpu.framing.frame64 import framesync64_stream_full
        proc = framesync64_stream_full(T)
    else:
        proc = framesync64_stream(T)
    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)

    def _generate():
        """The capture, built on the host in this process."""
        from liquid_dsp_tpu.framing.frame64 import FRAME64_LEN, framegen64
        rng = np.random.default_rng(0)
        x = np.zeros((batch, T), np.complex64)
        for b in range(batch):
            h = rng.integers(0, 256, 8).astype(np.uint8)
            p = rng.integers(0, 256, 64).astype(np.uint8)
            s0 = int(rng.integers(0, T - FRAME64_LEN - 1))
            x[b, s0:s0 + FRAME64_LEN] = framegen64(h, p)
        x += (0.01 * (rng.standard_normal(x.shape) +
                      1j * rng.standard_normal(x.shape))).astype(np.complex64)
        return x

    x = _generate()

    xr = jnp.asarray(x.real.copy())
    xi = jnp.asarray(x.imag.copy())
    carry0 = jax.jit(lambda: proc.init(batch_shape=(batch,)))()

    @jax.jit
    def step(c, r, i):
        out, c2 = proc.apply((), c, jax.lax.complex(r, i))
        if hasattr(out, "symbols"):
            chk = (jnp.sum(jnp.real(out.symbols) ** 2) +
                   jnp.sum(out.rxy) + jnp.sum(out.evm_db * 0.0))
        else:   # full in-stream decode: checksum the decoded BYTES
            chk = (jnp.sum(out.pay_bytes.astype(jnp.float32)) +
                   jnp.sum(out.hdr_bytes.astype(jnp.float32)) +
                   jnp.sum(out.rxy))
        nfr = jnp.sum(out.valid)
        return c2, chk, nfr

    c, chk, nfr = step(carry0, xr, xi)
    float(np.asarray(chk))  # value readback (warmup/compile)
    frames_per_block = int(np.asarray(nfr))

    def run_trials(n):
        t0 = time.perf_counter()
        c, chk = carry0, None
        for _ in range(n):
            c, chk, _ = step(c, xr, xi)
        float(np.asarray(chk))  # value readback: proves completion
        return time.perf_counter() - t0

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod", pathlib.Path(__file__).resolve().parent.parent / "bench.py")
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)
    msps = bm.timed_throughput(run_trials, batch * T) / 1e6

    print(json.dumps({"metric": ("framesync64_full" if os.environ.get("FRAME64_FULL") else "framesync64_stream"), "msps": round(msps, 2),
                      "batch": batch, "block": T,
                      "frames_per_block": frames_per_block}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
