#!/usr/bin/env python
"""Throughput of the flexframe streaming receiver's device-resident stage
(detect-everywhere + refine + header region extraction), batched over
independent channels — the second receiver family's number next to
tools/bench_frame64_rx.py.

Same methodology (planar host I/O, chained carries, checksum readback,
two-point calibration).  Prints one JSON line.
"""
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.framing.flexframe import flexframesync_stream

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
    proc = flexframesync_stream(T)
    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)

    def _generate():
        """The capture, built on the host in this process."""
        from liquid_dsp_tpu.framing.flexframe import flexframegen
        rng = np.random.default_rng(0)
        x = np.zeros((batch, T), np.complex64)
        for b in range(batch):
            pos = 100
            while True:
                h = rng.integers(0, 256, 14).astype(np.uint8)
                p = rng.integers(0, 256, 80).astype(np.uint8)
                f = flexframegen(h, p, ms='qpsk')
                if pos + len(f) + 100 > T: break
                x[b, pos:pos + len(f)] = f
                pos += len(f) + int(rng.integers(600, 1800))
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
        chk = (jnp.sum(jnp.real(out.region_syms) ** 2) +
               jnp.sum(out.rxy))
        return c2, chk, jnp.sum(out.valid)

    c, chk, nfr = step(carry0, xr, xi)
    float(np.asarray(chk))
    frames_per_block = int(np.asarray(nfr))

    def run_trials(n):
        t0 = time.perf_counter()
        c, chk = carry0, None
        for _ in range(n):
            c, chk, _ = step(c, xr, xi)
        float(np.asarray(chk))
        return time.perf_counter() - t0

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod",
        pathlib.Path(__file__).resolve().parent.parent / "bench.py")
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)
    msps = bm.timed_throughput(run_trials, batch * T) / 1e6

    print(json.dumps({"metric": "flexframesync_stream",
                      "msps": round(msps, 2), "batch": batch, "block": T,
                      "frames_per_block": frames_per_block}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
