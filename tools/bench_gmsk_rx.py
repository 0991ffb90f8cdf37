#!/usr/bin/env python
"""Throughput of the GMSK streaming receiver's device-resident detection
stage (detect-everywhere correlation vs the GMSK-modulated preamble
template + per-candidate refinement), batched over channels — the
fourth receiver family next to bench_frame64_rx / bench_flexframe_rx /
bench_ofdm_rx.

Same methodology (planar host I/O, K blocks chained in-jit with flowing
carry, checksum readback, two-point calibration).  Prints one JSON
line.
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
    from liquid_dsp_tpu.framing.gmskframe import _template
    from liquid_dsp_tpu.framing.stream_rx import detector_stream

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
    tpl = _template(2, 3, 0.5)
    proc = detector_stream(T, tpl, suppress_span=len(tpl) - 8,
                           max_frames=8)
    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)

    def _generate():
        """The capture, built on the host in this process."""
        from liquid_dsp_tpu.framing.gmskframe import gmskframegen
        rng = np.random.default_rng(0)
        x = np.zeros((batch, T), np.complex64)
        for b in range(batch):
            pos = 300
            while True:
                h = rng.integers(0, 256, 8).astype(np.uint8)
                p = rng.integers(0, 256, 40).astype(np.uint8)
                f = gmskframegen(h, p)
                if pos + len(f) + 300 > T: break
                x[b, pos:pos + len(f)] += f.astype(np.complex64)
                pos += len(f) + int(rng.integers(1500, 4000))
        x += (0.01 * (rng.standard_normal(x.shape) +
                      1j * rng.standard_normal(x.shape))).astype(np.complex64)
        return x

    x = _generate()

    xr = jnp.asarray(x.real.copy())
    xi = jnp.asarray(x.imag.copy())
    carry0 = jax.jit(lambda: proc.init(batch_shape=(batch,)))()
    K = 8 if jax.default_backend() != "cpu" else 1

    @jax.jit
    def step(c, r, i):
        def body(cc, _):
            c_in, acc, nv = cc
            out, c2 = proc.apply((), c_in, jax.lax.complex(r, i))
            acc = acc + jnp.sum(out.rxy) + jnp.sum(out.dphi)
            return (c2, acc, jnp.sum(out.valid)), None
        (c2, chk, nv), _ = jax.lax.scan(
            body, (c, jnp.float32(0), jnp.int32(0)), None, length=K)
        return c2, chk, nv

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
    msps = bm.timed_throughput(run_trials, K * batch * T) / 1e6

    print(json.dumps({"metric": "gmsk_detector_stream",
                      "msps": round(msps, 2), "batch": batch, "block": T,
                      "frames_per_block": frames_per_block}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
