#!/usr/bin/env python
"""Throughput of the OFDM flexframe streaming receiver's device-resident
detector stage (S0 autocorrelation detect-everywhere + CFO/timing
estimation), batched over independent channels — the third receiver
family's number next to bench_frame64_rx.py / bench_flexframe_rx.py.

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
    from liquid_dsp_tpu.multichannel.ofdm import (ofdm_detector_stream,
                                                  ofdm_params)

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
    params = ofdm_params(64, 16)
    proc = ofdm_detector_stream(T, params)
    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)

    def _generate():
        """The capture, built on the host in this process."""
        from liquid_dsp_tpu.framing.ofdmflexframe import ofdmflexframegen
        rng = np.random.default_rng(0)
        x = np.zeros((batch, T), np.complex64)
        for b in range(batch):
            pos = 200
            while True:
                h = rng.integers(0, 256, 8).astype(np.uint8)
                p = rng.integers(0, 256, 64).astype(np.uint8)
                f = ofdmflexframegen(h, p, ms='qpsk')
                if pos + len(f) + 200 > T: break
                x[b, pos:pos + len(f)] += f
                pos += len(f) + int(rng.integers(1200, 3000))
        x += (0.01 * (rng.standard_normal(x.shape) +
                      1j * rng.standard_normal(x.shape))).astype(np.complex64)
        return x

    x = _generate()

    xr = jnp.asarray(x.real.copy())
    xi = jnp.asarray(x.imag.copy())
    carry0 = jax.jit(lambda: proc.init(batch_shape=(batch,)))()

    # K blocks chained inside one jit (carry flows block to block,
    # StreamRunner's execution shape) to amortize per-dispatch overhead
    K = 8 if jax.default_backend() != "cpu" else 1

    @jax.jit
    def step(c, r, i):
        def body(cc, _):
            c_in, acc, nv = cc
            out, c2 = proc.apply((), c_in, jax.lax.complex(r, i))
            valid, idx, cfo, peak = out
            acc = acc + jnp.sum(peak) + jnp.sum(cfo) + jnp.sum(idx)
            return (c2, acc, jnp.sum(valid)), None
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

    print(json.dumps({"metric": "ofdm_detector_stream",
                      "msps": round(msps, 2), "batch": batch, "block": T,
                      "frames_per_block": frames_per_block}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
