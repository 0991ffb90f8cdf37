#!/usr/bin/env python
"""On-device throughput for the timing-recovery / adaptive family:
symsync, symtrack, eqlms — the lax.scan recurrences (ROADMAP.md speed
item 3: sequential scans pay per-step launches on the GPU).

Reference analogs: symsync (reference src/filter/src/symsync.c:76-110),
symtrack (src/framing/src/symtrack.c:42-124), eqlms
(src/equalization/src/eqlms.c:304-330).

Methodology: single dispatch per block (the reference bench semantics,
tools/bench_suite.py), value-verified — a checksum folds every trial's
output and is read back on the host inside the timed region, and each
trial feeds the previous trial's carry so nothing can be elided.  The
sweep over batch B in {16, 64, 256} at fixed per-channel block length
is the measured scaling curve for the documented mitigation: shard
sequential scans over CHANNELS, never over time (SURVEY.md §7 hard
part #1).

Usage: python tools/bench_timing_family.py [T]   (default T=32768)
"""
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

BATCHES = (16, 64, 256)


def _bench(step_chk, params, carry0, x, min_t=0.3):
    """Two-point calibrated timing (bench.py methodology): dt(2n)-dt(n)
    cancels the fixed dispatch and final-wait latency."""
    import jax.numpy as jnp

    def run_trials(n):
        t0 = time.perf_counter()
        c = carry0
        chk = jnp.float32(0)
        for _ in range(n):
            _, c, chk = step_chk(params, c, x, chk)
        float(np.asarray(chk))  # value readback: proves completion
        return time.perf_counter() - t0

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod",
        pathlib.Path(__file__).resolve().parent.parent / "bench.py")
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)
    return bm.timed_throughput(run_trials, x.size) / 1e6


def bench_proc(proc, x, out_sel=None):
    """Throughput of proc.apply over block x, Msamples/s of INPUT."""
    import jax
    import jax.numpy as jnp

    sel = out_sel or (lambda y: y)

    @jax.jit
    def step_chk(params, c, xb, chk):
        y, c2 = proc.apply(params, c, xb)
        s = jnp.sum(jnp.real(jnp.ravel(sel(y))[:16]))
        return y, c2, chk + s

    carry = jax.jit(
        lambda s=x.shape[:-1]: proc.init(batch_shape=s))()
    params = jax.jit(lambda: proc.params)()
    _, c, chk = step_chk(params, carry, x, jnp.float32(0))
    float(np.asarray(chk))  # warmup + completion proof
    return _bench(step_chk, params, carry, x)


def main():
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.ops.symsync import symsync
    from liquid_dsp_tpu.ops.equalize import eqlms
    from liquid_dsp_tpu.framing.symtrack import symtrack_stream

    T = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    dev = jax.devices()[0]
    print(f"backend: {dev.platform} {dev}", file=sys.stderr)
    rng = np.random.default_rng(7)

    def cplx(B, n):
        re = rng.standard_normal((B, n)).astype(np.float32)
        im = rng.standard_normal((B, n)).astype(np.float32)
        if jax.default_backend() == "cpu":
            return jnp.asarray(re + 1j * im)
        # assemble complex on device from float planes
        return jax.jit(jax.lax.complex)(jnp.asarray(re), jnp.asarray(im))

    results = {}

    def row(name, fn):
        try:
            results[name] = fn()
            print(f"{name:24s} {results[name]:10.1f} Msamples/s",
                  file=sys.stderr)
        except Exception as e:
            results[name] = None
            print(f"{name:24s} FAILED ({type(e).__name__}: "
                  f"{str(e)[:120]})", file=sys.stderr)

    for B in BATCHES:
        row(f"symsync_B{B}",
            lambda B=B: bench_proc(symsync(k=2, m=5), cplx(B, T),
                                   out_sel=lambda y: y[0]))
    for B in BATCHES:
        # trained LMS: input is an (x, d) tuple — bench with d = x
        # delayed-by-0 (training math is identical for any d)
        def run(B=B):
            proc = eqlms(h_len=13, mu=0.05)
            x = cplx(B, T)

            @jax.jit
            def step_chk(params, c, xb, chk):
                y, c2 = proc.apply(params, c, (xb, xb))
                return y, c2, chk + jnp.sum(jnp.real(jnp.ravel(y)[:16]))

            carry = jax.jit(lambda: proc.init(batch_shape=(B,)))()
            _, c, chk = step_chk((), carry, x, jnp.float32(0))
            float(np.asarray(chk))
            return _bench(step_chk, (), carry, x)
        row(f"eqlms13_trained_B{B}", run)
    for B in BATCHES:
        row(f"eqlms13_dd_B{B}",
            lambda B=B: bench_proc(eqlms(h_len=13, mu=0.05), cplx(B, T)))
    for B in BATCHES:
        row(f"symtrack_B{B}",
            lambda B=B: bench_proc(symtrack_stream(ms="qpsk"), cplx(B, T),
                                   out_sel=lambda y: y[0]))
    # eqrls: O(h^2) per-sample state (the [L, L] P update makes each
    # scan step ~L times eqlms's; reference eqrls_cccf_benchmark analog)
    from liquid_dsp_tpu.ops.equalize import eqrls
    for B in BATCHES:
        def run_rls(B=B):
            proc = eqrls(h_len=13)
            x = cplx(B, T)

            @jax.jit
            def step_chk(params, c, xb, chk):
                y, c2 = proc.apply(params, c, (xb, xb))
                return y, c2, chk + jnp.sum(jnp.real(jnp.ravel(y)[:16]))

            carry = jax.jit(lambda: proc.init(batch_shape=(B,)))()
            _, c, chk = step_chk((), carry, x, jnp.float32(0))
            float(np.asarray(chk))
            return _bench(step_chk, (), carry, x)
        row(f"eqrls13_trained_B{B}", run_rls)

    print(json.dumps({"T": T, "msps": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
