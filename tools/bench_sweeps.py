#!/usr/bin/env python
"""Reference-style benchmark sweeps: dotprod N-sweep and FFT size sweep.

Mirrors the reference's benchmark machinery (BASELINE.md rows):
  * dotprod sweep N in {4, 16, 64, 256} per type — reference
    src/dotprod/bench/dotprod_crcf_benchmark.c:74-77.  On a device a lone
    length-N dot product is meaningless (dispatch-dominated), so the
    device-shaped equivalent is the BATCHED form the framework actually
    runs: [rows, N] @ [N], rows sized to hold work
    constant (rows*N ~ 2^22).  Reported as effective MAC/s.
  * FFT size sweep over radix-2 / composite / prime sizes — reference
    src/fft/bench/fft_runbench.c + bench/fftbench.c.  Batched 1-D
    transforms through the public fft_plan (method chooser: XLA for 2^m,
    four-step mixed-radix matmul-DFT x XLA-FFT for composite N with odd
    factor <= 2048, matmul DFT for small odd N, Rader for primes
beyond, Bluestein for the residual odd composites), batch
    sized so each case moves ~2^22 samples.

Methodology identical to bench.py: checksum chained through K in-jit
iterations, host value readback in the timed region, two-point
calibration.  Run: python tools/bench_sweeps.py [--fft] [--dotprod]
"""
import sys
import time
import pathlib

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from bench import timed_throughput  # noqa: E402


def _measure(step, x0, work_per_iter, K):
    """step: jitted (x, chk) -> (x', chk'); returns work/s."""
    import jax

    chk0 = np.float32(0)
    x, chk = step(x0, chk0)
    float(np.asarray(chk))          # warmup + value readback

    def run_trials(n):
        t0 = time.perf_counter()
        xx, c = x0, None
        for _ in range(n):
            xx, c = step(xx, chk0)
        float(np.asarray(c))
        return time.perf_counter() - t0

    return timed_throughput(run_trials, work_per_iter * K)


def dotprod_sweep():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    K = 16
    print("# dotprod sweep (batched [rows,N]@[N], f32, effective MAC/s)")
    for N in (4, 16, 64, 256):
        rows = (1 << 22) // N
        h = rng.standard_normal(N).astype(np.float32)
        x0 = jnp.asarray(rng.standard_normal((rows, N)).astype(np.float32))

        @jax.jit
        def step(x, chk, h=h):
            def body(c, _):
                x_, acc = c
                y = x_ @ jnp.asarray(h)          # [rows]
                # feed the result back so iterations are dependent
                x_ = x_ + (y[:, None] * np.float32(1e-6))
                return (x_, acc + jnp.sum(y * y)), None
            (x2, chk2), _ = jax.lax.scan(body, (x, chk), None, length=K)
            return x2, chk2

        macs = _measure(step, x0, rows * N, K)
        print(f"dotprod N={N:4d} rows={rows:7d}: {macs/1e9:8.2f} GMAC/s")


def fft_sweep():
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.ops.fft import fft_plan

    rng = np.random.default_rng(1)
    K = 8
    # radix-2, composite (2^a*b), prime — the reference's three method
    # families (chooser: XLA / four-step CT / matmul DFT / Rader / Bluestein)
    sizes = [64, 256, 1024, 4096,      # radix-2
             96, 384, 1200,            # composite
             127, 509, 1021,           # prime
             3069, 4095, 9207,         # odd composite > _DFT_MAX:
                                       # recursive CT (r4; was Bluestein)
             2053]                     # prime > _DFT_MAX: Rader (late r4)
    print("# fft sweep (batched 1-D c64 transforms, Msamples/s)")
    for n in sizes:
        batch = max(1, (1 << 22) // n)
        plan = fft_plan(n)
        xr = rng.standard_normal((batch, n)).astype(np.float32)
        xi = rng.standard_normal((batch, n)).astype(np.float32)
        x0 = jnp.asarray(xr) + 1j * jnp.asarray(xi) \
            if jax.default_backend() == "cpu" else \
            jax.jit(jax.lax.complex)(jnp.asarray(xr), jnp.asarray(xi))

        @jax.jit
        def step(x, chk, plan=plan, n=n):
            def body(c, _):
                x_, acc = c
                y = plan(x_)
                x_ = y * np.float32(1.0 / np.sqrt(n))  # keep magnitude
                return (x_, acc + jnp.sum(jnp.abs(y[:, 0]))), None
            (x2, chk2), _ = jax.lax.scan(body, (x, chk), None, length=K)
            return x2, chk2

        sps = _measure(step, x0, batch * n, K)
        kind = ("radix-2" if n & (n - 1) == 0 else
                "prime" if all(n % p for p in range(2, int(n**0.5) + 1))
                else "composite")
        print(f"fft n={n:5d} [{kind:9s}] batch={batch:6d}: "
              f"{sps/1e6:9.1f} Msamples/s")


if __name__ == "__main__":
    args = set(sys.argv[1:])
    if not args or "--dotprod" in args:
        dotprod_sweep()
    if not args or "--fft" in args:
        fft_sweep()
