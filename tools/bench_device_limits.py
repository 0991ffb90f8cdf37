#!/usr/bin/env python
"""Measure what this card reaches: device-memory streaming (a copy and a
saxpy) and dense matmul throughput in float32 (HIGHEST), TF32 and bf16.

These are the denominators for roofline shares quoted in PERF.md: a
kernel's share of what a large plain product or copy reaches says more
than its share of the data-sheet peak.  The card's name and power limit
are printed beside the numbers (a card below its 700 W limit cannot hold
its top clock under matrix load).

    python tools/bench_device_limits.py

Needs the GPU.  Prints one JSON line.
"""
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _time(fn, n=20):
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from liquid_dsp_tpu.platform import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("bench_device_limits.py needs the GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    key = jax.random.PRNGKey(0)
    out = {"card": card, "device_kind": dev.device_kind}

    # device memory: 1 GiB arrays (far past the 50 MB L2)
    n = 1 << 28
    x = jax.random.normal(key, (n,), jnp.float32)
    y = jax.random.normal(jax.random.fold_in(key, 1), (n,), jnp.float32)
    copy = jax.jit(lambda a: a + 1.0)                 # read + write
    saxpy = jax.jit(lambda a, b: 1.0001 * a + b)      # 2 reads + write
    out["copy_gbs"] = 2 * 4 * n / _time(lambda: copy(x)) / 1e9
    out["saxpy_gbs"] = 3 * 4 * n / _time(lambda: saxpy(x, y)) / 1e9
    del x, y

    M = 8192
    a = jax.random.normal(key, (M, M), jnp.float32)
    b = jax.random.normal(jax.random.fold_in(key, 2), (M, M), jnp.float32)
    flops = 2 * M ** 3
    for name, fn, args in (
            ("matmul_f32_highest_tflops",
             jax.jit(lambda p, q: jnp.matmul(
                 p, q, precision=lax.Precision.HIGHEST)), (a, b)),
            ("matmul_tf32_tflops",
             jax.jit(lambda p, q: jnp.matmul(
                 p, q, precision=lax.DotAlgorithmPreset.TF32_TF32_F32)),
             (a, b)),
            ("matmul_bf16_tflops", jax.jit(jnp.matmul),
             (a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)))):
        out[name] = flops / _time(lambda f=fn, g=args: f(*g), 10) / 1e12
    print(json.dumps({k: (round(v, 1) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
