#!/usr/bin/env python
"""Per-kernel device time of a jitted step, from a jax.profiler trace.

Runs a callable under `jax.profiler.trace` (with the Perfetto JSON the
profiler writes beside the .xplane.pb), keeps the events of the GPU
device planes, and sums device time per kernel name.  A host clock
around block_until_ready gives the step time; this gives where inside
the step the device spends it.

Usage as a library:
    from profile_device import profile
    rows = profile(lambda: fn(args), iters=5)   # [(name, us, count)]

CLI: profile one of the main-path steps on the card
    python tools/profile_device.py chain   [batch] [block]
    python tools/profile_device.py frame64 [batch] [block]
"""
import collections
import gzip
import json
import pathlib
import sys
import tempfile


sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def profile(fn, iters: int = 5, top: int = 30):
    """Run fn() `iters` times under a jax.profiler trace; return
    [(kernel_name, total_device_us, count)] sorted by time."""
    import jax
    jax.block_until_ready(fn())             # compile outside the trace
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td, create_perfetto_trace=True):
            r = None
            for _ in range(iters):
                r = fn()
            jax.block_until_ready(r)
        files = sorted(pathlib.Path(td).rglob("perfetto_trace.json.gz"))
        if not files:
            raise RuntimeError("no trace captured")
        with gzip.open(files[-1]) as f:
            tr = json.load(f)
    ev = tr.get("traceEvents", tr if isinstance(tr, list) else [])
    pids = {e["pid"]: e["args"].get("name", "") for e in ev
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev_pids = {p for p, n in pids.items() if "GPU" in n or "gpu" in n}
    if not dev_pids:
        raise RuntimeError(f"no GPU plane in the trace: {sorted(pids.values())}")
    agg = collections.Counter()
    cnt = collections.Counter()
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") in dev_pids:
            agg[e["name"]] += float(e.get("dur", 0))
            cnt[e["name"]] += 1
    return [(name, us, cnt[name]) for name, us in agg.most_common(top)]


def report(rows, iters):
    total = sum(us for _, us, _ in rows)
    print(f"{'device us/iter':>14s}  {'count':>5s}  kernel")
    for name, us, c in rows:
        print(f"{us / iters:14.1f}  {c:5d}  {name[:80]}")
    print(f"# listed kernels: {total / iters:.0f} us/iter")


def _step(kind, batch, T):
    import jax
    import jax.numpy as jnp
    key = jax.random.PRNGKey(0)
    xr = jax.random.normal(key, (batch, T), jnp.float32) * 0.7071
    xi = jax.random.normal(jax.random.fold_in(key, 1), (batch, T),
                           jnp.float32) * 0.7071
    if kind == "chain":
        from bench import build_chain
        from liquid_dsp_tpu import kernel_fuse, planar
        proc = planar(kernel_fuse(build_chain()))
        step = jax.jit(lambda c, r, i: proc.apply(proc.params, c, (r, i)))
    elif kind == "frame64":
        from liquid_dsp_tpu.framing.frame64 import framesync64_stream_full
        proc = framesync64_stream_full(T)
        step = jax.jit(lambda c, r, i: proc.apply(
            (), c, jax.lax.complex(r * 0.05, i * 0.05)))
    else:
        raise SystemExit(f"unknown target {kind}")
    state = {"c": jax.jit(lambda: proc.init(batch_shape=(batch,)))()}

    def once():
        out, state["c"] = step(state["c"], xr, xi)
        return out
    return once


def main():
    import jax
    from liquid_dsp_tpu.platform import enable_compile_cache
    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print("profile_device.py needs the GPU", file=sys.stderr)
        return 2
    kind = sys.argv[1] if len(sys.argv) > 1 else "chain"
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    T = int(sys.argv[3]) if len(sys.argv) > 3 else 1 << 18
    iters = 5
    report(profile(_step(kind, batch, T), iters=iters), iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
