#!/usr/bin/env python
"""Headline benchmark: complex Msamples/s on the mix -> FIR64 -> FIR57 ->
msresamp(0.5) chain, 64 channels x 262,144 samples per block.

Runs on the GPU; with no GPU it exits nonzero unless JAX_PLATFORMS=cpu
asks for a CPU run.  The chain is the public one (build_chain), fused
(fuse.py), in planar execution (planar.py), timed on the fused
mix+FIR+decim kernel (kernel_fuse) where the platform takes it and on
XLA's schedule of the same chain.  Blocks are chained through the carry;
each timing window ends in block_until_ready.

Prints the device on one line, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "Msamples/s", "vs_baseline": N,
   "device": {...}, "variants": {...}}

vs_baseline: ratio against the reference C library's throughput for the
same chain measured on a host CPU (tests/baseline_measured.json), a
context column only.
"""
import json
import os
import pathlib
import sys
import time


sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))


def timed_throughput(run_trials, samples_per_trial, max_trials=4096):
    """Two-point calibrated throughput (samples/s).

    run_trials(n) must execute n chained trials and wait for the last
    result.  Throughput is computed from dt(2n) - dt(n), which cancels
    the fixed per-batch overhead (dispatch, the final wait)."""
    n = 1
    dt1 = run_trials(n)
    while dt1 < 0.5 and n < max_trials:
        n = min(2 * n, max_trials)
        dt1 = run_trials(n)
    dt2 = run_trials(2 * n)
    if dt2 - dt1 > 0.25 * dt1:
        return samples_per_trial * n / (dt2 - dt1)
    # overhead-dominated even at 2n: report the conservative ratio
    return samples_per_trial * 2 * n / dt2


def build_chain(fused: bool = True):
    """The headline chain (BASELINE.json): mix -> 64-tap Kaiser FIR ->
    57-tap Kaiser FIR -> halfband resampler.  The FIR formulation is the
    platform policy's (platform.py).  fused=True collapses the LTI run
    into ONE 144-tap strided FIR (fuse.py): each cascade stage otherwise
    re-streams the block through memory."""
    from liquid_dsp_tpu import chain, fuse
    from liquid_dsp_tpu.design.firdes import firdes_kaiser
    from liquid_dsp_tpu.ops.fir import firfilt
    from liquid_dsp_tpu.ops.nco import nco
    from liquid_dsp_tpu.ops.resample import msresamp

    proc = chain(nco(dphi=0.125, direction="down"),
                 firfilt(firdes_kaiser(64, 0.2, 60.0)),
                 firfilt(firdes_kaiser(57, 0.3, 60.0)),
                 msresamp(0.5, 60.0))
    return fuse(proc) if fused else proc


def measure(proc, batch, T, in_dtype=None, blocks=16):
    """Msamples/s of a planar Proc over chained blocks of random planes."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(0)
    xr = jax.random.normal(key, (batch, T), jnp.float32)
    xi = jax.random.normal(jax.random.fold_in(key, 1), (batch, T),
                           jnp.float32)
    if in_dtype is not None:
        xr, xi = xr.astype(in_dtype), xi.astype(in_dtype)
    step = jax.jit(lambda c, r, i: proc.apply(proc.params, c, (r, i)))
    carry = jax.jit(lambda: proc.init(batch_shape=(batch,)))()

    def run_trials(n):
        t0 = time.perf_counter()
        c, y = carry, None
        for _ in range(n):
            y, c = step(c, xr, xi)
        jax.block_until_ready((y, c))
        return time.perf_counter() - t0

    run_trials(1)                     # compile + warm
    return timed_throughput(run_trials, batch * T, max_trials=blocks) / 1e6


def main() -> int:
    import jax
    from liquid_dsp_tpu import kernel_fuse, planar
    from liquid_dsp_tpu.platform import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    cpu_asked = os.environ.get("JAX_PLATFORMS", "").startswith("cpu")
    if dev.platform != "gpu" and not cpu_asked:
        print(f"bench.py: no GPU (JAX found {dev.platform}); set "
              "JAX_PLATFORMS=cpu for a CPU run", file=sys.stderr)
        return 2
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device}", flush=True)

    batch, T = 64, 1 << 18
    fused = build_chain()
    variants = {"xla": measure(planar(fused), batch, T)}
    kproc = kernel_fuse(fused)
    if kproc is not fused:
        variants["kernel"] = measure(planar(kproc), batch, T)
        # bfloat16 input planes: a different precision contract (exact
        # only for 8-bit IQ captures), reported beside the headline
        variants["kernel-bf16-in"] = measure(
            planar(kproc), batch, T, in_dtype=jax.numpy.bfloat16)
    headline = variants.get("kernel", variants["xla"])

    baseline_file = (pathlib.Path(__file__).parent /
                     "tests/baseline_measured.json")
    vs = 0.0
    if baseline_file.exists():
        ref_msps = json.loads(baseline_file.read_text()).get(
            "fir_fft_chain_msps_cpu", 0.0)
        if ref_msps > 0:
            vs = headline / ref_msps
    print(json.dumps({
        "metric": "complex Msamples/s (mix+FIR64+FIR57+msresamp chain, "
                  f"{batch}x{T} per block)",
        "value": round(headline, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(vs, 3),
        "device": device,
        "variants": {k: round(v, 2) for k, v in variants.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
