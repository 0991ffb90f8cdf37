#!/usr/bin/env python
"""Time both sides of each main-path entry of the platform policy
(liquid_dsp_tpu/platform.py) on the running GPU, at the headline widths
(64 channels x 262,144 complex samples):

  fir_banded_matmul   firfilt(64 taps) and the fused 144-tap /2 chain:
                      banded matmul vs XLA convolution
  fftfilt_nfft_floor  fftfilt(57 taps) at nfft floors 2048..32768
  firinterp_banded    firinterp(k=2, 29 taps): one band vs k convs
  resamp_banded       resamp(3/2): banded matmul vs per-class convs

The codebook and chain-kernel entries are timed end to end by
chip_smoke.py and tools/bench_kernels.py.

    python tools/bench_policy.py

Prints one line per case and writes chiprun_out/bench_policy.json.
"""
import json
import pathlib
import sys
import time


REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SHAPE = (64, 1 << 18)       # channels x samples per block


def _time(fn, n=10):
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def _msps(make, x, entry, value):
    """Msamples/s of make()'s Proc on x with POLICY[entry] = value."""
    import jax
    from liquid_dsp_tpu.platform import POLICY
    saved = POLICY[entry]["gpu"]
    POLICY[entry]["gpu"] = value
    try:
        p = make()
        c = p.init(batch_shape=x.shape[:-1])
        # x and the carry are jit ARGUMENTS: closed-over device arrays
        # would be constant-folded into the program
        f = jax.jit(lambda c_, x_: p.apply(p.params, c_, x_)[0])
        return x.size / _time(lambda: f(c, x)) / 1e6
    finally:
        POLICY[entry]["gpu"] = saved


def main():
    import jax
    import jax.numpy as jnp
    from bench import build_chain
    from liquid_dsp_tpu import planar
    from liquid_dsp_tpu.design.firdes import firdes_kaiser
    from liquid_dsp_tpu.ops.fftfilt import fftfilt
    from liquid_dsp_tpu.ops.fir import firfilt, firinterp
    from liquid_dsp_tpu.ops.resample import resamp
    from liquid_dsp_tpu.platform import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("bench_policy.py needs the GPU", file=sys.stderr)
        return 2
    B, T = SHAPE
    key = jax.random.PRNGKey(0)
    x = jax.lax.complex(jax.random.normal(key, (B, T)),
                        jax.random.normal(jax.random.fold_in(key, 1),
                                          (B, T)))
    h64 = firdes_kaiser(64, 0.2, 60.0)
    h57 = firdes_kaiser(57, 0.3, 60.0)
    h29 = firdes_kaiser(29, 0.2, 60.0)
    rec = {"device_kind": dev.device_kind, "B": B, "T": T, "cases": []}

    def row(entry, case, value, msps):
        r = {"entry": entry, "case": case, "value": value,
             "msps": round(msps, 1)}
        rec["cases"].append(r)
        print(json.dumps(r), flush=True)

    for v in (True, False):
        row("fir_banded_matmul", "firfilt 64 taps", v,
            _msps(lambda: firfilt(h64), x, "fir_banded_matmul", v))
    for v in (True, False):
        # the fused headline chain in planar form: its 144-tap /2 stage
        # takes the same entry
        from liquid_dsp_tpu.platform import POLICY
        saved = POLICY["fir_banded_matmul"]["gpu"]
        POLICY["fir_banded_matmul"]["gpu"] = v
        try:
            p = planar(build_chain())
            c = p.init(batch_shape=(B,))
            xr, xi = jnp.real(x), jnp.imag(x)
            f = jax.jit(lambda c_, r, i: p.apply(p.params, c_, (r, i))[0])
            row("fir_banded_matmul", "fused chain planar (XLA)", v,
                B * T / _time(lambda: f(c, xr, xi)) / 1e6)
        finally:
            POLICY["fir_banded_matmul"]["gpu"] = saved
    for v in (2048, 4096, 8192, 16384, 32768):
        row("fftfilt_nfft_floor", "fftfilt 57 taps", v,
            _msps(lambda: fftfilt(h57), x, "fftfilt_nfft_floor", v))
    for v in (True, False):
        row("firinterp_banded", "firinterp k=2, 29 taps", v,
            _msps(lambda: firinterp(2, h29), x, "firinterp_banded", v))
    for v in (True, False):
        row("resamp_banded", "resamp 3/2", v,
            _msps(lambda: resamp(1.5), x, "resamp_banded", v))
    outdir = REPO / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "bench_policy.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
