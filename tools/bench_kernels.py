#!/usr/bin/env python
"""Time the two GPU kernels against the plain versions XLA compiles, at
the main-path widths, and sweep their tiling.

  * chain: the fused mix+FIR+decim kernel (ops/kernels/pallas_chain.py)
    over a grid of tilings, against the
    XLA planar fused chain (its banded matmul at HIGHEST, and at bf16x3
    for a like-for-like precision) and the plain-JAX reference, on
    64 x 262,144 blocks of the headline chain;
  * codebook: the fused matmul+argmax kernel against the HIGHEST
    einsum+argmax on 2^20 Golay codewords, over tiling.

    python tools/bench_kernels.py [--quick]

Needs the GPU.  Prints one line per variant (time, rate, worst error vs
the plain reference) and writes chiprun_out/bench_kernels.json.
"""
import json
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SHAPE = (64, 1 << 18)       # channels x samples per block
CODEWORDS = 1 << 20


def _time(fn, n=10):
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def chain_variants(quick):
    """(rb, ns, num_warps, num_stages) tilings to time."""
    base = [(16, 2, 4, 1), (16, 2, 4, 2)]
    if quick:
        return base
    return base + [(8, 2, 4, 1), (16, 1, 4, 1), (32, 2, 4, 1),
                   (16, 4, 4, 1), (16, 2, 8, 1), (8, 4, 4, 1),
                   (32, 1, 4, 1), (16, 2, 2, 1), (32, 2, 8, 1),
                   (64, 1, 8, 1)]


def bench_chain(rec, quick):
    import jax
    import jax.numpy as jnp
    from bench import build_chain
    from liquid_dsp_tpu import planar
    from liquid_dsp_tpu.fuse import _kernel_plan
    from liquid_dsp_tpu.ops.kernels.pallas_chain import (
        mix_fir_decim, mix_fir_decim_reference)

    B, T = SHAPE
    key = jax.random.PRNGKey(0)
    xr = jax.random.normal(key, (B, T), jnp.float32) * np.float32(0.7071)
    xi = jax.random.normal(jax.random.fold_in(key, 1), (B, T),
                           jnp.float32) * np.float32(0.7071)
    fused = build_chain()
    h, down, step, sgn, _ = _kernel_plan(fused)
    z = jnp.zeros((B, len(h) - 1), jnp.float32)
    th = jnp.float32(0.3)
    kw = dict(down=down, sgn=sgn, step=step)
    # inputs are jit ARGUMENTS: closed-over device arrays would be
    # constant-folded into the program
    refj = jax.jit(lambda r, i: mix_fir_decim_reference(r, i, z, z, th, h,
                                                        **kw))
    y_ref = refj(xr, xi)
    p = planar(fused)
    c0 = p.init(batch_shape=(B,))
    xlaj = jax.jit(lambda c, r, i: p.apply(p.params, c, (r, i))[0])
    out = {"xla_chain_ms": _time(lambda: xlaj(c0, xr, xi)) * 1e3,
           "reference_ms": _time(lambda: refj(xr, xi)) * 1e3,
           "variants": []}
    # the same XLA chain with the banded matmul at bf16x3 instead of
    # HIGHEST: the shared skeleton reads lax.Precision.HIGHEST from
    # ops/fir.py's `lax`, swapped here for this one measurement
    import types
    from jax import lax
    import liquid_dsp_tpu.ops.fir as firmod
    prec3 = types.SimpleNamespace(
        HIGHEST=lax.DotAlgorithmPreset.BF16_BF16_F32_X3)
    firmod.lax = types.SimpleNamespace(**{
        **{k: getattr(lax, k) for k in dir(lax) if not k.startswith("_")},
        "Precision": prec3})
    try:
        xla3 = jax.jit(lambda c, r, i: p.apply(p.params, c, (r, i))[0])
        y3 = xla3(c0, xr, xi)
        out["xla_chain_bf16x3_ms"] = _time(lambda: xla3(c0, xr, xi)) * 1e3
    finally:
        firmod.lax = lax
    y1 = xlaj(c0, xr, xi)
    out["xla_bf16x3_vs_highest_err"] = max(
        float(jnp.max(jnp.abs(a - b))) for a, b in zip(y3, y1))
    print(f"chain xla planar fused, banded matmul at bf16x3: "
          f"{out['xla_chain_bf16x3_ms']:.3f} ms (vs HIGHEST: worst |err| "
          f"{out['xla_bf16x3_vs_highest_err']:.2e})", flush=True)
    print(f"chain xla planar fused: {out['xla_chain_ms']:.3f} ms "
          f"({B * T / out['xla_chain_ms'] / 1e3:.1f} Msps); plain "
          f"reference {out['reference_ms']:.3f} ms", flush=True)
    # like-for-like, in turns: the default kernel, XLA's chain at
    # HIGHEST, XLA's chain with the banded matmul at bf16x3
    kern = jax.jit(lambda r, i: mix_fir_decim(r, i, z, z, th, h, **kw))
    turns = {"kernel": lambda: kern(xr, xi),
             "xla_highest": lambda: xlaj(c0, xr, xi),
             "xla_bf16x3": lambda: xla3(c0, xr, xi)}
    rounds = {k: [] for k in turns}
    for rnd in range(5):
        order = list(turns)[rnd % 3:] + list(turns)[:rnd % 3]
        for k in order:
            rounds[k].append(_time(turns[k]) * 1e3)
    out["turns_ms"] = rounds
    print("chain in turns (ms per block): " + ", ".join(
        f"{k} median {np.median(v):.3f} {['%.3f' % t for t in v]}"
        for k, v in rounds.items()), flush=True)
    for rb, ns, nw, nst in chain_variants(quick):
        tiling = dict(rb=rb, ns=ns, num_warps=nw, num_stages=nst)
        try:
            fj = jax.jit(lambda r, i, t=tiling: mix_fir_decim(
                r, i, z, z, th, h, **kw, **t))
            y = fj(xr, xi)
            err = max(float(jnp.max(jnp.abs(a - b)))
                      for a, b in zip(y, y_ref))
            ms = _time(lambda: fj(xr, xi)) * 1e3
            row = {**tiling, "ms": ms, "msps": B * T / ms / 1e3,
                   "worst_err": err}
        except Exception as e:                       # noqa: BLE001
            # a tiling the compiler refuses is a result of the sweep
            row = {**tiling, "error": f"{type(e).__name__}: {str(e)[:300]}"}
        out["variants"].append(row)
        print("chain kernel", json.dumps(row), flush=True)
    rec["chain"] = out


def bench_codebook(rec, quick):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from liquid_dsp_tpu.fec.device import block_codebook
    from liquid_dsp_tpu.ops.kernels.pallas_codebook import codebook_argmax

    bip, n, k = block_codebook("golay2412")
    N = CODEWORDS
    cw = jnp.asarray(np.random.default_rng(1).standard_normal(
        (N, n)).astype(np.float32))
    einj = jax.jit(lambda c: jnp.argmax(jnp.einsum(
        "cn,nm->cm", c, jnp.asarray(bip),
        precision=lax.Precision.HIGHEST), axis=-1).astype(jnp.int32))
    want = np.asarray(einj(cw))
    out = {"einsum_ms": _time(lambda: einj(cw)) * 1e3, "variants": []}
    print(f"codebook einsum+argmax HIGHEST: {out['einsum_ms']:.3f} ms "
          f"for {N} codewords", flush=True)
    grid = [(128, 128, 4, 3)] if quick else [
        (128, 128, 4, 3), (128, 64, 4, 3), (128, 128, 8, 3),
        (128, 128, 4, 1), (128, 64, 4, 1), (64, 64, 4, 1),
        (128, 128, 8, 1), (256, 64, 8, 1), (64, 128, 4, 1),
        (128, 32, 4, 1)]
    for tm, tk, nw, nst in grid:
        cfg = {"tm": tm, "tk": tk, "num_warps": nw, "num_stages": nst}
        try:
            fj = jax.jit(lambda c, a=cfg: codebook_argmax(c, bip, **a))
            diff = int((np.asarray(fj(cw)) != want).sum())
            row = {**cfg, "ms": _time(lambda: fj(cw)) * 1e3, "differ": diff}
        except Exception as e:                       # noqa: BLE001
            row = {**cfg, "error": f"{type(e).__name__}: {str(e)[:300]}"}
        out["variants"].append(row)
        print("codebook kernel", json.dumps(row), flush=True)
    rec["codebook"] = out


def main():
    import jax
    from liquid_dsp_tpu.platform import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("bench_kernels.py needs the GPU", file=sys.stderr)
        return 2
    quick = "--quick" in sys.argv
    rec = {"device_kind": dev.device_kind}
    bench_chain(rec, quick)
    bench_codebook(rec, quick)
    outdir = REPO / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "bench_kernels.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
