"""LTI chain fusion: collapse adjacent FIR/decimator stages into ONE
strided FIR.

The reference treats a filter cascade as a sequence of opaque objects and
asserts only that exact implementations are interchangeable (reference
examples/fftfilt_crcf_example.c: firfilt == fftfilt).  On an
accelerator the dominant cost of a cascade is device-memory traffic —
each stage streams the whole block through memory again — so the move is
algebraic: adjacent LTI stages

    y[i] = sum_j h[j] * x[down*i + d - j]

compose into a single stage with

    taps' = conv(h1, upsample(h2, down1))
    down' = down1 * down2
    d'    = d1 + down1 * d2

(d' < down' holds inductively when each stage satisfies d < down).  The
fused stage runs as one banded-tap matmul pass (ops/fir.py) at full rate
followed by a strided slice.  Output is the same samples up to fp32
rounding (one accumulation instead of a cascade; relative error ~1e-4).

Stages advertise their LTI description via Proc.lti (core.py); anything
without it (NCO mixers, AGC, nonlinear ops) is left in place and only
maximal LTI runs between them are fused.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from .core import LTI, Proc, chain

__all__ = ["fuse", "fused_fir", "kernel_fuse"]


def _flatten(proc: Proc):
    if proc.children is None:
        return [proc]
    out = []
    for c in proc.children:
        out.extend(_flatten(c))
    return out


def _upsample(h: np.ndarray, k: int) -> np.ndarray:
    if k == 1 or h.shape[-1] == 1:
        return h
    z = np.zeros((h.shape[-1] - 1) * k + 1, dtype=h.dtype)
    z[::k] = h
    return z


def _compose(a: LTI, b: LTI) -> LTI:
    """LTI composition: stage a THEN stage b."""
    ha = np.atleast_1d(np.asarray(a.taps, dtype=np.complex128 if
                                  (np.iscomplexobj(a.taps) or
                                   np.iscomplexobj(b.taps)) else np.float64))
    hb = np.atleast_1d(np.asarray(b.taps, dtype=ha.dtype))
    taps = np.convolve(ha, _upsample(hb, a.down))
    return LTI(taps=taps, down=a.down * b.down, d=a.d + a.down * b.d)


def fused_fir(meta: LTI, name: str = "fused_fir") -> Proc:
    """A Proc computing ``y[i] = sum_j taps[j] x[down*i + d - j]`` as one
    pass: banded-tap matmul at full rate + strided slice on accelerators
    (the slice is free next to the HBM savings of skipping a cascade),
    strided lax.conv on CPU.  Carry: last L-1 raw input samples, so the
    stage time-shards via the standard halo exchange."""
    from .ops.fir import _coerce, _np_taps, fir_apply_matmul
    from .ops.dotprod import conv1d

    h_np = _np_taps(np.asarray(meta.taps))
    down, d = int(meta.down), int(meta.d)
    if d < 0 or d >= down:
        raise ValueError(f"fused offset d={d} must satisfy 0 <= d < down")
    L = int(h_np.shape[-1])
    hj = jnp.asarray(h_np)

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (L - 1,), dtype=dtype)

    def _apply_one(h, c, x):
        from .platform import policy
        if policy("fir_banded_matmul"):
            yf, c2 = fir_apply_matmul(h, c, x, tile=256)
            y = yf[..., d::down] if (down > 1 or d) else yf
            return y, c2
        xp = jnp.concatenate([c, x], axis=-1) if L > 1 else x
        c2 = xp[..., xp.shape[-1] - (L - 1):] if L > 1 else c
        y = conv1d(xp[..., d:] if d else xp, h, stride=down)
        return y, c2

    def apply(params, carry, x):
        return _apply_one(params["h"], _coerce(carry, x.dtype), x)

    planar_apply = planar_init = None
    if not np.iscomplexobj(h_np):
        # real taps filter each plane independently: two unit-stride
        # float passes instead of one interleaved complex pass (planar.py)
        def planar_init(batch_shape=(), dtype=jnp.float32):
            z = jnp.zeros(batch_shape + (L - 1,), dtype)
            return (z, z)

        def planar_apply(params, carry, x):
            h = params["h"]
            (r, i), (cr, ci) = x, carry
            yr, cr2 = _apply_one(h, cr.astype(r.dtype), r)
            yi, ci2 = _apply_one(h, ci.astype(i.dtype), i)
            return (yr, yi), (cr2, ci2)

    return Proc(params={"h": hj}, init=init, apply=apply, rate=(1, down),
                name=name, halo=L - 1, lti=LTI(h_np, down, d),
                planar_apply=planar_apply, planar_init=planar_init)


def kernel_fuse(proc: Proc, out_dtype=None) -> Proc:
    """Collapse a (mixer -> fused-FIR) pair into ONE fused GPU kernel.

    Pattern-matches a chain whose flattened stages are exactly
    [nco (VCO mode, scalar phase), LTI stage (real taps, 2 <= L <= 257)]
    — the shape `fuse()` leaves the headline chain in — and returns a
    Proc whose planar path runs mixer + FIR + decimation in one pass
    (ops/kernels/pallas_chain.py: each input plane read once, each
    output written once).  Anything that doesn't match, and any platform
    whose policy takes no kernel (platform.py "chain_kernel"), gets the
    chain back unchanged, so `kernel_fuse(fuse(p))` is always safe.

    ``out_dtype`` controls output narrowing — an EXPLICIT opt-in,
    decoupled from the lossless narrow-read optimization (bf16 input
    planes are exact for 8-bit IQ captures; a bf16 WRITE quantizes the
    result ~-48 dB): None (default) emits float32 regardless of input
    dtype; ``"input"`` follows the input planes' dtype (narrow
    end-to-end pipelines); an explicit dtype forces that.  Arithmetic
    and the carry are float32 in all cases.

    Constraints at run time: batch_shape of rank 1 (or scalar), block
    length a multiple of the decimation, phase shared across the
    batch."""
    from .platform import policy
    plan = _kernel_plan(proc)
    if plan is None or not policy("chain_kernel"):
        return proc
    return _kernel_proc(proc.name, plan, out_dtype)


def _kernel_plan(proc: Proc):
    """(h, down, step, sgn, theta0) when `proc` is [nco, real LTI]."""
    from .ops.kernels.pallas_chain import MAX_TAPS, fold_offset
    stages = _flatten(proc)
    if len(stages) != 2:
        return None
    mix, fir = stages
    m = mix.meta or {}
    if (m.get("kind") != "nco" or m.get("table") or fir.lti is None
            or np.iscomplexobj(fir.lti.taps)):
        return None
    L = np.atleast_1d(fir.lti.taps).shape[-1]
    if not 2 <= L <= MAX_TAPS:
        return None
    h = fold_offset(np.asarray(fir.lti.taps, np.float32), fir.lti.d)
    return h, int(fir.lti.down), int(m["step"]), float(m["sgn"]), \
        float(m["theta0"])


def _kernel_proc(name: str, plan, out_dtype=None,
                 interpret: bool = False) -> Proc:
    """The fused-kernel Proc for a `_kernel_plan` (tests pass
    interpret=True to run the kernel on the CPU)."""
    from .ops.kernels.pallas_chain import mix_fir_decim
    from .ops.nco import _wrap, step_phase
    h, down, step, sgn, theta0 = plan
    C = len(h) - 1

    def planar_init(batch_shape=(), dtype=jnp.float32):
        if len(batch_shape) > 1:
            raise ValueError("kernel_fuse supports rank<=1 batch shapes")
        B = batch_shape[0] if batch_shape else 1
        z = jnp.zeros((B, C), jnp.float32)
        return {"tr": z, "ti": z, "theta": jnp.float32(theta0)}

    def planar_apply(params, carry, x):
        r, i = x
        flat = r.ndim == 1
        if flat:
            r, i = r[None], i[None]
        od = (r.dtype if out_dtype == "input"
              else jnp.float32 if out_dtype is None else out_dtype)
        yr, yi = mix_fir_decim(
            r, i, carry["tr"], carry["ti"], carry["theta"], h, down=down,
            sgn=sgn, step=step, interpret=interpret, out_dtype=od)

        def tail(c, v):          # last C pre-mix samples, c | v
            v = v.astype(jnp.float32)
            if v.shape[-1] >= C:
                return v[:, v.shape[-1] - C:]
            return jnp.concatenate([c, v], axis=-1)[:, -C:]

        new_carry = {"tr": tail(carry["tr"], r), "ti": tail(carry["ti"], i),
                     "theta": _wrap(carry["theta"] +
                                    step_phase(r.shape[-1], step))}
        if flat:
            yr, yi = yr[0], yi[0]
        return (yr, yi), new_carry

    def init(batch_shape=(), dtype=jnp.complex64):
        return planar_init(batch_shape=batch_shape)

    def apply(params, carry, x):
        (yr, yi), c2 = planar_apply(
            params, carry, (jnp.real(x), jnp.imag(x)))
        return lax.complex(yr, yi), c2

    return Proc(params=(), init=init, apply=apply, rate=(1, down),
                name=name + "_kernel", halo=C,
                planar_apply=planar_apply, planar_init=planar_init)


def fuse(proc: Proc, min_run: int = 2) -> Proc:
    """Return an equivalent Proc with maximal runs of adjacent LTI stages
    collapsed into single strided FIRs.

    Nested chains are flattened first (composition is associative); the
    returned Proc has a FRESH carry structure — fuse before `init`, not
    mid-stream.  Stages without `Proc.lti` are kept verbatim.  A run
    shorter than `min_run` is left alone (nothing to gain)."""
    stages = _flatten(proc)
    if not any(s.lti is not None for s in stages):
        return proc
    out = []
    run = []

    def close_run():
        if len(run) >= min_run:
            meta = run[0].lti
            for s in run[1:]:
                meta = _compose(meta, s.lti)
            out.append(fused_fir(
                meta, name="fused(" + "+".join(s.name for s in run) + ")"))
        else:
            out.extend(run)
        run.clear()

    for s in stages:
        if s.lti is not None and np.asarray(s.lti.taps).ndim == 1:
            run.append(s)
        else:
            close_run()
            out.append(s)
    close_run()
    if len(out) == 1:
        return out[0]
    return chain(*out, name=proc.name + "_fused")
