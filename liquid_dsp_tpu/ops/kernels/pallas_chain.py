"""GPU kernel (Pallas, Triton route): mixer + fused FIR + decimation in
one pass over the input planes.

XLA runs the fused planar headline chain (fuse.py + planar.py) as
separate kernels: the mixed planes and the halo-prefixed stream each go
through device memory between the mixer and the banded matmul.  This
kernel reads each input plane once and writes each output once, about
12 B per complex sample at down=2 (8 in, 4 out).

Grid: (row block, time tile), all programs independent.  Each program
loads its own L-1 sample halo from device memory; only a block's first
tile reads the streaming carry (the last L-1 pre-mix input samples of
the previous block).  The mixer phase of every tile comes from its
program id: the NCO phase is an int32 step of 2^-32 turns (ops/nco.py),
so tile g starts at theta + (g * tile_step mod 2^32) — exact integer
arithmetic with the step wrapped on the host — and the phase inside a
tile is a host-built float64 ramp combined by angle addition.

The filter: per sub-tile of SUB input samples the mixed window
[SUB + L-1] times the band [SUB + L-1, SUB/down] on `pl.dot`, looping
over K in KC-row chunks (only chunks that touch the band).  The dot runs
on the tensor cores as three bf16 passes with float32 accumulation, the
band split into hi + lo bf16 parts on the host (~2^-16 relative: well
inside the chain's 1e-3 contract).  On the card a float32 Triton dot
(CUDA-core FMAs), a 3xTF32 dot and a direct-form FIR (L complex-
modulated taps as FMAs, skipping the band's zeros) were all slower, and
are gone (PERF.md).

`mix_fir_decim_reference` is the plain-JAX statement of the same
arithmetic; the tests hold the kernel (in interpret mode) to it, and the
on-card smoke test holds the compiled kernel to it.  Reference analog:
none — the reference asserts exact filter implementations are
interchangeable (examples/fftfilt_crcf_example.c); the composed-taps
algebra is `fuse.fused_fir`'s.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..nco import RAD_PER_STEP, step_phase

__all__ = ["SUB", "MAX_TAPS", "fold_offset", "make_consts",
           "mix_fir_decim", "mix_fir_decim_reference"]

SUB = 256          # input samples per sub-tile
KC = 64            # K chunk of the band product
MAX_TAPS = SUB + 1
_RAD = np.float32(RAD_PER_STEP)


def fold_offset(h: np.ndarray, d: int) -> np.ndarray:
    """Fold the strided-output offset d into the taps:
    y[i] = sum_j h[j] x[down*i + d - j] = sum_j h'[j] x[down*i - j]."""
    h = np.asarray(h)
    return np.concatenate([h[d:], np.zeros(d, h.dtype)]) if d else h


def _wrap32(v: int) -> int:
    v %= 1 << 32
    return v - (1 << 32) if v >= 1 << 31 else v


def _host_phase(n, step: int) -> np.ndarray:
    """float64 radians of n samples at int32 `step` (exact integer
    wrap, the same phase step_phase gives on device)."""
    n = np.asarray(n, np.int64)
    k = (n * step) % (1 << 32)
    k = np.where(k >= 1 << 31, k - (1 << 32), k)
    return k.astype(np.float64) * (2.0 * np.pi / 2.0 ** 32)


def make_consts(h: np.ndarray, down: int, step: int) -> dict:
    """Host constants of one kernel instance (h already offset-folded):
    the band, the in-sub-tile mixer ramp and the sub-tile phase step."""
    h = np.asarray(h, np.float64)
    L = len(h)
    C = L - 1
    if L > MAX_TAPS:
        raise ValueError(f"taps too long for the kernel: {L}")
    if SUB % down:
        raise ValueError(f"decimation {down} does not divide {SUB}")
    so = SUB // down
    nk = -(-(SUB + C) // KC)
    m = np.arange(nk * KC)[:, None]
    j = down * np.arange(so)[None, :] + C - m
    band = np.where((j >= 0) & (j < L), h[np.clip(j, 0, L - 1)], 0.0)
    ramp = _host_phase(np.arange(nk * KC) - C, step)
    return {"band": band.astype(np.float32),
            "rc": np.cos(ramp).astype(np.float32),
            "rs": np.sin(ramp).astype(np.float32),
            "row_step": _wrap32(SUB * step)}


def _rotate(cb, sb, rc, rs, sgn):
    """cos/sin of (row phase + ramp) by angle addition, sign folded."""
    c = cb * rc - sb * rs
    s = sb * rc + cb * rs
    return c, (-s if sgn < 0 else s)


def _load_window(x_ref, c_ref, b, t, row_ok, T, C):
    """x[b, t] for t in [0, T), the carry for t in [-C, 0), else 0."""
    shape = jnp.broadcast_shapes(b.shape, t.shape)
    b, t = jnp.broadcast_to(b, shape), jnp.broadcast_to(t, shape)
    xv = plgpu.load(x_ref.at[b, jnp.clip(t, 0, T - 1)],
                    mask=row_ok & (t >= 0) & (t < T), other=0.0)
    cv = plgpu.load(c_ref.at[b, jnp.clip(t + C, 0, C - 1)],
                    mask=row_ok & (t < 0) & (t >= -C), other=0.0)
    return jnp.where(t < 0, cv, xv.astype(jnp.float32))


def _dot_bf16x3(a, b_hi, b_lo):
    """a @ b in three bf16 tensor-core passes with float32 accumulation,
    b pre-split on the host into hi + lo bf16 parts (~2^-16 relative)."""
    a_hi = a.astype(jnp.bfloat16)
    a_lo = (a - a_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return (pl.dot(a_lo, b_hi) + pl.dot(a_hi, b_lo)) + pl.dot(a_hi, b_hi)


def _kernel(th_ref, bhi_ref, blo_ref, rc_ref, rs_ref, xr_ref, xi_ref,
            cr_ref, ci_ref, or_ref, oi_ref, *, B, T, C, down, sgn,
            row_step, rb, ns, nk):
    so = SUB // down
    M = rb * ns
    r = jnp.arange(M, dtype=jnp.int32)
    b = pl.program_id(0) * rb + r // ns
    g = pl.program_id(1) * ns + r % ns            # sub-tile index
    row_ok = b < B
    ph = th_ref[0] + (g * row_step).astype(jnp.float32) * _RAD
    cb, sb = jnp.cos(ph)[:, None], jnp.sin(ph)[:, None]
    t0 = g * SUB - C
    bb = b[:, None]

    def body(k, acc):
        ar, ai = acc
        m = k * KC + jnp.arange(KC, dtype=jnp.int32)
        t = t0[:, None] + m[None, :]
        ok = row_ok[:, None]
        wr = _load_window(xr_ref, cr_ref, bb, t, ok, T, C)
        wi = _load_window(xi_ref, ci_ref, bb, t, ok, T, C)
        c, s = _rotate(cb, sb, plgpu.load(rc_ref.at[m])[None, :],
                       plgpu.load(rs_ref.at[m])[None, :], sgn)
        bidx = (m[:, None], jnp.arange(so)[None, :])
        b_hi = plgpu.load(bhi_ref.at[bidx])
        b_lo = plgpu.load(blo_ref.at[bidx])
        return (ar + _dot_bf16x3(wr * c - wi * s, b_hi, b_lo),
                ai + _dot_bf16x3(wr * s + wi * c, b_hi, b_lo))

    z = jnp.zeros((M, so), jnp.float32)
    yr, yi = lax.fori_loop(0, nk, body, (z, z))
    col = g[:, None] * so + jnp.arange(so, dtype=jnp.int32)[None, :]
    ok = row_ok[:, None] & (col < T // down)
    plgpu.store(or_ref.at[bb, col], yr.astype(or_ref.dtype), mask=ok)
    plgpu.store(oi_ref.at[bb, col], yi.astype(oi_ref.dtype), mask=ok)


def mix_fir_decim(xr, xi, carry_r, carry_i, theta, h, *, down, sgn, step,
                  rb=32, ns=1, num_warps=4, num_stages=1,
                  interpret=False, out_dtype=jnp.float32):
    """One streaming block through the fused kernel.

    xr/xi [B, T] float32 or bfloat16 input planes (bfloat16 halves the
    read traffic and is exact for 8-bit IQ captures: cu8 levels
    k - 127.5 are half-integers that bf16's 8 significand bits hold
    exactly; arithmetic stays float32).  carry_r/i [B, L-1] float32: the
    last L-1 pre-mix samples of the previous block (zeros at stream
    start).  theta: scalar NCO phase at the block's first sample.  h:
    the L >= 2 offset-folded taps, a host numpy array.  step/sgn: the
    NCO's int32 phase step and direction.  The rest is tiling: rb rows
    and ns sub-tiles per program, Triton's warps and pipeline stages
    (the defaults are the fastest of tools/bench_kernels.py's sweep on
    an H100).

    Returns (yr, yi) [B, T//down] out_dtype.  The caller advances theta
    by T samples and keeps the last L-1 input samples as the carry.
    """
    h = np.asarray(h, np.float32)
    T = xr.shape[-1]
    if T % down:
        raise ValueError(f"block length {T} not a multiple of {down}")
    if len(h) < 2:
        raise ValueError("the fused kernel needs at least 2 taps")
    cst = make_consts(h, down, step)
    hi = jnp.asarray(cst["band"]).astype(jnp.bfloat16)
    lo = (jnp.asarray(cst["band"]) - hi.astype(jnp.float32)
          ).astype(jnp.bfloat16)
    consts = (hi, lo, cst["rc"], cst["rs"])
    return _call(jnp.reshape(theta, (1,)).astype(jnp.float32),
                 tuple(jnp.asarray(c) for c in consts), xr, xi,
                 carry_r.astype(jnp.float32), carry_i.astype(jnp.float32),
                 L=len(h), down=down, sgn=sgn, row_step=cst["row_step"],
                 rb=rb, ns=ns, num_warps=num_warps, num_stages=num_stages,
                 interpret=interpret, out_dtype=out_dtype)


@functools.partial(jax.jit, static_argnames=(
    "L", "down", "sgn", "row_step", "rb", "ns", "num_warps", "num_stages",
    "interpret", "out_dtype"))
def _call(th, consts, xr, xi, cr, ci, *, L, down, sgn, row_step, rb, ns,
          num_warps, num_stages, interpret, out_dtype):
    B, T = xr.shape
    out_shape = (jax.ShapeDtypeStruct((B, T // down), out_dtype),) * 2
    kern = functools.partial(
        _kernel, B=B, T=T, C=L - 1, down=down, sgn=sgn, row_step=row_step,
        rb=rb, ns=ns, nk=consts[0].shape[0] // KC)
    return pl.pallas_call(
        kern, out_shape=out_shape,
        grid=(pl.cdiv(B, rb), pl.cdiv(pl.cdiv(T, SUB), ns)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret, name="mix_fir_decim",
    )(th, *consts, xr, xi, cr, ci)


def mix_fir_decim_reference(xr, xi, carry_r, carry_i, theta, h, *, down,
                            sgn, step, out_dtype=jnp.float32):
    """Plain-JAX statement of `mix_fir_decim` (same arguments and
    result): mix the carry-prefixed planes at the NCO phase, then a
    direct-form strided FIR at HIGHEST precision."""
    h = np.asarray(h, np.float32)
    C = len(h) - 1
    T = xr.shape[-1]
    wr = jnp.concatenate([carry_r, xr.astype(jnp.float32)], axis=-1)
    wi = jnp.concatenate([carry_i, xi.astype(jnp.float32)], axis=-1)
    ph = theta + step_phase(jnp.arange(-C, T, dtype=jnp.int32), step)
    c, s = jnp.cos(ph), sgn * jnp.sin(ph)
    mr, mi = wr * c - wi * s, wr * s + wi * c
    # y[o] = sum_j h[j] m[C + down*o - j]
    kern = jnp.asarray(h[::-1].copy())[None, None]

    def fir(m):
        y = lax.conv_general_dilated(
            m.reshape(-1, 1, m.shape[-1]), kern, (down,), "VALID",
            precision=lax.Precision.HIGHEST)
        return y.reshape(m.shape[:-1] + (T // down,)).astype(out_dtype)

    return fir(mr), fir(mi)
