"""GPU kernel (Pallas, Triton route): fused codebook correlation + argmax
soft decode.

The device block-FEC decoder scores every candidate codeword against the
received soft bits (max-log ML: scores = cw @ codebook, argmax — the
reference decodes per byte on the CPU, fec_golay2412.c).  The XLA
formulation writes the scores tensor [..., ncw, 2^k] to device memory
and reads it back for the argmax: 16 KB of score traffic per 12 decoded
bits for Golay(24,12), since XLA does not fuse a row argmax into a GEMM.

This kernel keeps the scores on the SM: each program takes `tm`
codewords, loops over the codebook in `tk`-column chunks, runs the
[tm, n] x [n, tk] product on `pl.dot` at float32 (FMAs; the
tensor-core passes tf32x3 and bf16x6 were faster on the card but
changed a decision on 1 of 2^20 random codewords, PERF.md), and keeps
a running max and first-index argmax in registers.  Device memory sees the soft bits in (n floats per codeword)
and one int32 out.  n is padded to 32, the dot's minimum width.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["codebook_argmax"]

NP = 32       # codeword length padded to the dot's minimum


def _kernel(cw_ref, bip_ref, idx_ref, *, M, n, tm, tk, nk):
    rows = pl.program_id(0) * tm + jnp.arange(tm, dtype=jnp.int32)
    ok = rows < M
    cols = jnp.arange(NP, dtype=jnp.int32)
    a = plgpu.load(
        cw_ref.at[jnp.broadcast_to(jnp.clip(rows, 0, M - 1)[:, None],
                                   (tm, NP)),
                  jnp.broadcast_to(jnp.clip(cols, 0, n - 1)[None, :],
                                   (tm, NP))],
        mask=ok[:, None] & (cols < n)[None, :], other=0.0)

    def body(k, carry):
        best, arg = carry
        b = plgpu.load(bip_ref.at[:, pl.ds(k * tk, tk)])     # [NP, tk]
        s = pl.dot(a, b, allow_tf32=False)                   # [tm, tk]
        m = jnp.max(s, axis=1)
        am = jnp.argmax(s, axis=1).astype(jnp.int32) + k * tk
        upd = m > best              # strict: earlier chunks win ties
        return jnp.where(upd, m, best), jnp.where(upd, am, arg)

    init = (jnp.full((tm,), -jnp.inf, jnp.float32),
            jnp.zeros((tm,), jnp.int32))
    _, arg = lax.fori_loop(0, nk, body, init)
    plgpu.store(idx_ref.at[rows], arg, mask=ok)


@functools.partial(jax.jit, static_argnames=(
    "tm", "tk", "num_warps", "num_stages", "interpret"))
def _call(cwf, bip, *, tm, tk, num_warps, num_stages, interpret):
    M, n = cwf.shape
    K = bip.shape[1]
    kern = functools.partial(_kernel, M=M, n=n, tm=tm, tk=tk, nk=K // tk)
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((M,), jnp.int32),
        grid=(pl.cdiv(M, tm),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="codebook_argmax",
    )(cwf, bip)


def codebook_argmax(cw, bip, *, tm=128, tk=32, num_warps=4, num_stages=1,
                    interpret: bool = False):
    """argmax(cw @ bip, axis=-1) without writing the scores to memory.

    cw: [..., ncw, n] float32 soft bits (n <= 32); bip: [n, K] +-1
    codebook, a host numpy array (K = 2^k candidates, a multiple of tk).
    Returns [..., ncw] int32: the einsum+argmax result (float32 scores,
    first index on ties).  The rest is tiling (the defaults are the
    fastest of the sweep in tools/bench_kernels.py on an H100).
    """
    bip = np.asarray(bip, np.float32)
    n, K = bip.shape
    if n > NP or K % tk:
        raise ValueError(f"codebook [{n}, {K}] does not fit the kernel")
    bip_p = np.zeros((NP, K), np.float32)
    bip_p[:n] = bip
    cw = jnp.asarray(cw, jnp.float32)
    lead = cw.shape[:-1]
    M = int(np.prod(lead)) if lead else 1
    idx = _call(cw.reshape(M, n), jnp.asarray(bip_p), tm=tm, tk=tk,
                num_warps=num_warps, num_stages=num_stages,
                interpret=interpret)
    return idx.reshape(lead)
