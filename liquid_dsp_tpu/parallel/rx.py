"""Time-sharded streaming receiver: the SURVEY §2.12 sequence-parallel
axis applied to a detect-everywhere framer (the one genuinely hard
sharding design in this framework; reference analog:
framesync64.c:241-269, whose state machine is single-threaded
per-sample and cannot split the time axis at all).

Design (single-device semantics in framing/stream_rx.py): the global
block [T] splits into n contiguous shards of T_local.  Each shard runs
the SAME detect-everywhere pipeline on a local buffer whose history is
the (hist + Lb)-sample tail of its LEFT time-neighbor — one ppermute
hop.  The Lb extra samples back the matched-filter front pad with REAL
data mid-stream; shard 0 keeps the single-device zero-pad-at-stream-
head semantics and consumes the inter-block carry.

  * emission ownership: each shard's emit window is its local
    [0, T_local) buffer positions; the windows tile absolute time, so
    every frame decodes on exactly ONE shard — a frame STRADDLING a
    shard boundary belongs to the shard whose emit window holds its
    first sample, and that shard's history + lookahead covers the full
    frame span (window length <= hist + 1, the same bound the
    single-device receiver needs for block-tip frames).
  * detection determinism: the segment grid is absolute-aligned
    (T_local % hop == 0); the boundary local-peak comparison uses the
    left neighbor's last owned segment peak, which each shard computes
    from its OWN halo samples (_seg_peak_at — same matmul row on the
    same floats) and ppermutes one scalar right.
  * suppression watermark: the greedy in-order fold runs over the
    all-gathered GLOBAL (cand, n0) sequence — tens of bools — so keeps
    and the next-block watermark replicate exactly as on one device.

Halo bytes per block step and shard: (hist + Lb) * 8 B samples + one
f32 + ~2 * n_seg words gathered — frame64 (hist 1536, Lb 25): ~12.5 KB
per shard-step, i.e. 38% of a T_local = 4096 shard payload (32 KB),
19% at 8192, 4.8% at 32768 — so time-sharding wants long per-shard
blocks; the exchange is one nearest-neighbor hop plus a tiny
all-gather.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..framing.stream_rx import (
    StreamRxConfig, StreamRxBlock, _rx_consts, _rx_sync_block,
    _detect_refine, _advance_watermark, _seg_peak_at, STREAM_HIST,
    _DET_HOP)

__all__ = ["preamble_stream_time_sharded", "framesync64_time_sharded"]


def preamble_stream_time_sharded(block_len: int, cfg: StreamRxConfig,
                                 mesh: Mesh, time_axis: str = "t",
                                 threshold: float = 0.5,
                                 max_frames_per_shard: int = 4,
                                 hist: int | None = None):
    """Build (init, step) for the time-sharded preamble-sync receiver.

    step(carry, x[T]) -> (StreamRxBlock with n_shards*P candidate
    slots, carry'); x is 1-D with its axis sharded over `time_axis`;
    the carry is replicated.  Decodes the same frames as
    preamble_stream(block_len, ...) on one device (slot LAYOUT differs:
    per-shard slot groups instead of one global pool — compact on
    `valid`).  Channel batching composes with this via channel-axis DP
    on a second mesh axis (vmap outside); kept 1-D here because the
    halo logic is per-stream.
    """
    n = int(mesh.shape[time_axis])
    T = int(block_len)
    if T % n:
        raise ValueError("block_len must divide by the mesh time axis")
    Tl = T // n
    if Tl % _DET_HOP:
        raise ValueError(
            f"per-shard block must be a multiple of {_DET_HOP}")
    Pc = int(max_frames_per_shard)
    if hist is None:
        hist = STREAM_HIST
    hist = -(-int(hist) // _DET_HOP) * _DET_HOP
    # same build-time validation preamble_stream enforces: a too-short
    # history silently zero-pads frame tails near each shard's emit tip
    from ..framing.stream_rx import _DET_NFFT
    n_sym_tot = cfg.region_start + cfg.region_len
    if hist < cfg.k * n_sym_tot + 2 or hist < _DET_NFFT:
        raise ValueError("history window too short for this frame region")
    R = _rx_consts(Tl, cfg, Pc, hist)
    halo = hist + R["Lb"]
    if Tl < halo:
        raise ValueError(
            f"per-shard block {Tl} shorter than the history halo {halo};"
            " use a longer block or fewer time shards")

    def init(dtype=jnp.complex64):
        return {"buf": jnp.zeros((hist,), jnp.complex64),
                "base": jnp.full((), -hist, jnp.int32),
                "last_end": jnp.full((), -(1 << 30), jnp.int32)}

    def _local(carry, x_local):
        idx = lax.axis_index(time_axis)
        perm = [(i, (i + 1) % n) for i in range(n)]
        tail = x_local[..., Tl - halo:].astype(jnp.complex64)
        left = lax.ppermute(tail, time_axis, perm)
        hist_in = jnp.where(idx == 0, carry["buf"], left[..., R["Lb"]:])
        ext = jnp.where(idx == 0, jnp.zeros_like(left[..., :R["Lb"]]),
                        left[..., :R["Lb"]])
        left_ext = jnp.stack([jnp.real(ext), jnp.imag(ext)])
        buf = jnp.concatenate([hist_in, x_local.astype(jnp.complex64)],
                              axis=-1)                     # [hist+Tl]

        # left neighbor's last owned segment peak: its samples are the
        # local buffer positions [Tl - hop, Tl - hop + NFFT) of the
        # NEIGHBOR, which equal THIS shard's buffer positions
        # [hist - hop, ...) via the halo — so each shard computes its
        # own last-owned peak and ppermutes the scalar right
        own_last_pk = _seg_peak_at(buf, R["dc"], Tl - _DET_HOP)
        prev_pk = lax.ppermute(own_last_pk, time_axis, perm)
        prev_pk = jnp.where(idx == 0, -jnp.inf, prev_pk)

        def suppress_fn(last_end, cand, n0_seg, span):
            n0_g = n0_seg + idx * Tl
            allc = lax.all_gather(cand, time_axis)     # [n, n_seg]
            alln = lax.all_gather(n0_g, time_axis)

            def _sup(le, ci):
                c, p = ci
                keep = c & (p >= le)
                return jnp.where(keep, p + span, le), keep

            flat_c = allc.reshape(-1)
            flat_n = alln.reshape(-1)
            _, keeps = lax.scan(_sup, last_end, (flat_c, flat_n),
                                unroll=32)
            # own-shard slice at a traced offset: dynamic_slice, never
            # a traced-index gather (CLAUDE.md)
            own = lax.dynamic_slice(
                keeps.reshape(n, -1), (idx, 0),
                (1, keeps.shape[0] // n))[0]
            return own, keeps, flat_n

        det = _detect_refine(buf, carry["last_end"], R["dc"], threshold,
                             Pc, Tl, R["starts"], R["span"],
                             front_pad=R["Lb"], win_len=R["win_len"],
                             prev_peak=prev_pk, left_ext=left_ext,
                             suppress_fn=suppress_fn)
        out = _rx_sync_block(R, buf, det, carry["base"] + idx * Tl)
        new_carry = {
            # the global block's last hist samples live on the LAST
            # shard; replicate via masked psum (parallel/stream.py)
            "buf": lax.psum(
                jnp.where(idx == n - 1, buf[..., Tl:],
                          jnp.zeros_like(buf[..., Tl:])), time_axis),
            "base": carry["base"] + T,
            "last_end": _advance_watermark(carry, det, R["span"], T),
        }
        return out, new_carry

    out_spec = StreamRxBlock(
        *([P(time_axis)] * len(StreamRxBlock._fields)))

    def step(carry, x):
        sm = shard_map(_local, mesh=mesh,
                       in_specs=(P(), P(time_axis)),
                       out_specs=(out_spec, P()),
                       check_vma=False)
        return sm(carry, x)

    return init, step


def framesync64_time_sharded(block_len: int, mesh: Mesh,
                             time_axis: str = "t",
                             threshold: float = 0.5,
                             max_frames_per_shard: int = 4):
    """Time-sharded streaming frame64 receiver: (init, step) where
    step(carry, x[T]) -> (Frame64Block over n*P slots, carry').  Same
    frames as framesync64_stream on one device; see
    preamble_stream_time_sharded."""
    from ..framing.frame64 import _stream_cfg, Frame64Block, _K
    cfg = _stream_cfg()
    init, core_step = preamble_stream_time_sharded(
        block_len, cfg, mesh, time_axis, threshold, max_frames_per_shard)
    data_idx = np.nonzero(np.arange(630) % 21 != 0)[0].astype(np.int32)

    def step(carry, x):
        out, carry = core_step(carry, x)
        syms = jnp.take(out.region_syms, jnp.asarray(data_idx), axis=-1)
        s2 = np.float32(np.sqrt(0.5))
        near = lax.complex(jnp.sign(syms.real) * s2,
                           jnp.sign(syms.imag) * s2)
        evm = jnp.sqrt(jnp.mean(jnp.abs(syms - near) ** 2, axis=-1))
        evm_db = 20.0 * jnp.log10(evm + 1e-12)
        return Frame64Block(
            valid=out.valid, sample_index=out.sample_index, rxy=out.rxy,
            cfo=out.dphi + out.dphi2 / _K, gamma=out.gamma,
            evm_db=evm_db, symbols=syms), carry

    return init, step
