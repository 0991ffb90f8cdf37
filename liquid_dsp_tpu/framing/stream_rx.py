"""Generic streaming preamble-synchronized receiver core.

All of liquid's single-carrier framers share one receiver skeleton
(reference src/framing/src/framesync64.c:241-269, flexframesync.c: the
detect/rxpreamble/... state machines): find a known interpolated
preamble in an unbounded stream, estimate timing/carrier/gain, matched-
filter at 2 samples/symbol, pilot-sync a fixed region, hand symbols to
byte-domain decoding.  The block re-design here keeps those semantics
(every frame decodes exactly once, in order) with none of the per-sample
state machine: each block is processed by a fully vectorized
detect-everywhere pipeline and the only inter-block state is a fixed
sample-history buffer plus a re-arm watermark.

  * carry: the last `hist` samples + the absolute index of the buffer
    head.  `hist` covers the longest look-back any stage needs, so a
    frame is emitted in the (unique) block whose emit window contains
    its start sample.
  * detection: half-overlapped `nfft`-point FFT segments over the whole
    buffer, cross-correlated against the frequency-domain template for
    2*range_bins+1 carrier-bin hypotheses (identical math to
    qdetector_cccf seek, reference qdetector_cccf.c:373-441).  Each
    buffer position is owned by exactly ONE segment (lags restricted to
    [0, hop)), and the segment grid advances by exactly the block
    length per block, so detection is deterministic across block
    boundaries and no cross-block dedup is needed.
  * emission: candidates whose start position falls in the first T
    buffer positions — a window that advances by T per block and
    therefore tiles absolute time: each frame fires exactly once.
  * decode: up to `max_frames` candidate slots are refined (quadratic
    timing/carrier interpolation), mixed, matched-filtered at the
    per-slot polyphase branch, and pilot-synced as one batched
    computation with static shapes; invalid slots carry a validity
    mask (the fixed max-frames-per-block design from SURVEY.md §7).

Framers build on this: frame64 post-processes the synced region into
payload symbols in the same jit; flexframe uses the region as its
header and gathers the variable-length payload in a second bucketed
stage (see flexframe.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core import Proc

__all__ = ["StreamRxBlock", "StreamRxConfig", "preamble_stream",
           "quad_peak", "mf_symbol_gather", "STREAM_HIST",
           "batched_apply"]

STREAM_HIST = 1536            # history samples carried between blocks
_DET_NFFT = 512               # detection segment size (2*next_pow2(s_len))
_DET_HOP = _DET_NFFT // 2
_RANGE_BINS = 2


def cexp_ramp(dphi, phi, n: int, sign: float = -1.0):
    """(cos, sin) float planes of e^{j*sign*(dphi*t + phi)}, t = 0..n-1,
    batched over the leading axis of dphi/phi [P].

    Factored by angle addition — t = b*C + a with C ~ sqrt(n), so only
    C + ceil(n/C) transcendental pairs are evaluated per candidate
    instead of n (the mix ramps dominated the receiver's elementwise
    time; the same trick as ops/kernels/pallas_chain.py's mix)."""
    C = 1 << max(1, (int(np.ceil(np.sqrt(n))) - 1).bit_length())
    nb = -(-n // C)
    a = np.arange(C, dtype=np.float32)
    b = np.arange(nb, dtype=np.float32) * C
    pa = sign * dphi[:, None] * a[None, :]                    # [P, C]
    pb = sign * (dphi[:, None] * b[None, :] + phi[:, None])   # [P, nb]
    ca, sa = jnp.cos(pa), jnp.sin(pa)
    cb, sb = jnp.cos(pb), jnp.sin(pb)
    cr = cb[:, :, None] * ca[:, None, :] - sb[:, :, None] * sa[:, None, :]
    ci = sb[:, :, None] * ca[:, None, :] + cb[:, :, None] * sa[:, None, :]
    P = dphi.shape[0]
    return (cr.reshape(P, nb * C)[:, :n], ci.reshape(P, nb * C)[:, :n])


def quad_peak(ym1, y0, yp1):
    """Quadratic interpolation of a 3-point peak -> (frac offset, value)."""
    a = 0.5 * (yp1 + ym1) - y0
    b = 0.5 * (yp1 - ym1)
    frac = jnp.where(jnp.abs(a) > 1e-20, -b / (2 * jnp.where(
        jnp.abs(a) > 1e-20, a, 1.0)), 0.0)
    return frac, a * frac * frac + b * frac + y0


class StreamRxConfig(NamedTuple):
    """Static per-framer receiver geometry (numpy-only; closures are
    inlined by XLA; complex constants are kept as float planes)."""
    template: np.ndarray      # interpolated preamble + tail [s_len] c64
    bank: np.ndarray          # polyphase MF bank [npfb, Lb] (branch order)
    region_start: int         # first MF symbol of the pilot region
    region_len: int           # pilot-region length (symbols, incl pilots)
    pilots: np.ndarray        # pilot symbols [npil] c64
    pilot_spacing: int
    pilot_nfft: int           # qpilotsync FFT size for this npil
    suppress_span: int        # samples suppressed after a detection
    k: int = 2                # samples/symbol


class StreamRxBlock(NamedTuple):
    """Per-block batched detection+sync result: leading axis is the
    candidate slot (fixed max_frames); `valid` masks live slots."""
    valid: jnp.ndarray        # [..., P] bool
    sample_index: jnp.ndarray # [..., P] int32, absolute stream index
    rxy: jnp.ndarray          # [..., P] detection correlation
    gamma: jnp.ndarray        # [..., P] channel gain
    dphi: jnp.ndarray         # [..., P] coarse CFO, rad/sample
    phi: jnp.ndarray          # [..., P] carrier phase at frame start
    tau: jnp.ndarray          # [..., P] fractional timing offset
    b_idx: jnp.ndarray        # [..., P] int32 polyphase branch
    off_s: jnp.ndarray        # [..., P] int32 integer sample offset
    dphi2: jnp.ndarray        # [..., P] pilot residual CFO, rad/symbol
    phi2: jnp.ndarray         # [..., P] pilot phase
    g2: jnp.ndarray           # [..., P] pilot gain
    region_syms: jnp.ndarray  # [..., P, region_len] corrected symbols


def mf_symbol_gather(buf, n0, off_s, dphi, phi, gamma, bank, b_idx,
                     n_sym, *, start_sym=0, k=2, win=None):
    """Batched mix + polyphase matched filter + k:1 symbol sampling.

    buf [T?] complex, candidate-batched n0/off_s/dphi/phi/gamma/b_idx
    [P]; returns [P, n_sym] symbols for symbol indices
    [start_sym, start_sym + n_sym) relative to the frame start.  The
    mixer phase is referenced to the template start (sample n0), exactly
    like the one-shot receiver.

    Formulation: per-candidate contiguous `dynamic_slice` spans, mixed
    in place, then a depthwise (feature-grouped) strided convolution —
    one conv call for all candidates, no computed-index gather.  An
    arbitrary [P, n_sym, Lb] `jnp.take` here was the whole receiver's
    bottleneck on the accelerator this was first tuned on (its gathers
    serialized; the conv's internal im2col ran on the matrix unit);
    not measured on H100.
    """
    Lb = int(bank.shape[1])
    span = k * (n_sym - 1) + Lb
    pad = Lb
    # padded-coordinate span start: pad + (n0 - (Lb-1) + off_s +
    # k*start_sym) = n0 + off_s + k*start_sym + 1, i.e. offset
    # off_s + k*start_sym + 1 inside a window whose padded origin is n0
    if win is not None and start_sym == 0:
        # reuse the union window _detect_refine already sliced (its
        # padded origin is n0 with front_pad = Lb): select between the
        # two static sub-spans by the +-1-sample timing offset — no
        # second while-loop extraction (tools/profile_device.py)
        assert win.shape[-1] >= span + 1, "union window too short"
        sel = (off_s == 0)[:, None, None]
        spans2 = jnp.where(sel, win[:, :, 1:span + 1], win[:, :, :span])
        spans = lax.complex(spans2[:, 0], spans2[:, 1])
        t0 = (off_s - (Lb - 1)).astype(jnp.float32)
    else:
        # stand-alone path (e.g. flexframe payload regions at
        # start_sym > 0): pad so the earliest tap (Lb-1 before the
        # first frame sample, off_s can be -1) stays in range —
        # dynamic_slice clamps, and a clamp would silently shift the
        # window; zero padding preserves edge semantics.
        end_pad = k * start_sym + span   # worst case for any n0
        bufp = jnp.concatenate([jnp.zeros(pad, buf.dtype), buf,
                                jnp.zeros(end_pad, buf.dtype)])
        start = pad + n0 + off_s + k * start_sym - (Lb - 1)  # [P]
        # stack the float planes BEFORE slicing: a vmapped
        # dynamic_slice can lower to a sequential loop (one iteration
        # per candidate per plane); slicing [2, span] from the stacked
        # planes halves the loop count
        bufp2 = jnp.stack([jnp.real(bufp), jnp.imag(bufp)])
        spans2 = jax.vmap(
            lambda s: lax.dynamic_slice(bufp2, (0, s), (2, span)))(start)
        spans = lax.complex(spans2[:, 0], spans2[:, 1])
        t0 = (start - pad - n0).astype(jnp.float32)
    # mixer phase over the span, referenced to the template start; the
    # per-candidate start offset folds into the phase term so the ramp
    # is a shared arange (factored transcendentals, see cexp_ramp)
    mr, mi = cexp_ramp(dphi, phi + dphi * t0, span)
    vmix = spans * lax.complex(mr, mi)
    taps = jnp.asarray(bank)[b_idx]                          # [P, Lb]
    dn = ("NCH", "OIH", "NCH")
    P = taps.shape[0]

    # ONE grouped conv for both float planes (planes ride the batch
    # dim) instead of two calls — fewer conv launches per receiver step
    xp2 = jnp.stack([vmix.real, vmix.imag])                  # [2, P, span]
    y2 = lax.conv_general_dilated(
        xp2, taps[:, None, :], window_strides=(k,),
        padding="VALID", dimension_numbers=dn, feature_group_count=P)
    sym = lax.complex(y2[0], y2[1])                          # [P, n_sym]
    return sym * (0.5 / jnp.maximum(gamma, 1e-12))[:, None]


def _detect_consts(template: np.ndarray) -> dict:
    """Numpy constants for the detect-everywhere correlator (float
    planes)."""
    s = template.astype(np.complex64)
    S = np.fft.fft(s, _DET_NFFT)
    offsets = np.arange(-_RANGE_BINS, _RANGE_BINS + 1)
    So_np = np.stack([np.roll(S, off) for off in offsets])
    # banded time-domain correlation matrices for the detect-everywhere
    # stage: column (o, l) holds s_o = s * e^{2j pi off_o n / NFFT}
    # (UNconjugated — the conjugate is applied by the Rr/Ri combination
    # in _detect_refine) at rows l..l+s_len-1, so the frame matmuls
    # compute sum_j x[l+j] conj(s_o[j]) at every lag for every carrier
    # hypothesis — ONE matmul instead of the 5-hypothesis IFFT batch
    n_off = len(offsets)
    n = np.arange(len(s))
    Br = np.zeros((_DET_NFFT, n_off * _DET_HOP), np.float32)
    Bi = np.zeros_like(Br)
    for o, off in enumerate(offsets):
        so = s * np.exp(2j * np.pi * off * n / _DET_NFFT)
        for l in range(_DET_HOP):
            Br[l:l + len(s), o * _DET_HOP + l] = so.real
            Bi[l:l + len(s), o * _DET_HOP + l] = so.imag
    return {
        "So_re": So_np.real.astype(np.float32),
        "So_im": So_np.imag.astype(np.float32),
        "band_re": Br,
        "band_im": Bi,
        "sconj_re": s.conj().real.astype(np.float32),
        "sconj_im": s.conj().imag.astype(np.float32),
        "s_len": len(s),
        "s2_sum": float(np.sum(np.abs(s) ** 2)),
    }


def _detect_refine(buf, last_end, dc: dict, threshold: float, P: int,
                   T: int, starts: np.ndarray, span: int,
                   front_pad: int = 0, win_len: int | None = None,
                   prev_peak=None, left_ext=None, suppress_fn=None):
    """Detect-everywhere + per-candidate refinement over one buffer.

    buf [H+T] complex; last_end: suppression watermark (buffer coords).
    Returns a dict of candidate-batched estimates plus the raw
    (cand, n0_seg) masks the caller folds into its next watermark.
    Identical math to qdetector_cccf seek+align (reference
    qdetector_cccf.c:373-441), batched over segments and candidates.

    front_pad/win_len: when set, ONE [2, win_len] stacked-plane window
    per candidate is sliced starting `front_pad` samples before n0 (zero
    padded), covering both the align window and the matched-filter span
    — the per-candidate dynamic_slice can lower to a sequential loop, so
    each extra loop costs a pass per receiver step; the window is
    returned as "win" for mf_symbol_gather to reuse.

    Time-shard hooks (parallel/rx.py, SURVEY §2.12 sequence
    parallelism): prev_peak substitutes the left neighbor's last owned
    segment peak for the -inf edge in the local-peak test; left_ext
    [2, front_pad] float planes substitute REAL neighbor samples for
    the front zero-pad (shard 0 keeps zeros — the single-device
    semantic at the stream head); suppress_fn(last_end, cand, n0_seg,
    span) -> (keeps, wm_cand, wm_n0) overrides the in-order suppression
    fold so it can run over the all-gathered GLOBAL candidate sequence.
    """
    n_seg = len(starts)
    s_len, s2_sum = dc["s_len"], dc["s2_sum"]
    So = lax.complex(jnp.asarray(dc["So_re"]), jnp.asarray(dc["So_im"]))
    sconj = lax.complex(jnp.asarray(dc["sconj_re"]),
                        jnp.asarray(dc["sconj_im"]))

    # ---- detect everywhere (qdetector seek, batched) ----
    # correlation at every lag for every carrier hypothesis as ONE
    # banded matmul (time domain == the reference's roll(S,off)
    # spectra; linear == circular here since lag + s_len <= NFFT).
    seg_idx = starts[:, None] + np.arange(_DET_NFFT)[None, :]
    segs = buf[jnp.asarray(seg_idx)]                    # [n_seg, NFFT]
    Fr, Fi = segs.real, segs.imag
    Br = jnp.asarray(dc["band_re"])
    Bi = jnp.asarray(dc["band_im"])
    Rr = Fr @ Br + Fi @ Bi                              # [n_seg, n_off*hop]
    Ri = Fi @ Br - Fr @ Bi
    x2 = jnp.sum(Fr ** 2 + Fi ** 2, axis=-1)
    g0 = jnp.sqrt(jnp.maximum(x2, 1e-20) * (s_len / _DET_NFFT))
    g = 1.0 / (g0 * np.sqrt(s2_sum))       # no NFFT: R here is unscaled
    # each position is owned by ONE segment: lags [0, hop)
    rxy_flat = jnp.sqrt(Rr ** 2 + Ri ** 2) * g[:, None]
    seg_arg = jnp.argmax(rxy_flat, axis=-1)
    seg_peak = jnp.take_along_axis(rxy_flat, seg_arg[:, None],
                                   axis=-1)[:, 0]
    seg_off = seg_arg // _DET_HOP                       # offset-bin index
    seg_lag = seg_arg % _DET_HOP
    n0_seg = jnp.asarray(starts) + seg_lag              # buffer position
    # a peak at position p with p % hop == hop-1 has a +-1-sample
    # "twin" owned by the NEXT segment (and vice versa); keep only
    # segments that beat both neighbors so exactly the best-aligned
    # copy survives.  Deterministic across blocks: the segment grid
    # is absolute-aligned (T % hop == 0), so both blocks compare the
    # same numbers.
    from .. import debug
    debug.tap("stream_rx.seg_peak", seg_peak)           # per-segment rxy
    neg = jnp.full((1,), -jnp.inf, seg_peak.dtype)
    first = (neg if prev_peak is None
             else jnp.reshape(prev_peak, (1,)).astype(seg_peak.dtype))
    pk_prev = jnp.concatenate([first, seg_peak[:-1]])
    pk_next = jnp.concatenate([seg_peak[1:], neg])
    local = (seg_peak > pk_prev) & (seg_peak >= pk_next)
    cand = (seg_peak > threshold) & (n0_seg < T) & local

    # greedy in-order suppression: once a frame is detected, nothing
    # fires again until `span` samples have passed — kills the
    # +-1-sample twin emitted by a neighboring segment or the next
    # block, and partial-template sidelobes inside the suppressed
    # span.  Same semantics as the reference's re-arm.
    def _suppress(le, ci):
        c, p = ci
        keep = c & (p >= le)
        return jnp.where(keep, p + span, le), keep

    # unroll=32: same keeps, 4x faster in isolation (the 3-op body is
    # pure dispatch overhead per step); neutral inside the fused
    # receiver program, kept because it can only shrink the jaxpr's
    # sequential region
    if suppress_fn is not None:
        keeps, wm_cand, wm_n0 = suppress_fn(last_end, cand, n0_seg, span)
    else:
        _, keeps = lax.scan(_suppress, last_end, (cand, n0_seg),
                            unroll=32)
        wm_cand, wm_n0 = keeps, n0_seg
    cand = keeps
    n_cand = jnp.sum(cand)
    sel = jnp.nonzero(cand, size=P, fill_value=0)[0]    # first P, in order
    valid = jnp.arange(P) < n_cand
    n0 = n0_seg[sel]                                    # [P]
    off_i = seg_off[sel]
    peak = seg_peak[sel]

    # ---- per-candidate refinement (qdetector align, batched) ----
    # contiguous windows: dynamic_slice, not a computed-index gather
    # (n0 < T and hist >= NFFT, so no clamp can occur); planes stacked
    # before the slice — see mf_symbol_gather
    U = int(win_len) if win_len is not None else _DET_NFFT
    fp = int(front_pad)
    buf2 = jnp.stack([jnp.real(buf), jnp.imag(buf)])
    if fp or U > _DET_NFFT:
        # zero padding preserves edge semantics (a clamped slice would
        # silently shift the window); end pad sized so n0 = T-1 fits
        need_end = max(0, (T - 1 - fp + U) - buf2.shape[-1])
        if left_ext is not None and fp:
            # time-shard: the fp samples before the local buffer head
            # are REAL neighbor data, not the stream edge
            buf2 = jnp.concatenate(
                [left_ext.astype(buf2.dtype), buf2], axis=-1)
            if need_end:
                buf2 = jnp.pad(buf2, ((0, 0), (0, need_end)))
        else:
            buf2 = jnp.pad(buf2, ((0, 0), (fp, need_end)))
    # extract only the VALID candidate slots: a vmapped dynamic_slice
    # unrolls to P sequential loop iterations regardless of occupancy,
    # and extraction dominated the receiver's device time
    # (tools/profile_device.py).  The dynamic-trip fori_loop runs
    # n_cand iterations (batched rows run to the batch maximum);
    # untouched slots stay zero and every consumer masks on `valid`.
    def _fill(i, acc):
        w = lax.dynamic_slice(buf2, (0, n0[i]), (2, U))
        return lax.dynamic_update_slice(acc, w[None], (i, 0, 0))
    win = lax.fori_loop(0, jnp.minimum(n_cand, P), _fill,
                        jnp.zeros((P, 2, U), jnp.float32))  # [P, 2, U]
    xa = lax.complex(win[:, 0, fp:fp + _DET_NFFT],
                     win[:, 1, fp:fp + _DET_NFFT])
    Xa = jnp.fft.fft(xa, axis=-1)
    Ra = jnp.fft.ifft(Xa * jnp.conj(So)[off_i], axis=-1) * _DET_NFFT
    tau, g_pk = quad_peak(jnp.sqrt(jnp.abs(Ra[:, -1])),
                          jnp.sqrt(jnp.abs(Ra[:, 0])),
                          jnp.sqrt(jnp.abs(Ra[:, 1])))
    gamma = g_pk * g_pk / (_DET_NFFT * s2_sum)
    # fine carrier: FFT of aligned window times conj(template)
    w = xa[:, :s_len] * sconj[None, :]
    W = jnp.fft.fft(w, _DET_NFFT, axis=-1)
    Wm = jnp.abs(W)
    i0 = jnp.argmax(Wm, axis=-1)
    vm1 = jnp.take_along_axis(Wm, ((i0 - 1) % _DET_NFFT)[:, None],
                              axis=-1)[:, 0]
    v0 = jnp.take_along_axis(Wm, i0[:, None], axis=-1)[:, 0]
    vp1 = jnp.take_along_axis(Wm, ((i0 + 1) % _DET_NFFT)[:, None],
                              axis=-1)[:, 0]
    frac, _ = quad_peak(vm1, v0, vp1)
    index = i0 + frac - jnp.where(i0 > _DET_NFFT // 2, _DET_NFFT, 0)
    dphi = index * (2 * np.pi / _DET_NFFT)
    phi = jnp.angle(jnp.take_along_axis(W, i0[:, None], axis=-1)[:, 0])
    return {"valid": valid, "n_cand": n_cand, "n0": n0, "off_i": off_i,
            "peak": peak, "tau": tau, "gamma": gamma, "dphi": dphi,
            "phi": phi, "cand": wm_cand, "n0_seg": wm_n0, "win": win}


def _seg_peak_at(buf, dc: dict, start: int):
    """Detection peak of the ONE segment at static buffer position
    `start` — the same banded-matmul row _detect_refine computes in its
    grid (used by the time-sharded receiver to reproduce the left
    neighbor's last owned segment peak from the shared halo samples,
    parallel/rx.py)."""
    seg = buf[..., start:start + _DET_NFFT]
    Fr, Fi = seg.real[None, :], seg.imag[None, :]
    Br = jnp.asarray(dc["band_re"])
    Bi = jnp.asarray(dc["band_im"])
    Rr = Fr @ Br + Fi @ Bi
    Ri = Fi @ Br - Fr @ Bi
    x2 = jnp.sum(Fr ** 2 + Fi ** 2, axis=-1)
    g0 = jnp.sqrt(jnp.maximum(x2, 1e-20) * (dc["s_len"] / _DET_NFFT))
    g = 1.0 / (g0 * np.sqrt(dc["s2_sum"]))
    return jnp.max(jnp.sqrt(Rr ** 2 + Ri ** 2) * g[:, None])


def _advance_watermark(carry, det, span: int, T: int):
    """Fold this block's detections into the next block's suppression
    watermark (shifted into the next block's buffer coordinates).

    Gates on any(det['cand']) — NOT det['n_cand'] — because in the
    time-sharded receiver det['cand'] is the all-gathered GLOBAL keep
    mask while n_cand is the local shard's count; gating on the local
    count let carry['last_end'] diverge across shards (caught by the
    reproduced on a 4-shard mesh)."""
    last_n0 = jnp.max(jnp.where(det["cand"], det["n0_seg"], -(1 << 30)))
    new_last = jnp.maximum(carry["last_end"],
                           jnp.where(jnp.any(det["cand"]),
                                     last_n0 + span,
                                     -(1 << 30))) - T
    return jnp.maximum(new_last, -(1 << 30))


def batched_apply(apply_1d, T: int):
    """Wrap a 1-D streaming ``apply_1d(carry, x[T])`` into the Proc
    apply signature with arbitrary leading batch axes (vmap over the
    flattened batch, reshape back) — the shared wrapper for every
    streaming receiver in this package."""

    def apply(params, carry, x):
        if x.ndim == 1:
            return apply_1d(carry, x)
        batch = x.shape[:-1]
        xf = x.reshape((-1, T))
        cf = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[len(batch):]), carry)
        out, nc = jax.vmap(apply_1d)(cf, xf)
        out = jax.tree_util.tree_map(
            lambda a: a.reshape(batch + a.shape[1:]), out)
        nc = jax.tree_util.tree_map(
            lambda a: a.reshape(batch + a.shape[1:]), nc)
        return out, nc

    return apply


class DetStreamBlock(NamedTuple):
    """Streaming detector output: candidate-slot batched estimates."""
    valid: jnp.ndarray        # [..., P] bool
    sample_index: jnp.ndarray # [..., P] int32, absolute stream index
    rxy: jnp.ndarray          # [..., P] detection correlation
    gamma: jnp.ndarray        # [..., P] channel gain
    dphi: jnp.ndarray         # [..., P] CFO, rad/sample
    phi: jnp.ndarray          # [..., P] carrier phase at template start
    tau: jnp.ndarray          # [..., P] fractional timing offset


def detector_stream(block_len: int, template: np.ndarray,
                    threshold: float = 0.5, max_frames: int = 4,
                    suppress_span: int | None = None,
                    name: str = "detector_stream",
                    hist: int | None = None) -> Proc:
    """Streaming preamble DETECTOR as a jittable block Proc: the
    detect-everywhere + refine front half of preamble_stream, without a
    matched-filter/pilot back end — for framers whose demodulation is
    not a linear MF chain (GMSK's phase-derivative demod, custom PHYs).

    apply(params, carry, x[..., block_len]) -> (DetStreamBlock, carry').
    hist overrides STREAM_HIST: detections lag the newest sample by at
    least `hist`, so a consumer holding a same-geometry sample buffer
    can extract full frame windows up to `hist` samples long behind
    each detection (gmskframe_rx_stream).
    Reference analog: qdetector_cccf run persistently over a stream
    (reference qdetector_cccf.c:373-441) with re-arm semantics.
    """
    T = int(block_len)
    if T % _DET_HOP != 0:
        raise ValueError("block_len must be a multiple of %d" % _DET_HOP)
    P = int(max_frames)
    if hist is None:
        hist = STREAM_HIST
    hist = -(-int(hist) // _DET_HOP) * _DET_HOP
    if hist < _DET_NFFT:
        # a shorter history clamps the segment gathers / refine slices
        # at the buffer edge and silently shifts windows near the block
        # tail (same guard preamble_stream enforces)
        raise ValueError(f"hist must be >= {_DET_NFFT}")
    dc = _detect_consts(np.asarray(template))
    span = int(suppress_span if suppress_span is not None
               else dc["s_len"])
    # segment grid restricted to the EMIT region: only candidates with
    # n0 < T are ever emitted (and the watermark folds only those), so
    # segments with start > T are wasted matmul work — one segment past T
    # is kept for the local-peak neighbor comparison.  At the wideband
    # scanner's short per-channel blocks this is ~31% of the detection
    # matmul (hist=1536 vs Tc=2048); the history tail still backs the
    # refine/MF windows of frames emitted near position 0.
    n_seg = T // _DET_HOP + 1
    starts = (np.arange(n_seg) * _DET_HOP).astype(np.int32)

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"buf": jnp.zeros(batch_shape + (hist,), jnp.complex64),
                "base": jnp.full(batch_shape, -hist, jnp.int32),
                "last_end": jnp.full(batch_shape, -(1 << 30), jnp.int32)}

    def _apply_1d(carry, x):
        buf = jnp.concatenate([carry["buf"], x.astype(jnp.complex64)],
                              axis=-1)
        det = _detect_refine(buf, carry["last_end"], dc, threshold, P, T,
                             starts, span)
        out = DetStreamBlock(
            valid=det["valid"],
            sample_index=carry["base"] + det["n0"].astype(jnp.int32),
            rxy=det["peak"], gamma=det["gamma"], dphi=det["dphi"],
            phi=det["phi"], tau=det["tau"])
        new_carry = {"buf": buf[..., T:], "base": carry["base"] + T,
                     "last_end": _advance_watermark(carry, det, span, T)}
        return out, new_carry

    apply = batched_apply(_apply_1d, T)

    return Proc(params=(), init=init, apply=apply, rate=(1, 1), name=name)


def preamble_stream(block_len: int, cfg: StreamRxConfig,
                    threshold: float = 0.5, max_frames: int = 4,
                    name: str = "preamble_stream",
                    hist: int | None = None) -> Proc:
    """Streaming preamble-sync receiver as a jittable block Proc.

    apply(params, carry, x[..., block_len]) -> (StreamRxBlock, carry').
    block_len must be a multiple of the detection hop so the absolute
    segment grid is block-invariant.  hist overrides the STREAM_HIST
    history length for long frame regions (full-frame flexframe sync);
    it is rounded up to a _DET_HOP multiple.
    """
    T = int(block_len)
    if T % _DET_HOP != 0:
        raise ValueError("block_len must be a multiple of %d" % _DET_HOP)
    P = int(max_frames)
    if hist is None:
        hist = STREAM_HIST
    hist = -(-int(hist) // _DET_HOP) * _DET_HOP
    n_sym_tot = cfg.region_start + cfg.region_len
    if hist < cfg.k * n_sym_tot + 2 or hist < _DET_NFFT:
        raise ValueError("history window too short for this frame region")
    R = _rx_consts(T, cfg, P, hist)

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"buf": jnp.zeros(batch_shape + (hist,), jnp.complex64),
                "base": jnp.full(batch_shape, -hist, jnp.int32),
                # buffer-relative position before which detections are
                # suppressed: the analog of the reference's re-arm-after-
                # frame (its seek state machine consumes the frame before
                # looking again, framesync64.c:241-269)
                "last_end": jnp.full(batch_shape, -(1 << 30), jnp.int32)}

    def _apply_1d(carry, x):
        buf = jnp.concatenate([carry["buf"], x.astype(jnp.complex64)],
                              axis=-1)                      # [H+T]
        det = _detect_refine(buf, carry["last_end"], R["dc"], threshold,
                             P, T, R["starts"], R["span"],
                             front_pad=R["Lb"], win_len=R["win_len"])
        out = _rx_sync_block(R, buf, det, carry["base"])
        # advance the suppression watermark into next block's coordinates
        new_carry = {"buf": buf[..., T:], "base": carry["base"] + T,
                     "last_end": _advance_watermark(carry, det,
                                                    R["span"], T)}
        return out, new_carry

    apply = batched_apply(_apply_1d, T)

    return Proc(params=(), init=init, apply=apply, rate=(1, 1), name=name)


def _rx_consts(T: int, cfg: StreamRxConfig, P: int, hist: int) -> dict:
    """Shared numpy constants + geometry for the streaming preamble-sync
    receiver (single-device preamble_stream and the time-sharded
    variant, parallel/rx.py)."""
    n_sym_tot = cfg.region_start + cfg.region_len
    dc = _detect_consts(cfg.template)
    bank_np = cfg.bank[:, ::-1].copy()                   # newest-first
    # segment grid restricted to the EMIT region: only candidates with
    # n0 < T are ever emitted (and the watermark folds only those), so
    # segments with start > T are wasted matmul work — one segment past T
    # is kept for the local-peak neighbor comparison.  At the wideband
    # scanner's short per-channel blocks this is ~31% of the detection
    # matmul (hist=1536 vs Tc=2048); the history tail still backs the
    # refine/MF windows of frames emitted near position 0.
    n_seg = T // _DET_HOP + 1
    Lb = int(cfg.bank.shape[1])
    mf_span = cfg.k * (n_sym_tot - 1) + Lb
    return {
        "T": T, "P": P, "hist": hist, "dc": dc, "n_sym_tot": n_sym_tot,
        "bank": bank_np.astype(np.float32),
        "pil_re": cfg.pilots.real.astype(np.float32),
        "pil_im": cfg.pilots.imag.astype(np.float32),
        "npil": len(cfg.pilots),
        "spacing": int(cfg.pilot_spacing),
        "pfft": int(cfg.pilot_nfft),
        "npfb": int(cfg.bank.shape[0]),
        "k": int(cfg.k),
        "region_start": int(cfg.region_start),
        "region_len": int(cfg.region_len),
        "n_seg": n_seg,
        "starts": (np.arange(n_seg) * _DET_HOP).astype(np.int32),
        "span": int(cfg.suppress_span),
        "Lb": Lb, "mf_span": mf_span,
        "win_len": max(Lb + _DET_NFFT, mf_span + 1),
    }


def _rx_sync_block(R: dict, buf, det, base):
    """Mix + polyphase MF + pilot sync over the refined candidates of
    one buffer (shared by preamble_stream and the time-sharded RX)."""
    valid, n0, peak = det["valid"], det["n0"], det["peak"]
    tau, gamma = det["tau"], det["gamma"]
    dphi, phi = det["dphi"], det["phi"]
    npfb, npil = R["npfb"], R["npil"]
    spacing, pfft = R["spacing"], R["pfft"]
    pilots = lax.complex(jnp.asarray(R["pil_re"]),
                         jnp.asarray(R["pil_im"]))

    # ---- mix + polyphase matched filter + k:1 sample (batched) ----
    b_idx = jnp.where(
        tau > 0,
        jnp.floor(tau * npfb), jnp.floor((1.0 + tau) * npfb)
    ).astype(jnp.int32) % npfb
    off_s = jnp.where(tau > 0, 0, -1).astype(jnp.int32)
    sym = mf_symbol_gather(buf, n0, off_s, dphi, phi, gamma,
                           jnp.asarray(R["bank"]), b_idx, R["n_sym_tot"],
                           k=R["k"], win=det["win"])
    region_rx = sym[:, R["region_start"]:]              # [P, region_len]

    # ---- pilot sync (qpilotsync_execute, batched) ----
    pil_idx = np.nonzero(np.arange(R["region_len"]) % spacing == 0)[0]
    rx_pil = region_rx[:, jnp.asarray(pil_idx[:npil].astype(np.int32))]
    v = rx_pil * jnp.conj(pilots)[None, :]
    V = jnp.fft.fft(v, pfft, axis=-1)
    Vm = jnp.abs(V)
    j0 = jnp.argmax(Vm, axis=-1)
    um1 = jnp.take_along_axis(Vm, ((j0 - 1) % pfft)[:, None],
                              axis=-1)[:, 0]
    u0 = jnp.take_along_axis(Vm, j0[:, None], axis=-1)[:, 0]
    up1 = jnp.take_along_axis(Vm, ((j0 + 1) % pfft)[:, None],
                              axis=-1)[:, 0]
    frac2, _ = quad_peak(um1, u0, up1)
    jdx = j0 + frac2 - jnp.where(j0 > pfft // 2, pfft, 0)
    dphi2 = jdx * (2 * np.pi / (pfft * spacing))
    rot = dphi2[:, None] * (np.arange(npil) * spacing)[None, :]
    metric = jnp.sum(v * lax.complex(jnp.cos(rot), -jnp.sin(rot)),
                     axis=-1)
    phi2 = jnp.angle(metric)
    g2 = jnp.abs(metric) / npil
    c2r, c2i = cexp_ramp(dphi2, phi2, R["region_len"])
    corr = lax.complex(c2r, c2i) / jnp.maximum(g2, 1e-12)[:, None]
    region_syms = region_rx * corr

    from .. import debug
    debug.tap("stream_rx.dphi", dphi)
    debug.tap("stream_rx.region_syms", region_syms)
    return StreamRxBlock(
        valid=valid,
        sample_index=base + n0.astype(jnp.int32),
        rxy=peak, gamma=gamma, dphi=dphi, phi=phi, tau=tau,
        b_idx=b_idx, off_s=off_s, dphi2=dphi2, phi2=phi2, g2=g2,
        region_syms=region_syms)
