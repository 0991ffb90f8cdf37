"""Polyphase filterbank channelizers.

Reference analogs (studied, not copied):
  * firpfbch  — src/multichannel/src/firpfbch.c:37-405: maximally
                decimated M-channel analyzer/synthesizer; per-channel
                window + dotprod then M-point (I)FFT (analyzer run at
                :383-405, synthesizer at :314-331).
  * firpfbch2 — src/multichannel/src/firpfbch2.c:36-329: oversampled
                (M/2-sample advance) channelizer, 2x output rate.

Design (the "batched polyphase+FFT kernel" of BASELINE.md): the
per-branch polyphase filter has contraction length p = 2m (~8) — far
too small for a matrix unit — so for practical channel counts the filter and
the M-point (I)DFT are FUSED algebraically into dense banded matrices
and each block becomes a handful of real [L, depth*M] x [depth*M, M]
matmuls over sliding frame windows.  Beyond `_FUSED_MAX_M`
channels the dense DFT factor grows O(M^2) (2.4 GB of constants at
M=4096) and an FFT wins, so the constructors fall back to the
grouped-einsum branch filter + batched (I)FFT formulation.

Channel c of the analyzer is the input mixed down by exp(-j*2*pi*c*n/M),
lowpass-filtered by the prototype, and decimated by M (the reference's
equivalence autotest, src/multichannel/tests/firpfbch_crcf_autotest.c).
Analysis output convention: y[..., c, l] = channel c, frame l.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..core import Proc
from ..design.firdes import firdes_kaiser

__all__ = ["firpfbch_kaiser_taps", "firpfbch_analyzer",
           "firpfbch_synthesizer", "firpfbch2_analyzer",
           "firpfbch2_synthesizer"]

_FUSED_MAX_M = 512   # largest M for the dense fused-matmul formulation


def firpfbch_kaiser_taps(M: int, m: int = 4, as_db: float = 60.0):
    """Prototype lowpass, length 2*M*m+1, cutoff 0.5/M, un-normalized
    (reference firpfbch_crcf_create_kaiser, firpfbch.c:146-177)."""
    return firdes_kaiser(2 * M * m + 1, 0.5 / M, as_db).astype(np.float32)


def _branch_taps(h: np.ndarray, M: int, p: int):
    """Hb[r, q] = h[q*M + r] — polyphase decomposition, p taps/branch."""
    return np.stack([h[r + np.arange(p) * M] for r in range(M)])  # [M, p]


# ---------------------------------------------------------------------------
# shared machinery


def _branch_filter(Hb, carry, u):
    """Filter each branch along the frame axis (the large-M fallback).

    u: [..., L, M]  (frame-major), Hb: [M, p], carry: [..., p-1, M].
    Returns (v [..., L, M], carry').
    """
    M, p = Hb.shape
    if p > 1:
        up = jnp.concatenate([carry, u], axis=-2)   # [..., L+p-1, M]
    else:
        up = u
    L = u.shape[-2]
    # v[l, r] = sum_q Hb[r, q] * up[l + (p-1) - q, r]
    idx = jnp.arange(L)[:, None] + (p - 1 - jnp.arange(p))[None, :]
    win = jnp.take(up, idx, axis=-2)                # [..., L, p, M]
    v = jnp.einsum("...lpm,mp->...lm", win, Hb.astype(u.dtype))
    new_carry = up[..., up.shape[-2] - (p - 1):, :] if p > 1 else carry
    return v, new_carry


def _frame_windows(upr, upi, L: int, depth: int):
    """Sliding frame windows: up [.., L+depth-1, M] -> [.., L, depth*M]."""
    lead = upr.shape[:-2]
    M = upr.shape[-1]
    idx = np.arange(L)[:, None] + np.arange(depth)[None, :]
    wr = upr[..., idx, :].reshape(lead + (L, depth * M))
    wi = upi[..., idx, :].reshape(lead + (L, depth * M))
    return wr, wi


def _cmm(wr, wi, Ar, Ai, precision):
    """Complex matmul on planes: (wr + j wi) @ (Ar + j Ai)."""
    mm = lambda a, b: jnp.matmul(a, jnp.asarray(b), precision=precision)
    return mm(wr, Ar) - mm(wi, Ai), mm(wr, Ai) + mm(wi, Ar)


def _tail(up, keep: int):
    """Last `keep` frames as a POSITIVE-start slice (keep=0 must return
    an EMPTY slice; `up[..., -0:, :]` would return everything — that was
    a real bug for p=1 banks)."""
    return up[..., up.shape[-2] - keep:, :]


# ---------------------------------------------------------------------------
# firpfbch (maximally decimated)


def firpfbch_analyzer(M: int, m: int = 4, as_db: float = 60.0, h=None,
                      precision=None,
                      name: str = "firpfbch_analyzer") -> Proc:
    """M-channel maximally-decimated analysis bank, sample-exact with the
    reference (firpfbch.c _analyzer_execute/_run:346-405).

    Input [..., T] (T % M == 0) -> output [..., M, T//M].
    Structure: window i's stream u_i[l] = x[l*M + M-1-i], branch-filtered
    by taps h[i + n*M]; bin (M-1-i) of a forward FFT across branches.

    Fused form (M <= _FUSED_MAX_M): the p-tap branch filter and
    the M-point FFT compose into ONE [pM, M] matrix
    A[(d, c), b] = Hb[c, p-1-d] * exp(-2j*pi*(M-1-c)*b/M), so a block is
    four real [L, pM] x [pM, M] matmuls on (re, im) planes.
    `precision` as in firpfbch2_analyzer (default HIGHEST).  Larger M
    falls back to the grouped-einsum + batched-FFT formulation (the
    dense DFT factor grows O(M^2))."""
    if h is None:
        h = firpfbch_kaiser_taps(M, m, as_db)
    h = np.asarray(h)
    if precision is None:
        precision = lax.Precision.HIGHEST
    p = len(h) // M  # taps per branch (reference p = 2m)
    Hb = _branch_taps(h, M, p)                       # [M, p] numpy

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (p - 1, M), dtype)

    if M > _FUSED_MAX_M:
        Hbj = jnp.asarray(Hb)

        def apply(params, carry, x):
            T = x.shape[-1]
            if T % M:
                raise ValueError(f"analyzer block length {T} not a "
                                 f"multiple of M={M}")
            L = T // M
            xf = x.reshape(x.shape[:-1] + (L, M))
            u = xf[..., ::-1]     # u_i[l] = x[lM + M-1-i]
            v, new_carry = _branch_filter(Hbj, carry.astype(x.dtype), u)
            X = v[..., ::-1]      # X[M-1-i] = v_i (firpfbch.c:401-405)
            Y = jnp.fft.fft(X, axis=-1)
            return jnp.moveaxis(Y, -1, -2).astype(jnp.complex64), new_carry

        return Proc(params=(), init=init, apply=apply,
                    rate=(1, 1), name=name)

    cc = np.arange(M)
    F = np.exp(-2j * np.pi * np.outer((M - 1 - cc), np.arange(M)) / M)
    A = np.zeros((p, M, M), np.complex64)
    for c in range(M):
        for q in range(p):
            A[p - 1 - q, c, :] = Hb[c, q] * F[c, :]
    A = A.reshape(p * M, M)
    Ar, Ai = A.real.copy(), A.imag.copy()

    def _core(r, i, cr, ci):
        T = r.shape[-1]
        if T % M:
            raise ValueError(f"analyzer block length {T} not a multiple "
                             f"of M={M}")
        L = T // M
        lead = r.shape[:-1]
        ur = r.reshape(lead + (L, M))[..., ::-1]     # u_i[l] = x[lM+M-1-i]
        ui = i.reshape(lead + (L, M))[..., ::-1]
        upr = jnp.concatenate([cr, ur], axis=-2)     # [.., L+p-1, M]
        upi = jnp.concatenate([ci, ui], axis=-2)
        wr, wi = _frame_windows(upr, upi, L, p)
        Yr, Yi = _cmm(wr, wi, Ar, Ai, precision)
        return (jnp.moveaxis(Yr, -1, -2), jnp.moveaxis(Yi, -1, -2),
                _tail(upr, p - 1), _tail(upi, p - 1))

    def apply(params, carry, x):
        c = carry.astype(jnp.complex64)
        Yr, Yi, cr2, ci2 = _core(jnp.real(x), jnp.imag(x),
                                 jnp.real(c), jnp.imag(c))
        return (lax.complex(Yr, Yi).astype(jnp.complex64),
                lax.complex(cr2, ci2).astype(jnp.complex64))

    def planar_init(batch_shape=(), dtype=jnp.float32):
        z = jnp.zeros(batch_shape + (p - 1, M), jnp.float32)
        return (z, z)

    def planar_apply(params, carry, x):
        (r, i), (cr, ci) = x, carry
        Yr, Yi, cr2, ci2 = _core(r, i, cr.astype(r.dtype),
                                 ci.astype(i.dtype))
        return (Yr, Yi), (cr2, ci2)

    return Proc(params=(), init=init, apply=apply,
                planar_init=planar_init, planar_apply=planar_apply,
                rate=(1, 1), name=name)


def firpfbch_synthesizer(M: int, m: int = 4, as_db: float = 60.0, h=None,
                         precision=None,
                         name: str = "firpfbch_synth") -> Proc:
    """M-channel synthesis bank, sample-exact with the reference
    (firpfbch.c _synthesizer_execute:314-331): unnormalized inverse FFT
    across channels, then per-branch filtering.

    Input [..., M, L] -> output [..., L*M].

    Fused form (M <= _FUSED_MAX_M, mirror of firpfbch_analyzer):
    the unnormalized IDFT and the p-tap branch filter compose into ONE
    [pM, M] matrix S[(d, j), r] = Hb[r, p-1-d] * exp(2j*pi*j*r/M) over
    p-frame windows of the channel-symbol stream.  `precision` as in
    the analyzer (default HIGHEST).  Larger M falls back to einsum +
    batched IFFT.  NOTE: the fused carry holds raw channel-symbol
    frames; the fallback carry holds IFFT-domain frames — the layouts
    are regime-specific (both [p-1, M] complex)."""
    if h is None:
        h = firpfbch_kaiser_taps(M, m, as_db)
    h = np.asarray(h)
    if precision is None:
        precision = lax.Precision.HIGHEST
    p = len(h) // M
    Hb = _branch_taps(h, M, p)

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (p - 1, M), dtype)

    if M > _FUSED_MAX_M:
        Hbj = jnp.asarray(Hb)

        def apply(params, carry, X):
            L = X.shape[-1]
            Xf = jnp.moveaxis(X, -2, -1)            # [..., L, M]
            w = jnp.fft.ifft(Xf, axis=-1) * M       # unnormalized backward
            v, new_carry = _branch_filter(Hbj, carry.astype(w.dtype), w)
            y = v.reshape(v.shape[:-2] + (L * M,))
            return y.astype(jnp.complex64), new_carry

        return Proc(params=(), init=init, apply=apply,
                    rate=(1, 1), name=name)

    jj = np.arange(M)
    W = np.exp(2j * np.pi * np.outer(jj, jj) / M)     # M * ifft
    S = np.zeros((p, M, M), np.complex64)
    for r in range(M):
        for q in range(p):
            S[p - 1 - q, :, r] += Hb[r, q] * W[:, r]
    S = S.reshape(p * M, M)
    Sr, Si = S.real.copy(), S.imag.copy()

    def _core(Xr, Xi, cr, ci):
        L = Xr.shape[-1]
        lead = Xr.shape[:-2]
        ur = jnp.concatenate([cr, jnp.moveaxis(Xr, -2, -1)], axis=-2)
        ui = jnp.concatenate([ci, jnp.moveaxis(Xi, -2, -1)], axis=-2)
        wr, wi = _frame_windows(ur, ui, L, p)
        Yr, Yi = _cmm(wr, wi, Sr, Si, precision)
        return (Yr.reshape(lead + (L * M,)), Yi.reshape(lead + (L * M,)),
                _tail(ur, p - 1), _tail(ui, p - 1))

    def apply(params, carry, X):
        c = carry.astype(jnp.complex64)
        Yr, Yi, cr2, ci2 = _core(jnp.real(X), jnp.imag(X),
                                 jnp.real(c), jnp.imag(c))
        return (lax.complex(Yr, Yi).astype(jnp.complex64),
                lax.complex(cr2, ci2).astype(jnp.complex64))

    def planar_init(batch_shape=(), dtype=jnp.float32):
        z = jnp.zeros(batch_shape + (p - 1, M), jnp.float32)
        return (z, z)

    def planar_apply(params, carry, x):
        (Xr, Xi), (cr, ci) = x, carry
        Yr, Yi, cr2, ci2 = _core(Xr, Xi, cr.astype(Xr.dtype),
                                 ci.astype(Xr.dtype))
        return (Yr, Yi), (cr2, ci2)

    return Proc(params=(), init=init, apply=apply,
                planar_init=planar_init, planar_apply=planar_apply,
                rate=(1, 1), name=name)


# ---------------------------------------------------------------------------
# firpfbch2 (2x oversampled)


def firpfbch2_analyzer(M: int, m: int = 4, as_db: float = 60.0,
                       precision=None,
                       name: str = "firpfbch2_analyzer") -> Proc:
    """Oversampled analysis channelizer, sample-exact with the reference
    (firpfbch2.c:244-282): M/2-sample hops, alternating window/filter
    alignment (the `flag` state), sub-sampled filter bank, inverse FFT
    scaled by 1/M.

    Input [..., T] (T % M == 0, i.e. an even number of hops) -> output
    [..., M, 2*T//M].

    Fused form (M <= _FUSED_MAX_M): window j's sample stream is
    u_j[n] = x[n*M + M/2-1-(j mod M/2) + (j>=M/2)*M/2]; even hops
    filter it with branch taps k=j (opposite window half lagged one
    hop), odd hops with k=(j-M/2) mod M; each hop then takes an M-point
    IFFT across j.  Both the per-branch filter (contraction length
    p=2m — far too small for a matrix unit alone) and the IDFT fuse into ONE
    matrix per hop type:

        X[t, b] = sum_{d, j} w[t, d, j] * A[(d, j), b],
        A_even[(d, j), b] = G[j, p-d-(j>=M/2)] * W[j, b] / M,
        A_odd [(d, j), b] = G[(j-M/2) mod M, p-d] * W[j, b] / M,

    with w the (p+1)-frame sliding window over u — a [(p+1)M, M]
    matmul per hop type.  `precision` pins the matmul precision:
    default HIGHEST (true float32; the golden tolerance is 2e-4, which a
    reduced-precision pass such as TF32 can exceed); a lower setting is
    for tolerance-flexible pipelines.

    Larger M falls back to the einsum + batched-IFFT formulation; the
    planar path (planar.py) exists on the fused regime only.
    """
    if M % 2:
        raise ValueError("firpfbch2 requires an even number of channels")
    if precision is None:
        precision = lax.Precision.HIGHEST
    M2 = M // 2
    p = 2 * m
    # analyzer prototype has twice the synthesizer bandwidth
    # (reference firpfbch2.c create_kaiser: fc = 1/M for the analyzer)
    h = firdes_kaiser(2 * M * m + 1, 1.0 / M, as_db)
    h = (h * M / np.sum(h)).astype(np.float32)
    # branch taps g[k, nu] = h[k + nu*M], k = 0..M-1, nu = 0..2m-1
    G = np.stack([h[k + np.arange(p) * M] for k in range(M)])
    jj = np.arange(M)
    samp = (M2 - 1 - (jj % M2)) + (jj >= M2) * M2    # index within frame
    k_odd = (jj - M2) % M

    def init(batch_shape=(), dtype=jnp.complex64):
        # p history frames: the newest p frames of u (supplies both the
        # filter memory and the one-hop lag across block boundaries)
        return jnp.zeros(batch_shape + (p, M), dtype)

    if M > _FUSED_MAX_M:
        Gj = jnp.asarray(G)

        def apply(params, carry, x):
            T = x.shape[-1]
            if T % M:
                raise ValueError(f"firpfbch2 analyzer block length {T} "
                                 f"must be a multiple of M={M}")
            L = T // M
            xf = x.reshape(x.shape[:-1] + (L, M))
            u = xf[..., samp]                              # [..., L, M]
            hist = carry.astype(x.dtype)
            ue_all, _ = _branch_filter(
                jnp.take(Gj, jnp.asarray(jj), axis=0), hist[..., :-1, :],
                jnp.concatenate([hist[..., -1:, :], u], axis=-2))
            ue = ue_all[..., 1:, :]
            ue_lag = ue_all[..., :-1, :]
            uo, _ = _branch_filter(jnp.take(Gj, jnp.asarray(k_odd), axis=0),
                                   hist[..., 1:, :], u)
            X_even = jnp.where(jnp.asarray(jj < M2), ue, ue_lag)
            X = jnp.stack([X_even, uo], axis=-2)
            X = X.reshape(X.shape[:-3] + (2 * L, M))
            Y = jnp.fft.ifft(X, axis=-1)
            new_carry = jnp.concatenate([hist, u], axis=-2)[..., -p:, :]
            return jnp.moveaxis(Y, -1, -2).astype(jnp.complex64), new_carry

        return Proc(params=(), init=init, apply=apply,
                    rate=(2, 1), name=name)

    W = np.exp(2j * np.pi * np.outer(jj, jj) / M) / M     # IFFT matrix
    A_even = np.zeros((p + 1, M, M), np.complex64)
    A_odd = np.zeros((p + 1, M, M), np.complex64)
    for j in range(M):
        for q in range(p):
            A_even[p - q - (1 if j >= M2 else 0), j, :] += G[j, q] * W[j, :]
            A_odd[p - q, j, :] += G[k_odd[j], q] * W[j, :]
    Ae = A_even.reshape((p + 1) * M, M)
    Ao = A_odd.reshape((p + 1) * M, M)
    Aer, Aei = Ae.real.copy(), Ae.imag.copy()
    Aor, Aoi = Ao.real.copy(), Ao.imag.copy()

    def _core(r, i, cr, ci):
        T = r.shape[-1]
        if T % M:
            raise ValueError(f"firpfbch2 analyzer block length {T} must "
                             f"be a multiple of M={M} (even hop count)")
        L = T // M
        lead = r.shape[:-1]
        ur = r.reshape(lead + (L, M))[..., samp]
        ui = i.reshape(lead + (L, M))[..., samp]
        upr = jnp.concatenate([cr, ur], axis=-2)          # [.., L+p, M]
        upi = jnp.concatenate([ci, ui], axis=-2)
        wr, wi = _frame_windows(upr, upi, L, p + 1)
        Xer, Xei = _cmm(wr, wi, Aer, Aei, precision)
        Xor, Xoi = _cmm(wr, wi, Aor, Aoi, precision)
        Yr = jnp.stack([Xer, Xor], axis=-2).reshape(lead + (2 * L, M))
        Yi = jnp.stack([Xei, Xoi], axis=-2).reshape(lead + (2 * L, M))
        return (jnp.moveaxis(Yr, -1, -2), jnp.moveaxis(Yi, -1, -2),
                _tail(upr, p), _tail(upi, p))

    def apply(params, carry, x):
        c = carry.astype(jnp.complex64)
        Yr, Yi, cr2, ci2 = _core(jnp.real(x), jnp.imag(x),
                                 jnp.real(c), jnp.imag(c))
        return (lax.complex(Yr, Yi).astype(jnp.complex64),
                lax.complex(cr2, ci2).astype(jnp.complex64))

    def planar_init(batch_shape=(), dtype=jnp.float32):
        z = jnp.zeros(batch_shape + (p, M), jnp.float32)
        return (z, z)

    def planar_apply(params, carry, x):
        (r, i), (cr, ci) = x, carry
        Yr, Yi, cr2, ci2 = _core(r, i, cr.astype(r.dtype),
                                 ci.astype(i.dtype))
        return (Yr, Yi), (cr2, ci2)

    return Proc(params=(), init=init, apply=apply,
                planar_init=planar_init, planar_apply=planar_apply,
                rate=(2, 1), name=name)


def firpfbch2_synthesizer(M: int, m: int = 4, as_db: float = 60.0,
                          precision=None,
                          name: str = "firpfbch2_synth") -> Proc:
    """Oversampled synthesis channelizer, sample-exact with the reference
    (firpfbch2.c:287-337): per hop, IFFT of the M channel inputs scaled
    by M/2, pushed into one of two alternating window banks; each output
    sample sums two sub-filter dot products across the banks.

    Input [..., M, nf] (nf even) -> output [..., nf*M/2].

    Fused form (M <= _FUSED_MAX_M, mirror of the analyzer
    fusion): the per-hop IDFT and the two alternating-bank branch
    filters compose into four [(p+1)M, M/2] matrices over (p+1)-frame
    windows of the even-hop and odd-hop channel-symbol streams:

      y_even[n, i] = sum_{q,c} G[i, q]    W2[c, i]    Xe[n-q,   c]
                   + sum_{q,c} G[i+M2, q] W2[c, i]    Xo[n-1-q, c]
      y_odd [n, i] = sum_{q,c} G[i, q]    W2[c, i+M2] Xo[n-q,   c]
                   + sum_{q,c} G[i+M2, q] W2[c, i+M2] Xe[n-q,   c]

    with W2[c, j] = exp(2j*pi*c*j/M)/2 (the M/2-scaled IDFT).  The
    fused carry holds the last p raw frames of each hop-parity stream;
    the large-M fallback carries IFFT-domain window banks (regime-
    specific layouts).  `precision` as in firpfbch2_analyzer."""
    if M % 2:
        raise ValueError("firpfbch2 requires an even number of channels")
    if precision is None:
        precision = lax.Precision.HIGHEST
    M2 = M // 2
    p = 2 * m
    h = firdes_kaiser(2 * M * m + 1, 0.5 / M, as_db)
    h = (h * M / np.sum(h)).astype(np.float32)
    G = np.stack([h[k + np.arange(p) * M] for k in range(M)])

    if M > _FUSED_MAX_M:
        Gj = jnp.asarray(G)
        jj = np.arange(M)

        def init(batch_shape=(), dtype=jnp.complex64):
            return {"w1": jnp.zeros(batch_shape + (p - 1, M), dtype),
                    "w0": jnp.zeros(batch_shape + (p, M), dtype)}

        def apply(params, carry, Xin):
            nf = Xin.shape[-1]
            if nf % 2:
                raise ValueError("firpfbch2 synthesizer needs an even "
                                 "number of frames per block")
            L = nf // 2
            Xf = jnp.moveaxis(Xin, -2, -1)                # [..., nf, M]
            w = jnp.fft.ifft(Xf, axis=-1) * M2
            w1_in = w[..., 0::2, :]                        # [..., L, M]
            w0_in = w[..., 1::2, :]
            A_lo, c1 = _branch_filter(jnp.take(Gj, jnp.asarray(jj), axis=0),
                                      carry["w1"].astype(w.dtype), w1_in)
            hist0 = carry["w0"].astype(w.dtype)
            B_all, _ = _branch_filter(
                jnp.take(Gj, jnp.asarray((jj + M2) % M), axis=0),
                hist0[..., :-1, :],
                jnp.concatenate([hist0[..., -1:, :], w0_in], axis=-2))
            B_hi = B_all[..., 1:, :]
            B_lag = B_all[..., :-1, :]
            c0 = jnp.concatenate([hist0, w0_in], axis=-2)[..., -p:, :]
            i = np.arange(M2)
            y_even = A_lo[..., :, i] + B_lag[..., :, i]
            y_odd = B_hi[..., :, i + M2] + A_lo[..., :, i + M2]
            y = jnp.stack([y_even, y_odd], axis=-2)
            y = y.reshape(y.shape[:-3] + (nf * M2,))
            return y.astype(jnp.complex64), {"w1": c1, "w0": c0}

        return Proc(params=(), init=init, apply=apply,
                    rate=(1, 2), name=name)

    cc = np.arange(M)
    W2 = np.exp(2j * np.pi * np.outer(cc, cc) / M) / 2.0
    Ae = np.zeros((p + 1, M, M2), np.complex64)   # Xe -> y_even
    Be = np.zeros((p + 1, M, M2), np.complex64)   # Xo -> y_even (lagged)
    Ao = np.zeros((p + 1, M, M2), np.complex64)   # Xo -> y_odd
    Bo = np.zeros((p + 1, M, M2), np.complex64)   # Xe -> y_odd
    for i in range(M2):
        for q in range(p):
            Ae[p - q, :, i] += G[i, q] * W2[:, i]
            Be[p - 1 - q, :, i] += G[i + M2, q] * W2[:, i]
            Ao[p - q, :, i] += G[i, q] * W2[:, i + M2]
            Bo[p - q, :, i] += G[i + M2, q] * W2[:, i + M2]
    mats = [A.reshape((p + 1) * M, M2) for A in (Ae, Be, Ao, Bo)]
    (Aer, Aei), (Ber, Bei), (Aor, Aoi), (Bor, Boi) = [
        (A.real.copy(), A.imag.copy()) for A in mats]

    def init(batch_shape=(), dtype=jnp.complex64):
        z = jnp.zeros(batch_shape + (p, M), dtype)
        return {"e": z, "o": z}

    def _core(Xr, Xi, cer, cei, cor, coi):
        nf = Xr.shape[-1]
        if nf % 2:
            raise ValueError("firpfbch2 synthesizer needs an even number "
                             "of frames per block")
        L = nf // 2
        lead = Xr.shape[:-2]
        Xfr = jnp.moveaxis(Xr, -2, -1)               # [.., nf, M]
        Xfi = jnp.moveaxis(Xi, -2, -1)
        uer = jnp.concatenate([cer, Xfr[..., 0::2, :]], axis=-2)
        uei = jnp.concatenate([cei, Xfi[..., 0::2, :]], axis=-2)
        uor = jnp.concatenate([cor, Xfr[..., 1::2, :]], axis=-2)
        uoi = jnp.concatenate([coi, Xfi[..., 1::2, :]], axis=-2)
        Wer, Wei = _frame_windows(uer, uei, L, p + 1)
        Wor, Woi = _frame_windows(uor, uoi, L, p + 1)
        e1r, e1i = _cmm(Wer, Wei, Aer, Aei, precision)
        e2r, e2i = _cmm(Wor, Woi, Ber, Bei, precision)
        o1r, o1i = _cmm(Wor, Woi, Aor, Aoi, precision)
        o2r, o2i = _cmm(Wer, Wei, Bor, Boi, precision)
        yer, yei = e1r + e2r, e1i + e2i
        yor_, yoi = o1r + o2r, o1i + o2i
        Yr = jnp.stack([yer, yor_], axis=-2).reshape(lead + (nf * M2,))
        Yi = jnp.stack([yei, yoi], axis=-2).reshape(lead + (nf * M2,))
        return (Yr, Yi, _tail(uer, p), _tail(uei, p),
                _tail(uor, p), _tail(uoi, p))

    def apply(params, carry, Xin):
        ce = carry["e"].astype(jnp.complex64)
        co = carry["o"].astype(jnp.complex64)
        Yr, Yi, cer, cei, cor, coi = _core(
            jnp.real(Xin), jnp.imag(Xin),
            jnp.real(ce), jnp.imag(ce), jnp.real(co), jnp.imag(co))
        return (lax.complex(Yr, Yi).astype(jnp.complex64),
                {"e": lax.complex(cer, cei).astype(jnp.complex64),
                 "o": lax.complex(cor, coi).astype(jnp.complex64)})

    def planar_init(batch_shape=(), dtype=jnp.float32):
        z = jnp.zeros(batch_shape + (p, M), jnp.float32)
        return {"er": z, "ei": z, "or": z, "oi": z}

    def planar_apply(params, carry, x):
        (Xr, Xi) = x
        Yr, Yi, cer, cei, cor, coi = _core(
            Xr, Xi, carry["er"].astype(Xr.dtype),
            carry["ei"].astype(Xr.dtype), carry["or"].astype(Xr.dtype),
            carry["oi"].astype(Xr.dtype))
        return (Yr, Yi), {"er": cer, "ei": cei, "or": cor, "oi": coi}

    return Proc(params=(), init=init, apply=apply,
                planar_init=planar_init, planar_apply=planar_apply,
                rate=(1, 2), name=name)
