"""OFDM frame PHY: generator and block-native synchronizer.

Reference analogs (studied, not copied):
  * ofdmframe common — src/multichannel/src/ofdmframe.common.c:41-224:
    default subcarrier allocation (guards M/10, pilots every 4 or 8
    bins), S0 sequence (even data/pilot bins, +-1 from the default
    m-sequence, nextpow2(M) clipped to [4,8]), S1 (all enabled bins,
    order m+1), time-domain forms scaled by 1/sqrt(M_Sx).
  * ofdmframegen — src/multichannel/src/ofdmframegen.c:84-345: per
    symbol: pilots +-1 from msequence(8), data scaled by
    1/sqrt(M_pilot+M_data), centered-bin mapping k=(i+M/2)%M, IFFT,
    cyclic prefix + raised-cosine taper overlap.
  * ofdmframesync — src/multichannel/src/ofdmframesync.c:241-1100:
    seek-PLCP (S0 autocorrelation) -> carrier/timing estimation from
    S0/S1 -> per-subcarrier gain EQ -> pilot-tracked payload demod.

Design: the receiver is a block pipeline — the Schmidl-Cox S0
autocorrelation, S1 cross-correlation, channel estimate, and the
payload's CP-strip + batched FFT + EQ + pilot phase tracking are all
whole-capture vectorized operations (no per-sample state machine).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..utils.sequence import MSequence

__all__ = ["OFDMParams", "ofdm_params", "ofdm_generate_frame",
           "ofdm_frame_sync", "OFDMSyncResult"]

SCTYPE_NULL, SCTYPE_PILOT, SCTYPE_DATA = 0, 1, 2


class OFDMParams(NamedTuple):
    M: int
    cp_len: int
    taper_len: int
    p: np.ndarray          # subcarrier types [M]
    S0: np.ndarray         # freq-domain S0 [M]
    s0: np.ndarray         # time-domain S0 [M]
    S1: np.ndarray
    s1: np.ndarray
    M_null: int
    M_pilot: int
    M_data: int


def default_sctype(M: int) -> np.ndarray:
    """Reference ofdmframe_init_default_sctype (ofdmframe.common.c:176)."""
    p = np.zeros(M, np.uint8)
    M2 = M // 2
    G = max(M // 10, 2)
    P = 8 if M > 34 else 4
    P2 = P // 2
    for i in range(1, M2 - G):
        t = SCTYPE_PILOT if ((i + P2) % P) == 0 else SCTYPE_DATA
        p[i] = t
        p[M - i] = t
    return p


def _init_S(p: np.ndarray, M: int, order: int, even_only: bool):
    ms = MSequence(order)
    S = np.zeros(M, np.complex64)
    count = 0
    for i in range(M):
        s = ms.generate_symbol(3) & 0x01
        if p[i] == SCTYPE_NULL:
            continue
        if even_only and (i % 2) != 0:
            continue
        S[i] = 1.0 if s else -1.0
        count += 1
    if count == 0:
        raise ValueError("ofdm frame: no subcarriers enabled; check "
                         "allocation")
    # time domain: unnormalized inverse FFT scaled by 1/sqrt(count)
    s_t = np.fft.ifft(S) * M / np.sqrt(count)
    return S, s_t.astype(np.complex64), count


def ofdm_params(M: int = 64, cp_len: int = 16,
                taper_len: int = 0, p=None) -> OFDMParams:
    if p is None:
        p = default_sctype(M)
    p = np.asarray(p, np.uint8)
    m = int(np.ceil(np.log2(M)))
    m = min(max(m, 4), 8)
    S0, s0, M_S0 = _init_S(p, M, m, even_only=True)
    S1, s1, M_S1 = _init_S(p, M, m + 1, even_only=False)
    M_null = int(np.sum(p == SCTYPE_NULL))
    M_pilot = int(np.sum(p == SCTYPE_PILOT))
    M_data = int(np.sum(p == SCTYPE_DATA))
    if M_pilot < 2:
        raise ValueError("ofdm frame requires at least two pilot "
                         "subcarriers")
    return OFDMParams(M, cp_len, taper_len, p, S0, s0, S1, s1,
                      M_null, M_pilot, M_data)


def _pilot_order(params: "OFDMParams") -> np.ndarray:
    """Pilot bins in the reference's traversal order: the writesymbol
    loop visits bins k=(i+M/2)%M for i ascending (ofdmframegen.c:290),
    so the pilot msequence is consumed in fftshifted bin order."""
    M = params.M
    k = (np.arange(M) + M // 2) % M
    return k[np.asarray(params.p)[k] == SCTYPE_PILOT]


def _pilot_sequence(n_pilots: int, n_syms: int) -> np.ndarray:
    """Per-symbol pilot values [n_syms, n_pilots] from msequence(8)
    (reference ofdmframegen.c:168, one advance per pilot per symbol),
    ordered as _pilot_order traverses the bins."""
    ms = MSequence(8)
    out = np.zeros((n_syms, n_pilots), np.float32)
    for s in range(n_syms):
        for j in range(n_pilots):
            out[s, j] = 1.0 if ms.advance() else -1.0
    return out


def _symbolize(params: OFDMParams, X: np.ndarray) -> np.ndarray:
    """Freq symbol [.., M] -> time samples [.., cp+M] (no taper)."""
    x = np.fft.ifft(X, axis=-1) * params.M
    return np.concatenate([x[..., params.M - params.cp_len:], x], axis=-1)


def ofdm_generate_frame(params: OFDMParams, data_syms) -> np.ndarray:
    """Assemble a frame: [S0, S0, S1, payload symbols].

    data_syms: [n_syms, M_data] modulated data points.
    Returns time samples [(3 + n_syms) * (M + cp_len)].
    """
    M, cp = params.M, params.cp_len
    data_syms = np.atleast_2d(np.asarray(data_syms))
    n_syms = data_syms.shape[0]
    if data_syms.shape[1] != params.M_data:
        raise ValueError(f"expected {params.M_data} data symbols per OFDM "
                         f"symbol, got {data_syms.shape[1]}")
    g = 1.0 / np.sqrt(params.M_pilot + params.M_data)
    pilots = _pilot_sequence(params.M_pilot, n_syms)
    pil_idx = _pilot_order(params)
    dat_idx = np.nonzero(params.p == SCTYPE_DATA)[0]
    X = np.zeros((n_syms, M), np.complex64)
    X[:, pil_idx] = pilots * g
    X[:, dat_idx] = data_syms * g
    payload = _symbolize(params, X).reshape(-1)
    # preamble: S0 twice + S1.  The first S0 symbol is rotated by TWO
    # cp lengths, the second by one (reference ofdmframegen_write_S0a/b)
    # so the pair is contiguous in the s0 sequence's own period.
    idx_a = (np.arange(M + cp) + M - 2 * cp) % M
    idx_b = (np.arange(M + cp) + M - cp) % M
    s1_sym = np.concatenate([params.s1[M - cp:], params.s1])
    return np.concatenate([params.s0[idx_a], params.s0[idx_b], s1_sym,
                           payload]).astype(np.complex64)


class OFDMSyncResult(NamedTuple):
    detected: bool
    sample_index: int
    cfo_hat: float
    data_syms: Optional[np.ndarray]   # [n_syms, M_data]
    evm_db: float


_CORE_CACHE: dict = {}


def _sync_core(params: OFDMParams, n_syms: int, threshold: float):
    """Build the jittable synchronizer core for one frame geometry.

    Everything below is static-shape jnp with numpy closure constants
    (complex constants kept as float planes; numpy closures are inlined
    by XLA).  x -> (detected, best_idx, cfo, data, evm_db).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    M, cp = params.M, params.cp_len
    M2 = M // 2
    W0 = M + cp                       # plateau window
    W1 = 3 * (M + cp) + M             # S1 search window
    s1 = params.s1.astype(np.complex64)
    s1c_re = s1.conj().real.astype(np.float32)
    s1c_im = s1.conj().imag.astype(np.float32)
    s1_e = float(np.sum(np.abs(s1) ** 2))
    on_idx = np.nonzero(params.p != SCTYPE_NULL)[0].astype(np.int32)
    S1_on = params.S1[on_idx] * np.sqrt(params.M_pilot + params.M_data)
    S1i_re = (1.0 / S1_on).real.astype(np.float32)
    S1i_im = (1.0 / S1_on).imag.astype(np.float32)
    pil_idx = _pilot_order(params).astype(np.int32)
    dat_idx = np.nonzero(params.p == SCTYPE_DATA)[0].astype(np.int32)
    pilots = _pilot_sequence(params.M_pilot, n_syms)     # [n_syms, npil] +-1
    # signed frequency index per bin (for the timing-slope correction)
    k_signed = (((np.arange(M) + M2) % M) - M2).astype(np.float32)
    order = np.argsort(k_signed[pil_idx], kind="stable")
    kk = k_signed[pil_idx][order]                        # ascending
    dk = np.diff(kk)                                     # static spacing
    scale = float(np.sqrt(params.M_pilot + params.M_data))

    def core(x):
        T = x.shape[0]
        t32 = jnp.arange(T, dtype=jnp.float32)
        # --- 1. Schmidl-Cox autocorrelation over the whole capture ---
        from ..ops.fir import fir_apply_matmul
        prod = x[M2:] * jnp.conj(x[:-M2])
        # window sums as ones-tap banded matmuls — cumsum-and-difference
        # was far slower on the accelerator this was first tuned on (not
        # measured on H100)
        pr, _ = fir_apply_matmul(
            jnp.ones(M2, jnp.float32), jnp.zeros((M2 - 1,), prod.dtype),
            prod)
        P = pr[M2 - 1:]               # window-M/2 sum at each offset
        en = jnp.abs(x).astype(jnp.float32) ** 2
        er, _ = fir_apply_matmul(
            jnp.ones(M, jnp.float32), jnp.zeros((M - 1,), jnp.float32), en)
        R = er[M - 1:]
        L = min(int(P.shape[0]), int(R.shape[0]))
        metric = jnp.abs(P[:L]) / jnp.maximum(R[:L], 1e-12) * 2.0
        from .. import debug
        debug.tap("ofdm.metric", metric)    # Schmidl-Cox trajectory
        hit = metric > threshold
        detected = jnp.any(hit)
        d0 = jnp.argmax(hit).astype(jnp.int32)           # first True
        # plateau: advance to the local max within one symbol
        mpad = jnp.concatenate([metric, jnp.full(W0, -jnp.inf, metric.dtype)])
        seg = lax.dynamic_slice(mpad, (d0,), (W0,))
        d0 = d0 + jnp.argmax(seg).astype(jnp.int32)
        cfo = jnp.angle(P[jnp.minimum(d0, L - 1)]) / M2
        # --- 2. de-rotate; S1 by ONE batched cross-correlation ---
        xc = x * lax.complex(jnp.cos(cfo * t32), -jnp.sin(cfo * t32))
        # contiguous span via dynamic_slice + STATIC windowing (a
        # traced-index jnp.take here serialized on the accelerator this
        # was first tuned on — same fix as stream_rx.mf_symbol_gather)
        body_len = n_syms * (M + cp)
        xpad = jnp.concatenate(
            [xc, jnp.zeros(W1 + M + body_len, xc.dtype)])
        span = lax.dynamic_slice(xpad, (d0,), (W1 + M - 1,))
        win = span[np.arange(W1)[:, None] + np.arange(M)[None, :]]
        s1c = lax.complex(jnp.asarray(s1c_re), jnp.asarray(s1c_im))
        V = win @ s1c
        m1 = jnp.abs(V) / s1_e
        best = jnp.argmax(m1).astype(jnp.int32)
        best_idx = d0 + best
        # --- 3. per-subcarrier channel estimate from S1 ---
        S1_rx = jnp.fft.fft(lax.dynamic_slice(xpad, (best_idx,), (M,)))
        S1inv = lax.complex(jnp.asarray(S1i_re), jnp.asarray(S1i_im))
        vals = S1_rx[jnp.asarray(on_idx)] * S1inv
        # smooth across enabled bins (reference smoothing), keep ends
        sm = jnp.convolve(vals, jnp.ones(3, vals.dtype) / 3.0, mode="same")
        sm = sm.at[0].set(vals[0]).at[-1].set(vals[-1])
        Gs = jnp.zeros(M, xc.dtype).at[jnp.asarray(on_idx)].set(sm)
        # --- 4. batched payload FFT + EQ ---
        payload_start = best_idx + M
        need = payload_start + body_len
        detected = detected & (need <= T)
        body = lax.dynamic_slice(xpad, (payload_start,), (body_len,))
        body = body.reshape(n_syms, M + cp)[:, cp:]
        Xr = jnp.fft.fft(body, axis=-1) / scale
        inv = jnp.where(jnp.abs(Gs) > 1e-9, 1.0 / jnp.where(
            jnp.abs(Gs) > 1e-9, Gs, 1.0), 0.0)
        Xeq = Xr * inv[None, :]
        # --- 5. per-symbol pilot tracking: residual phase AND timing
        # slope (reference ofdmframesync.c:876+ estimates both from the
        # pilots each symbol and drives its NCO/sampler with them) ---
        q = (Xeq[:, jnp.asarray(pil_idx)] * pilots)[:, order]  # [n, npil]
        dphi_n = jnp.angle(q[:, 1:] * jnp.conj(q[:, :-1]))     # neighbor
        b_s = jnp.sum(dphi_n * dk[None, :], axis=1) / float(np.sum(dk ** 2))
        rot = b_s[:, None] * kk[None, :]
        a_s = jnp.angle(jnp.sum(
            q * lax.complex(jnp.cos(rot), -jnp.sin(rot)), axis=1))
        ph_all = a_s[:, None] + b_s[:, None] * k_signed[None, :]
        Xeq = Xeq * lax.complex(jnp.cos(ph_all), -jnp.sin(ph_all))
        data = Xeq[:, jnp.asarray(dat_idx)]
        # --- 6. pilot-referenced stats ---
        perr = Xeq[:, jnp.asarray(pil_idx)] * pilots - 1.0
        evm_db = 20.0 * jnp.log10(
            jnp.sqrt(jnp.mean(jnp.abs(perr) ** 2)) + 1e-12)
        # residual CFO from the symbol-to-symbol pilot phase advance
        da = jnp.angle(jnp.mean(jnp.exp(1j * (a_s[1:] - a_s[:-1])))) \
            if n_syms > 1 else jnp.float32(0.0)
        cfo_out = cfo + da / (M + cp)
        return detected, best_idx, cfo_out, data, evm_db

    return jax.jit(core)


_DEMOD_CACHE: dict = {}


def ofdm_demod_consts(params: OFDMParams, n_syms: int) -> dict:
    """Numpy constants for the per-candidate frame demodulator (float
    planes only).  Shared by frame_demod_core and the full-device
    streaming receiver (framing/ofdmflex_stream.py)."""
    M, cp = params.M, params.cp_len
    M2 = M // 2
    W1 = 3 * (M + cp) + M
    body_len = n_syms * (M + cp)
    s1 = params.s1.astype(np.complex64)
    on_idx = np.nonzero(params.p != SCTYPE_NULL)[0].astype(np.int32)
    S1_on = params.S1[on_idx] * np.sqrt(params.M_pilot + params.M_data)
    pil_idx = _pilot_order(params).astype(np.int32)
    k_signed = (((np.arange(M) + M2) % M) - M2).astype(np.float32)
    order = np.argsort(k_signed[pil_idx], kind="stable")
    kk = k_signed[pil_idx][order]
    return {
        "M": M, "cp": cp, "n_syms": int(n_syms),
        "W1": W1, "body_len": body_len, "WIN": W1 + M + body_len,
        "s1c_re": s1.conj().real.astype(np.float32),
        "s1c_im": s1.conj().imag.astype(np.float32),
        "s1_e": float(np.sum(np.abs(s1) ** 2)),
        "on_idx": on_idx,
        "S1i_re": (1.0 / S1_on).real.astype(np.float32),
        "S1i_im": (1.0 / S1_on).imag.astype(np.float32),
        "pil_idx": pil_idx,
        "dat_idx": np.nonzero(params.p == SCTYPE_DATA)[0].astype(np.int32),
        "pilots": _pilot_sequence(params.M_pilot, n_syms),
        "k_signed": k_signed, "order": order, "kk": kk,
        "dk": np.diff(kk),
        "scale": float(np.sqrt(params.M_pilot + params.M_data)),
    }


def ofdm_s1_search(dc: dict, wa, cfo0):
    """Batched S1 timing search over candidate slots (stage A of the
    frame demod, split out so streaming receivers avoid vmapped
    dynamic slices).

    wa: [..., 2, WA] float planes of the RAW window at the S0 plateau
    (WA = W1 + M - 1); cfo0: [...] coarse CFO.  Returns best [...,]
    int32, the S1 offset in [0, W1).  The S1 cross-correlation runs as
    ONE feature-grouped conv over the planes instead of the [W1, M]
    im2col gather + matmul (static fancy indexing with a conv closed
    form — the suspect pattern, CLAUDE.md); argmax of |V|^2 picks the
    same lag as argmax of |V|/s1_e (monotonic, same ties)."""
    import jax.numpy as jnp
    from jax import lax

    M, W1 = dc["M"], dc["W1"]
    WA = W1 + M - 1
    t = jnp.arange(WA, dtype=jnp.float32)
    ph = cfo0[..., None] * t
    c, s = jnp.cos(ph), jnp.sin(ph)
    xr = wa[..., 0, :] * c + wa[..., 1, :] * s
    xi = wa[..., 1, :] * c - wa[..., 0, :] * s
    X = jnp.stack([xr, xi], axis=-2)                  # [..., 2, WA]
    sr, si = dc["s1c_re"], dc["s1c_im"]
    kern = jnp.asarray(np.stack([np.stack([sr, -si], 0),
                                 np.stack([si, sr], 0)], 0))  # [2,2,M]
    lead = X.shape[:-2]
    V = lax.conv_general_dilated(
        X.reshape((-1, 2, WA)), kern, (1,), "VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=lax.Precision.HIGHEST)              # [N, 2, W1]
    V = V.reshape(lead + (2, W1))
    mag = V[..., 0, :] ** 2 + V[..., 1, :] ** 2
    return jnp.argmax(mag, axis=-1).astype(jnp.int32)


def ofdm_demod_body(dc: dict, wb, cfo, best):
    """Stage B of the frame demod: channel estimate + CP-strip FFT +
    EQ + pilot tracking from an ALREADY-S1-ALIGNED raw window.

    wb: [2, M + body_len] float planes sliced at (plateau + best);
    cfo scalar; best int32 (the derotation phase index starts at
    `best`, so outputs are bit-compatible with ofdm_demod_window).
    Returns (data, perr, cfo_out); vmap-batchable."""
    import jax.numpy as jnp
    from jax import lax

    M, cp = dc["M"], dc["cp"]
    body_len, n_syms = dc["body_len"], dc["n_syms"]
    t = best.astype(jnp.float32) + jnp.arange(M + body_len,
                                              dtype=jnp.float32)
    ph = cfo * t
    xc = lax.complex(wb[0], wb[1]) * lax.complex(jnp.cos(ph),
                                                 -jnp.sin(ph))
    S1_rx = jnp.fft.fft(xc[:M])
    S1inv = lax.complex(jnp.asarray(dc["S1i_re"]),
                        jnp.asarray(dc["S1i_im"]))
    vals = S1_rx[jnp.asarray(dc["on_idx"])] * S1inv
    sm = jnp.convolve(vals, jnp.ones(3, vals.dtype) / 3.0, mode="same")
    sm = sm.at[0].set(vals[0]).at[-1].set(vals[-1])
    Gs = jnp.zeros(M, xc.dtype).at[jnp.asarray(dc["on_idx"])].set(sm)
    body = xc[M:].reshape(n_syms, M + cp)[:, cp:]
    Xr = jnp.fft.fft(body, axis=-1) / dc["scale"]
    nz = jnp.abs(Gs) > 1e-9
    inv = jnp.where(nz, 1.0 / jnp.where(nz, Gs, 1.0), 0.0)
    Xeq = Xr * inv[None, :]
    pilots, order = dc["pilots"], dc["order"]
    kk, dk, k_signed = dc["kk"], dc["dk"], dc["k_signed"]
    q = (Xeq[:, jnp.asarray(dc["pil_idx"])] * pilots)[:, order]
    dphi_n = jnp.angle(q[:, 1:] * jnp.conj(q[:, :-1]))
    b_s = jnp.sum(dphi_n * dk[None, :], axis=1) / float(np.sum(dk ** 2))
    rot = b_s[:, None] * kk[None, :]
    a_s = jnp.angle(jnp.sum(
        q * lax.complex(jnp.cos(rot), -jnp.sin(rot)), axis=1))
    ph_all = a_s[:, None] + b_s[:, None] * k_signed[None, :]
    Xeq = Xeq * lax.complex(jnp.cos(ph_all), -jnp.sin(ph_all))
    data = Xeq[:, jnp.asarray(dc["dat_idx"])]
    perr = Xeq[:, jnp.asarray(dc["pil_idx"])] * pilots - 1.0
    da = jnp.angle(jnp.mean(jnp.exp(1j * (a_s[1:] - a_s[:-1])))) \
        if n_syms > 1 else jnp.float32(0.0)
    return data, perr, cfo + da / (M + cp)


def ofdm_demod_window(dc: dict, win, cfo):
    """Demodulate one frame from a raw window (position 0 = coarse S0
    plateau index): S1 timing by one matmul cross-correlation, per-
    subcarrier channel estimate, CP-strip + batched FFT + EQ, pilot
    phase AND timing-slope tracking.  Same math as _sync_core steps
    2-6; the constant carrier phase difference from de-rotating
    relative to the window start (instead of the capture start) folds
    into the S1 channel estimate.  jnp function of (win[WIN] complex,
    cfo scalar) -> (s1_off, data[n_syms, M_data], perr[n_syms, n_pil],
    cfo_out); vmap-batchable over candidates.
    """
    import jax.numpy as jnp
    from jax import lax

    M = dc["M"]
    W1, body_len = dc["W1"], dc["body_len"]
    # stage A: S1 timing search on the short front window (the split
    # — ofdm_s1_search replaces the [W1, M] im2col gather + matmul with
    # a conv; same argmax); stage B: demod from the aligned slice.  The
    # single dynamic_slice here is fine for this single-candidate path
    # (streaming receivers slice per candidate in a fori_loop instead —
    # a VMAPPED dynamic_slice can lower to a sequential loop).
    WA = W1 + M - 1
    wa = jnp.stack([jnp.real(win[:WA]), jnp.imag(win[:WA])])
    best = ofdm_s1_search(dc, wa, jnp.asarray(cfo))
    planes = jnp.stack([jnp.real(win), jnp.imag(win)])
    wb = lax.dynamic_slice(planes, (0, best), (2, M + body_len))
    data, perr, cfo_out = ofdm_demod_body(dc, wb, cfo, best)
    return best, data, perr, cfo_out


def frame_demod_core(params: OFDMParams, n_syms: int):
    """Cached jittable per-candidate frame demodulator for streaming
    receivers: window in (position 0 = coarse S0 plateau index), frame
    out.  Returns (fn, win_len) where
    fn(win[win_len], cfo) -> (s1_off, data[n_syms, M_data],
    perr[n_syms, n_pil], cfo_out).  See ofdm_demod_window.
    """
    key = (params.M, params.cp_len, params.taper_len, params.p.tobytes(),
           int(n_syms))
    hit = _DEMOD_CACHE.get(key)
    if hit is not None:
        return hit
    import jax
    dc = ofdm_demod_consts(params, int(n_syms))
    out = (jax.jit(lambda win, cfo: ofdm_demod_window(dc, win, cfo)),
           dc["WIN"])
    _DEMOD_CACHE[key] = out
    return out


def s0_detect_block(buf, last_end, M: int, threshold: float, span: int,
                    T: int, n_chunk: int, P_: int, CH: int = 256):
    """Streaming Schmidl-Cox S0 detection over one buffer [hist+T]:
    plateau metric + per-chunk local max + in-order suppression.
    Returns (valid[P], d0[P] buffer coords, cfo[P], peak[P], cand,
    pos, n_cand) — the detection half shared by ofdm_detector_stream
    and the full-device ofdmflex receiver."""
    import jax.numpy as jnp
    from jax import lax
    from ..ops.fir import fir_apply_matmul

    M2 = M // 2
    prod = buf[M2:] * jnp.conj(buf[:-M2])
    # windowed sums as banded-tap matmuls (ones taps; the cumsum form
    # was far slower on the accelerator this was first tuned on, not
    # measured on H100); forward window of width W is the causal box
    # sum shifted by W-1
    pr, _ = fir_apply_matmul(
        jnp.ones(M2, jnp.float32), jnp.zeros((M2 - 1,), prod.dtype), prod)
    Pm = pr[M2 - 1:]
    en = jnp.abs(buf).astype(jnp.float32) ** 2
    er, _ = fir_apply_matmul(
        jnp.ones(M, jnp.float32), jnp.zeros((M - 1,), jnp.float32), en)
    R = er[M - 1:]
    Lm = n_chunk * CH
    metric = jnp.abs(Pm[:Lm]) / jnp.maximum(R[:Lm], 1e-12) * 2.0
    mc = metric.reshape(n_chunk, CH)
    pk = jnp.max(mc, axis=-1)
    pos = jnp.asarray(np.arange(n_chunk) * CH, jnp.int32) + \
        jnp.argmax(mc, axis=-1).astype(jnp.int32)
    neg = jnp.full((1,), -jnp.inf, pk.dtype)
    local = (pk > jnp.concatenate([neg, pk[:-1]])) & \
        (pk >= jnp.concatenate([pk[1:], neg]))
    cand = (pk > threshold) & (pos < T) & local

    def _suppress(le, ci):
        cnd, p = ci
        keep = cnd & (p >= le)
        return jnp.where(keep, p + span, le), keep

    _, keeps = lax.scan(_suppress, last_end, (cand, pos), unroll=32)
    cand = keeps
    n_cand = jnp.sum(cand)
    sel = jnp.nonzero(cand, size=P_, fill_value=0)[0]
    valid = jnp.arange(P_) < n_cand
    d0 = pos[sel]
    peak = pk[sel]
    cfo = jnp.angle(Pm[jnp.minimum(d0, Lm - 1)]) / M2
    return valid, d0, cfo, peak, cand, pos, n_cand


def ofdm_detector_stream(block_len: int, params: OFDMParams,
                         threshold: float = 0.7, max_frames: int = 4,
                         suppress_span: int | None = None,
                         name: str = "ofdm_detector_stream"):
    """Streaming Schmidl-Cox S0 detector as a jittable block Proc.

    apply(params_, carry, x[..., block_len]) -> ((valid, sample_index,
    cfo, metric), carry').  sample_index is the absolute coarse plateau
    position (feed frame_demod_core a window starting there); the
    suppression watermark re-arms after `suppress_span` samples
    (reference ofdmframesync re-arms after consuming the frame).
    Detection math: the plateau metric of _sync_core, segmented into
    256-sample chunks with per-chunk local-max selection — the same
    block-invariance argument as stream_rx (the chunk grid is absolute
    -aligned because block_len % 256 == 0).
    """
    import jax
    import jax.numpy as jnp
    from ..core import Proc

    T = int(block_len)
    CH = 256
    if T % CH != 0:
        raise ValueError("block_len must be a multiple of %d" % CH)
    M, cp = params.M, params.cp_len
    P_ = int(max_frames)
    hist = 1536
    span = int(suppress_span if suppress_span is not None
               else 3 * (M + cp) + M)
    n_chunk = (hist + T - M) // CH      # chunks fully covered by metric

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"buf": jnp.zeros(batch_shape + (hist,), jnp.complex64),
                "base": jnp.full(batch_shape, -hist, jnp.int32),
                "last_end": jnp.full(batch_shape, -(1 << 30), jnp.int32)}

    def _apply_1d(carry, x):
        buf = jnp.concatenate([carry["buf"], x.astype(jnp.complex64)],
                              axis=-1)
        valid, d0, cfo, peak, cand, pos, n_cand = s0_detect_block(
            buf, carry["last_end"], M, threshold, span, T, n_chunk, P_, CH)
        out = (valid, carry["base"] + d0, cfo, peak)
        last_n0 = jnp.max(jnp.where(cand, pos, -(1 << 30)))
        new_last = jnp.maximum(
            carry["last_end"],
            jnp.where(n_cand > 0, last_n0 + span, -(1 << 30))) - T
        new_carry = {"buf": buf[..., T:], "base": carry["base"] + T,
                     "last_end": jnp.maximum(new_last, -(1 << 30))}
        return out, new_carry

    def apply(params_, carry, x):
        if x.ndim == 1:
            return _apply_1d(carry, x)
        batch = x.shape[:-1]
        xf = x.reshape((-1, T))
        cf = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[len(batch):]), carry)
        out, nc = jax.vmap(_apply_1d)(cf, xf)
        out = jax.tree_util.tree_map(
            lambda a: a.reshape(batch + a.shape[1:]), out)
        nc = jax.tree_util.tree_map(
            lambda a: a.reshape(batch + a.shape[1:]), nc)
        return out, nc

    return Proc(params=(), init=init, apply=apply, rate=(1, 1), name=name)


def ofdm_frame_sync(params: OFDMParams, x, n_syms: int,
                    threshold: float = 0.7) -> OFDMSyncResult:
    """Block-native OFDM synchronizer (jittable end-to-end).

    1. Schmidl-Cox autocorrelation on the half-symbol-periodic S0
       (coarse timing + carrier offset; reference execute_seekplcp).
    2. S1 timing by one batched matmul cross-correlation.
    3. Per-subcarrier channel estimate from S1 (reference _S1 EQ init).
    4. Batched payload FFT + EQ + per-symbol pilot phase AND timing-
       slope tracking (reference ofdmframesync.c:876+).

    evm_db is pilot-referenced: rms error of the equalized, corrected
    pilot bins against their known +-1 values (modulation-independent).
    """
    import jax.numpy as jnp
    x = np.asarray(x, np.complex64)
    key = (params.M, params.cp_len, params.taper_len, params.p.tobytes(),
           int(n_syms), float(threshold))
    core = _CORE_CACHE.get(key)
    if core is None:
        core = _CORE_CACHE[key] = _sync_core(params, int(n_syms),
                                             float(threshold))
    det, best_idx, cfo, data, evm_db = core(jnp.asarray(x))
    if not bool(np.asarray(det)):
        return OFDMSyncResult(False, int(np.asarray(best_idx)),
                              float(np.asarray(cfo)), None, 0.0)
    return OFDMSyncResult(True, int(np.asarray(best_idx)),
                          float(np.asarray(cfo)), np.asarray(data),
                          float(np.asarray(evm_db)))
