"""qdetector: FFT-based preamble detection with carrier-offset sweep.

Reference analog (studied, not copied): reference src/framing/src/
qdetector_cccf.c:48-441 — buffer 2*s_len samples, nfft-point FFT,
cross-correlate against the frequency-domain template over +-range
frequency-bin offsets, peak -> (timing tau, carrier dphi/phi, gain
gamma).

Design (SURVEY.md §7: "detect everywhere"): instead of the
reference's per-sample state machine, the whole capture is processed as
a batch of half-overlapped nfft segments — one batched FFT, a batched
conjugate multiply per frequency offset, one batched IFFT, one argmax.
The refinement stage (quadratic timing interpolation + fine carrier
estimate from the aligned window) is identical math to the reference's
align state.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

__all__ = ["DetectorResult", "make_template", "qdetector_detect"]


class DetectorResult(NamedTuple):
    detected: bool
    sample_index: int     # integer sample index of sequence start
    tau_hat: float        # fractional timing offset [-0.5, 0.5]
    dphi_hat: float       # carrier frequency offset [rad/sample]
    phi_hat: float        # carrier phase offset [rad]
    gamma_hat: float      # channel gain estimate
    rxy: float            # peak normalized correlation


def make_template(sequence, interp_proc=None) -> np.ndarray:
    """Time-domain detection template (reference
    qdetector_cccf_create_linear: interpolated sequence + filter tail)."""
    if interp_proc is None:
        return np.asarray(sequence, np.complex64)
    import jax.numpy as jnp
    seq = np.asarray(sequence, np.complex64)
    y, _ = interp_proc(jnp.asarray(seq), batch_shape=())
    k = interp_proc.rate[0]
    # flush the filter tail (2m symbols of zeros)
    n_flush = (interp_proc.params["hp"].shape[-1] - 1)
    tail, _ = interp_proc.apply(
        interp_proc.params,
        interp_proc(jnp.asarray(seq), batch_shape=())[1],
        jnp.zeros(2 * n_flush, jnp.complex64))
    s = np.concatenate([np.asarray(y), np.asarray(tail)])
    return s


def qdetector_detect(x, s, threshold: float = 0.5, range_bins: int = 2):
    """Detect template s in capture x; returns DetectorResult.

    Block-native equivalent of reference qdetector_cccf_execute_seek
    (:373-441) + execute_align.
    """
    x = jnp.asarray(x)
    s = np.asarray(s, np.complex64)
    s_len = len(s)
    nfft = 1 << int(np.ceil(np.log2(2 * s_len)))
    hop = nfft // 2
    T = x.shape[-1]
    n_seg = max(1, (T - nfft) // hop + 1)
    # segment windows [n_seg, nfft]
    starts = np.arange(n_seg) * hop
    idx = starts[:, None] + np.arange(nfft)[None, :]
    xpad = jnp.concatenate(
        [x, jnp.zeros(max(0, int(idx.max()) + 1 - T), x.dtype)])
    segs = jnp.take(xpad, jnp.asarray(idx), axis=-1)     # [n_seg, nfft]
    Xf = jnp.fft.fft(segs, axis=-1)
    S = np.fft.fft(s, nfft)
    s2_sum = float(np.sum(np.abs(s) ** 2))
    # per-segment normalization (reference g0/g computation :392-394)
    x2 = jnp.sum(jnp.abs(segs) ** 2, axis=-1)
    g0 = jnp.sqrt(x2) * np.sqrt(s_len / nfft)
    g = 1.0 / (nfft * jnp.maximum(g0, 1e-12) * np.sqrt(s2_sum))
    offsets = np.arange(-range_bins, range_bins + 1)
    # shifted template spectra [n_off, nfft]
    So = np.stack([np.roll(S, off) for off in offsets])
    R = jnp.fft.ifft(Xf[:, None, :] * jnp.conj(jnp.asarray(So))[None],
                     axis=-1) * nfft                     # [n_seg, n_off, nfft]
    rxy = jnp.abs(R) * g[:, None, None]
    rxy_np = np.asarray(rxy)
    # earliest segment whose correlation exceeds the threshold — matches
    # the reference's sequential seek (first frame wins, not the loudest)
    seg_peaks = rxy_np.max(axis=(1, 2))
    hits = np.nonzero(seg_peaks > threshold)[0]
    if len(hits) == 0:
        return DetectorResult(False, 0, 0.0, 0.0, 0.0, 0.0,
                              float(seg_peaks.max()))
    seg_i = int(hits[0])
    # peak may straddle the hop boundary; also consider the next segment
    # if it improves the correlation (same frame, later window)
    if seg_i + 1 < n_seg and seg_peaks[seg_i + 1] > seg_peaks[seg_i]:
        seg_i += 1
    off_i, lag_i = np.unravel_index(np.argmax(rxy_np[seg_i]),
                                    rxy_np[seg_i].shape)
    peak = float(rxy_np[seg_i, off_i, lag_i])

    n0 = int(starts[seg_i] + lag_i)
    offset = int(offsets[off_i])

    # --- refinement on the aligned window (reference execute_align) ---
    xa = np.asarray(xpad[n0: n0 + nfft])
    if len(xa) < nfft:
        xa = np.concatenate([xa, np.zeros(nfft - len(xa), xa.dtype)])
    Xa = np.fft.fft(xa)
    Ra = np.fft.ifft(Xa * np.conj(np.roll(S, offset))) * nfft
    g_here = 1.0 / (nfft * np.sqrt(np.sum(np.abs(xa[:s_len]) ** 2) *
                                   s_len / s_len) * np.sqrt(s2_sum))
    yneg = np.sqrt(np.abs(Ra[-1]))
    y0 = np.sqrt(np.abs(Ra[0]))
    ypos = np.sqrt(np.abs(Ra[1]))
    a = 0.5 * (ypos + yneg) - y0
    b = 0.5 * (ypos - yneg)
    tau_hat = float(-b / (2 * a)) if a != 0 else 0.0
    g_hat = a * tau_hat ** 2 + b * tau_hat + y0
    gamma_hat = float(g_hat * g_hat / (nfft * s2_sum))

    # fine carrier estimate: FFT of aligned window times conj(template)
    w = xa.copy()
    w[:s_len] *= np.conj(s)
    w[s_len:] = 0
    W = np.fft.fft(w)
    i0 = int(np.argmax(np.abs(W)))
    vneg = np.abs(W[(i0 - 1) % nfft])
    v0 = np.abs(W[i0])
    vpos = np.abs(W[(i0 + 1) % nfft])
    a2 = 0.5 * (vpos + vneg) - v0
    b2 = 0.5 * (vpos - vneg)
    idx2 = float(-b2 / (2 * a2)) if a2 != 0 else 0.0
    index = i0 + idx2
    if i0 > nfft / 2:
        index -= nfft
    dphi_hat = float(index * 2 * np.pi / nfft)
    phi_hat = float(np.angle(W[i0]))
    return DetectorResult(True, n0, tau_hat, dphi_hat, phi_hat,
                          gamma_hat, peak)
