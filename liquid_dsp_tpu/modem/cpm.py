"""Continuous-phase modems: M-ary FSK, GMSK, CPFSK.

Reference analogs (studied, not copied):
  * fskmod/fskdem   — src/modem/src/fskmod.c:130-145 (per-symbol NCO tone,
                      phase-continuous), fskdem.c:160-210 (K-point FFT,
                      peak over tone-bin map; K chosen in [k, max(16,4k)]
                      minimizing fractional bin error, fskdem.c:93-118).
  * gmskmod/gmskdem — gmskmod.c:75-140 (NRZ +-1/k -> GMSK TX pulse interp
                      -> phase integrate -> exp), gmskdem.c:196-247 (phase
                      derivative -> matched filter -> k:1 decimation ->
                      sign slice).
  * cpfskmod/cpfskdem — cpfskmod.c:104-250 (pulse types square / rcos-full
                      / rcos-partial / gmsk, area-normalized and scaled by
                      pi*h; NRZ v = 2s-M+1, cpfskmod.c:226), cpfskdem.c
                      (phase-derivative demodulation).

Design: symbols arrive as a block [..., N]; pulse shaping is one
transposed convolution, phase integration is one cumsum, and the carrier
exponential is one elementwise exp — all fused by XLA.  Demodulators
compute the whole block's phase derivative at once; the FSK demodulator is
a batched [N, k] x [k, K] DFT matmul.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import Proc
from ..ops.fir import fir_apply_auto
from ..design.firdes import firdes_gmsktx, firdes_gmskrx

__all__ = ["fsk_modulator", "fsk_demodulator", "fsk_fft_size",
           "gmsk_modulator", "gmsk_demodulator",
           "cpfsk_pulse", "cpfsk_modulator", "cpfsk_demodulator"]


# ---------------------------------------------------------------------------
# M-ary FSK


def fsk_fft_size(m: int, k: int, bandwidth: float) -> int:
    """FFT size whose bin grid best matches the tone spacing
    (reference fskdem.c:93-118)."""
    M = 1 << m
    M2 = 0.5 * (M - 1)
    df = bandwidth / M2
    K_min, K_max = k, max(16, 4 * k)
    best_K, err_min = K_min, np.inf
    for K_hat in range(K_min, K_max + 1):
        v = 0.5 * df * K_hat
        err = abs(round(v) - v)
        if err < err_min:
            best_K, err_min = K_hat, err
        if err < 1e-6:
            break
    return best_K


def _fsk_dphi(m: int, bandwidth: float) -> np.ndarray:
    """Per-symbol phase increment per sample (reference fskmod.c:130-131)."""
    M = 1 << m
    M2 = 0.5 * (M - 1)
    s = np.arange(M)
    return ((s - M2) * 2.0 * np.pi * bandwidth / M2).astype(np.float32)


def fsk_modulator(m: int, k: int, bandwidth: float = 0.25,
                  name: str = "fskmod") -> Proc:
    """M-ary FSK modulator: symbols [..., N] -> samples [..., N*k].

    Phase-continuous across symbols and blocks (carry = phase).
    """
    if not (0.0 < bandwidth < 0.5):
        raise ValueError("fsk bandwidth must be in (0, 0.5)")
    dphi_tab = jnp.asarray(_fsk_dphi(m, bandwidth))

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape, jnp.float32)

    def apply(params, carry, s):
        dphi = jnp.take(params["dphi"], s)              # [..., N]
        per_sample = jnp.repeat(dphi, k, axis=-1)        # [..., N*k]
        # tone phase BEFORE stepping (reference computes cexp then steps)
        theta = carry[..., None] + jnp.cumsum(per_sample, axis=-1) - per_sample
        y = jnp.exp(1j * theta).astype(jnp.complex64)
        new_phase = jnp.mod(theta[..., -1] + per_sample[..., -1], 2 * np.pi)
        return y, new_phase

    return Proc(params={"dphi": dphi_tab}, init=init, apply=apply,
                rate=(k, 1), name=name)


def fsk_demodulator(m: int, k: int, bandwidth: float = 0.25,
                    name: str = "fskdem") -> Proc:
    """M-ary FSK demodulator: samples [..., N*k] -> symbols [..., N].

    Batched K-point DFT of each symbol's k samples; decision = peak
    magnitude over the M tone bins (reference fskdem.c:160-210).
    """
    M = 1 << m
    M2 = 0.5 * (M - 1)
    K = fsk_fft_size(m, k, bandwidth)
    # map each tone to its FFT bin (reference fskdem.c:120-134)
    freqs = (np.arange(M) - M2) * bandwidth / M2
    idx = np.round(freqs * K)
    demod_map = np.where(idx < 0, idx + K, idx).astype(np.int32)
    demod_map = jnp.asarray(demod_map % K)

    def init(batch_shape=(), dtype=jnp.complex64):
        return ()

    def apply(params, carry, y):
        T = y.shape[-1]
        if T % k:
            raise ValueError(f"fskdem block length {T} not a multiple of k={k}")
        blocks = y.reshape(y.shape[:-1] + (T // k, k))
        spec = jnp.fft.fft(blocks, n=K, axis=-1)
        mags = jnp.abs(jnp.take(spec, params["map"], axis=-1))
        return jnp.argmax(mags, axis=-1), carry

    return Proc(params={"map": demod_map}, init=init, apply=apply,
                rate=(1, k), name=name)


def fsk_frequency_error(y, m: int, k: int, bandwidth: float = 0.25):
    """Per-symbol frequency error estimate from the demod spectrum's
    peak-bin derivative (|V[b+1]| - |V[b-1]|) / |V[b]|.

    Reference analog: fskdem_get_frequency_error (fskdem.c:224-238) —
    NOTE the reference as shipped takes cabsf() of the bin INDEX, a
    bug; this implements the commented intent (derivative of the FFT
    magnitude around the winning tone bin, zero when the tone is
    centered).  Returns (symbols, ferr), both [..., N].

    Gather-free on device: bin indices are STATIC numpy arrays (tone,
    tone-1, tone+1 maps), and the per-symbol peak selection is a
    one-hot reduction over the M tones — no traced-index jnp.take /
    take_along_axis (CLAUDE.md gather rule)."""
    M = 1 << m
    M2 = 0.5 * (M - 1)
    K = fsk_fft_size(m, k, bandwidth)
    freqs = (np.arange(M) - M2) * bandwidth / M2
    idx = np.round(freqs * K)
    map0 = (np.where(idx < 0, idx + K, idx) % K).astype(np.int32)
    map_m = (map0 - 1) % K                   # static neighbor maps
    map_p = (map0 + 1) % K
    T = y.shape[-1]
    if T % k:
        raise ValueError(f"block length {T} not a multiple of k={k}")
    blocks = y.reshape(y.shape[:-1] + (T // k, k))
    spec = jnp.fft.fft(blocks, n=K, axis=-1)
    mag = jnp.abs(spec)
    tone = mag[..., map0]                    # [..., N, M] static gathers
    syms = jnp.argmax(tone, axis=-1)
    onehot = (syms[..., None] == jnp.arange(M)).astype(mag.dtype)
    v0 = jnp.sum(onehot * tone, axis=-1)
    vm = jnp.sum(onehot * mag[..., map_m], axis=-1)
    vp = jnp.sum(onehot * mag[..., map_p], axis=-1)
    return syms, (vp - vm) / jnp.maximum(v0, 1e-12)


# ---------------------------------------------------------------------------
# GMSK


def _interp_phase(ht, carry, x, k: int):
    """Zero-stuff x by k, filter with ht (returns phase increments)."""
    T = x.shape[-1]
    up = jnp.zeros(x.shape[:-1] + (T * k,), x.dtype)
    up = up.at[..., ::k].set(x)
    return fir_apply_auto(ht, carry, up)


def gmsk_modulator(k: int = 2, m: int = 3, bt: float = 0.3,
                   name: str = "gmskmod") -> Proc:
    """GMSK modulator: bits [..., N] -> samples [..., N*k]
    (reference gmskmod.c:75-140)."""
    ht = jnp.asarray(firdes_gmsktx(k, m, bt).astype(np.float32))
    L = int(ht.shape[-1])

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"tail": jnp.zeros(batch_shape + (L - 1,), jnp.float32),
                "theta": jnp.zeros(batch_shape, jnp.float32)}

    def apply(params, carry, bits):
        x = jnp.where(bits > 0, 1.0, -1.0).astype(jnp.float32) / k
        phi, tail = _interp_phase(params["ht"], carry["tail"], x, k)
        theta = carry["theta"][..., None] + jnp.cumsum(phi, axis=-1)
        y = jnp.exp(1j * theta).astype(jnp.complex64)
        new_carry = {"tail": tail,
                     "theta": jnp.mod(theta[..., -1] + np.pi, 2 * np.pi) - np.pi}
        return y, new_carry

    return Proc(params={"ht": ht}, init=init, apply=apply, rate=(k, 1),
                name=name)


def gmsk_demodulator(k: int = 2, m: int = 3, bt: float = 0.3,
                     soft: bool = False, name: str = "gmskdem") -> Proc:
    """GMSK demodulator: samples [..., N*k] -> bits [..., N]
    (reference gmskdem.c:196-247: phase derivative, matched filter,
    k:1 decimation, sign slice).  ``soft=True`` returns the pre-slice
    matched-filter output instead (float, positive = bit 1) — the
    per-bit soft metric that feeds the device block-FEC decoder
    (fec/device.py); sign-of-soft equals the hard bits exactly."""
    hr = firdes_gmskrx(k, m, bt).astype(np.float32)
    hr = hr / np.sum(np.abs(hr))  # bounded output scale
    hr = jnp.asarray(hr)
    L = int(hr.shape[-1])

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"x_prime": jnp.zeros(batch_shape, jnp.complex64),
                "tail": jnp.zeros(batch_shape + (L - 1,), jnp.float32)}

    def apply(params, carry, x):
        prev = jnp.concatenate([carry["x_prime"][..., None], x[..., :-1]],
                               axis=-1)
        phi = jnp.angle(jnp.conj(prev) * x + 1e-20)
        d, tail = fir_apply_auto(params["hr"], carry["tail"], phi)
        out = d[..., ::k] if soft else (d[..., ::k] > 0).astype(jnp.int32)
        new_carry = {"x_prime": x[..., -1], "tail": tail}
        return out, new_carry

    return Proc(params={"hr": hr}, init=init, apply=apply, rate=(1, k),
                name=name)


# ---------------------------------------------------------------------------
# CPFSK


def cpfsk_pulse(k: int, m: int, beta: float, kind: str) -> np.ndarray:
    """Phase pulse, area-normalized to 1 (reference cpfskmod.c firdes)."""
    if kind == "square":
        ht = np.ones(k)
    elif kind == "rcos_full":
        i = np.arange(k)
        ht = 1.0 - np.cos(2 * np.pi * i / k)
    elif kind == "rcos_partial":
        ht = np.zeros(3 * k)
        i = np.arange(2 * k)
        ht[i + k // 2] = 1.0 - np.cos(2 * np.pi * i / (2 * k))
    elif kind == "gmsk":
        ht = np.zeros(2 * k * m + k + 1)
        g = firdes_gmsktx(k, m, beta)
        ht[k // 2: k // 2 + len(g)] = g
    else:
        raise ValueError(f"unknown cpfsk pulse type {kind!r}")
    return (ht / np.sum(ht)).astype(np.float32)


def cpfsk_modulator(bps: int, h: float, k: int, m: int = 3,
                    beta: float = 0.35, kind: str = "square",
                    name: str = "cpfskmod") -> Proc:
    """CPFSK modulator: symbols [..., N] -> samples [..., N*k].

    Phase increments: NRZ v = 2s-M+1 (reference cpfskmod.c:226) shaped by
    the phase pulse scaled by pi*h (cpfskmod.c:147-149)."""
    M = 1 << bps
    ht = jnp.asarray(cpfsk_pulse(k, m, beta, kind) * np.pi * h)
    L = int(ht.shape[-1])

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"tail": jnp.zeros(batch_shape + (L - 1,), jnp.float32),
                "theta": jnp.zeros(batch_shape, jnp.float32)}

    def apply(params, carry, s):
        v = (2.0 * s - (M - 1)).astype(jnp.float32)
        phi, tail = _interp_phase(params["ht"], carry["tail"], v, k)
        # exclusive phase: the reference emits exp(j*theta) BEFORE
        # integrating the step (nco cexpf-then-step loop)
        csum = jnp.cumsum(phi, axis=-1)
        theta = carry["theta"][..., None] + (csum - phi)
        y = jnp.exp(1j * theta).astype(jnp.complex64)
        t_end = carry["theta"] + csum[..., -1]
        new_carry = {"tail": tail,
                     "theta": jnp.mod(t_end + np.pi, 2 * np.pi) - np.pi}
        return y, new_carry

    return Proc(params={"ht": ht}, init=init, apply=apply, rate=(k, 1),
                name=name)


def cpfsk_demodulator(bps: int, h: float, k: int, m: int = 3,
                      beta: float = 0.35, kind: str = "square",
                      name: str = "cpfskdem") -> Proc:
    """CPFSK demodulator (non-coherent phase-derivative form, reference
    cpfskdem.c): per-sample frequency -> matched accumulation over the
    symbol -> slice to nearest NRZ level."""
    M = 1 << bps
    ht = cpfsk_pulse(k, m, beta, kind)
    # matched filter = time-reversed pulse (symmetric pulses: identical)
    hr = jnp.asarray(ht[::-1].copy())
    L = int(hr.shape[-1])
    # combined TX-pulse + matched-filter group delay is L-1 samples
    # (each contributes a centroid delay of (L-1)/2); decimate there so
    # decisions land where the filtered frequency estimate plateaus
    offset = (L - 1) % k

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"x_prime": jnp.zeros(batch_shape, jnp.complex64),
                "tail": jnp.zeros(batch_shape + (L - 1,), jnp.float32)}

    def apply(params, carry, x):
        prev = jnp.concatenate([carry["x_prime"][..., None], x[..., :-1]],
                               axis=-1)
        phi = jnp.angle(jnp.conj(prev) * x + 1e-20)
        d, tail = fir_apply_auto(params["hr"], carry["tail"], phi)
        # instantaneous frequency scaled back to NRZ units
        v_hat = d[..., offset::k] * (k / (np.pi * h))
        s = jnp.clip(jnp.round((v_hat + (M - 1)) / 2.0), 0, M - 1)
        new_carry = {"x_prime": x[..., -1], "tail": tail}
        return s.astype(jnp.int32), new_carry

    return Proc(params={"hr": hr}, init=init, apply=apply, rate=(1, k),
                name=name)
