"""FFT plans, arbitrary-length transforms, DCT/DST, and streaming spectral
analysis.

Reference analogs (studied, not copied):
  * plan framework + method chooser — src/fft/src/fft_common.c:109-145,
    src/fft/src/fft_utilities.c:34-68 (codelets / mixed-radix / Rader)
  * r2r DCT/DST — src/fft/src/fft_r2r_1d.c (REDFT00..11, RODFT00..11)
  * spgram — src/fft/src/spgram.c (streaming Welch periodogram)
  * asgram — src/fft/src/asgram.c (ASCII spectrogram)

Design: XLA's native FFT covers power-of-two sizes at
speed-of-light; other sizes pick the fastest device formulation
(numerically equivalent to the reference's codelet/mixed-radix/Rader
plans within float32 tolerance — the *plan selection* semantics are
replicated, not the butterfly code): composite n with odd factor <= 2048
runs the four-step mixed-radix split (odd-factor DFT as ONE matmul
x 2^m XLA FFT); small odd/prime n runs the matmul DFT
outright; primes > 2048 run the Rader index-permutation plan (padded
2^m cyclic convolution); the residual odd-composite cases fall back to
Bluestein's chirp-z identity.
All transforms operate over the LAST axis and broadcast leading batch
axes.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..core import Proc

__all__ = [
    "spgram_psd_oneshot","fft", "ifft", "fft_plan", "fft_shift", "dct", "dst", "r2r",
           "spgram", "spgram_estimate", "asgram_render"]

FFT_FORWARD = -1
FFT_BACKWARD = +1


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@functools.lru_cache(maxsize=32)
def _bluestein_consts(n: int, sign: int):
    """Host-precomputed chirp and padded chirp spectrum for Bluestein."""
    m = 1
    while m < 2 * n - 1:
        m <<= 1
    k = np.arange(n, dtype=np.float64)
    # chirp w[k] = exp(sign * j*pi*k^2/n); use k^2 mod 2n to keep the
    # argument small (float32-safe for large n)
    k2 = (k * k) % (2.0 * n)
    w = np.exp(sign * 1j * np.pi * k2 / n)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(w)
    b[m - n + 1:] = np.conj(w[1:][::-1])
    B = np.fft.fft(b)
    return (jnp.asarray(w, dtype=jnp.complex64),
            jnp.asarray(B, dtype=jnp.complex64), m)


def _bluestein(x, sign: int):
    n = x.shape[-1]
    w, B, m = _bluestein_consts(n, sign)
    a = x * w
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
    A = jnp.fft.fft(jnp.pad(a, pad))
    y = jnp.fft.ifft(A * B)[..., :n]
    return y * w


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    f = 2
    while f * f <= n:
        if n % f == 0:
            return False
        f += 1
    return True


def _primitive_root(p: int) -> int:
    """Smallest primitive root mod prime p (host, plan time)."""
    fac = []
    m = p - 1
    f = 2
    while f * f <= m:
        if m % f == 0:
            fac.append(f)
            while m % f == 0:
                m //= f
        f += 1
    if m > 1:
        fac.append(m)
    g = 2
    while True:
        if all(pow(g, (p - 1) // q, p) != 1 for q in fac):
            return g
        g += 1


@functools.lru_cache(maxsize=16)
def _rader_consts(p: int, sign: int):
    """Rader plan constants for prime p (reference analog: the Rader
    prime plans, src/fft/src/fft_rader.c / fft_rader2.c — studied, not
    copied; this realization computes the length-(p-1) cyclic
    convolution with a padded power-of-two FFT, the device form).

    X[g^{-q}] = x[0] + (a (*) b)[q],  a[r] = x[g^r],  b[t] = W^{g^{-t}}
    (cyclic convolution over r, W = exp(sign*2j*pi/p)).
    """
    g = _primitive_root(p)
    ginv = pow(g, p - 2, p)
    L = p - 1
    perm_in = np.empty(L, np.int32)      # a[r] = x[perm_in[r]]
    iperm = np.empty(L, np.int64)        # g^{-q} mod p
    v, w = 1, 1
    for r in range(L):
        perm_in[r] = v
        iperm[r] = w
        v = (v * g) % p
        w = (w * ginv) % p
    tab = np.empty(p, np.int32)          # X[k] = x0 + conv[tab[k]], k>0
    tab[iperm] = np.arange(L)
    b = np.exp(sign * 2j * np.pi * iperm.astype(np.float64) / p)
    m = 1
    while m < 2 * L - 1:
        m <<= 1
    bpad = np.zeros(m, np.complex128)
    bpad[:L] = b
    bpad[m - L + 1:] = b[1:]
    B = np.fft.fft(bpad).astype(np.complex64)
    return perm_in, tab[1:].copy(), B, m


def _rader(x, sign: int):
    """Prime-size DFT via Rader's index permutation: two static
    permutation gathers around one padded 2^m convolution — the same
    live-FFT count as Bluestein, but the reference's actual prime plan
    family (its plan chooser sends primes > the codelet range here,
    src/fft/src/fft_utilities.c)."""
    p = x.shape[-1]
    perm_in, tabk, B, m = _rader_consts(p, sign)
    a = x[..., jnp.asarray(perm_in)]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - (p - 1))]
    conv = jnp.fft.ifft(jnp.fft.fft(jnp.pad(a, pad)) *
                        jnp.asarray(B))[..., :p - 1]
    Xk = x[..., 0:1] + conv[..., jnp.asarray(tabk)]
    X0 = jnp.sum(x, axis=-1, keepdims=True)
    return jnp.concatenate([X0, Xk], axis=-1)


_DFT_MAX = 2048    # largest odd factor handled by the matmul DFT:
                   # measured 14.0 Gsps at n=2043 vs Bluestein's ~2.1
                   # (crossover ~n=8000); bounds the cached matrix at
                   # 8*n^2 = 33 MB
_CT_MAX = 1 << 22  # largest TOTAL n for the four-step split: the
                   # twiddle is n complex64 entries (8n bytes), so this
                   # caps it at 32 MB — beyond it Bluestein's O(1)-sized
                   # constants win on memory (its padded FFT work is on
                   # device, not a cached host constant)


@functools.lru_cache(maxsize=32)
def _dft_matrix(n: int, sign: int) -> np.ndarray:
    """[n, n] DFT matrix M[k, j] = exp(sign*2j*pi*k*j/n), host complex64
    (a numpy closure constant: compiled into the program)."""
    k = np.arange(n, dtype=np.float64)
    # k*j mod n keeps the argument small for float accuracy
    kj = np.outer(k, k) % n
    return np.exp(sign * 2j * np.pi * kj / n).astype(np.complex64)


def _dft_matmul(x, sign: int):
    """Direct DFT as ONE matmul — the device analog of the reference's
    DFT codelets (src/fft/src/fft_dft.c:95: one dotprod per output row);
    for odd n <= _DFT_MAX this beats Bluestein's two padded 2^m FFTs.
    Precision HIGHEST: a default-precision f32 matmul may run at reduced
    precision (TF32 on a GPU, ~2^-11 relative), far below the
    float32-tolerance contract of an FFT."""
    M = _dft_matrix(x.shape[-1], sign)
    return jnp.einsum("...j,kj->...k", x, M,
                      precision=lax.Precision.HIGHEST)


@functools.lru_cache(maxsize=32)
def _ct_consts(n: int, a: int, sign: int):
    """Four-step Cooley-Tukey constants for the split n = a * b:
    twiddle tw[k1, j2] = exp(sign*2j*pi*k1*j2/n)."""
    b = n // a
    k1 = np.arange(a, dtype=np.float64)
    j2 = np.arange(b, dtype=np.float64)
    kj = np.outer(k1, j2) % n
    tw = np.exp(sign * 2j * np.pi * kj / n).astype(np.complex64)
    return b, tw


@functools.lru_cache(maxsize=64)
def _largest_odd_divisor(n1: int) -> int:
    """Largest divisor of (odd) n1 that fits the matmul DFT, or 0 when
    n1 is prime / has no divisor in (1, _DFT_MAX] — primes go to the
    Rader plan, the rest to Bluestein (API_PARITY.md)."""
    divs = {1}
    m, f, fac = n1, 3, {}
    while f * f <= m:
        while m % f == 0:
            fac[f] = fac.get(f, 0) + 1
            m //= f
        f += 2
    if m > 1:
        fac[m] = fac.get(m, 0) + 1
    for p, c in fac.items():
        divs = {d * p ** i for d in divs for i in range(c + 1)}
    cand = [d for d in divs if 1 < d <= _DFT_MAX]
    return max(cand) if cand else 0


def _cooley_tukey(x, sign: int, a: int):
    """Mixed-radix four-step FFT (reference analog: the recursive
    mixed-radix plan, src/fft/src/fft_mixed_radix.c:128): split
    n = a (matmul DFT) x b (2^m -> XLA FFT; otherwise
    recurse through the chooser — odd composites like 3069 = 1023*3
    split into two matmul DFTs instead of falling to Bluestein).
    With j = j1*b + j2 and k = k2*a + k1:
      X[k2*a + k1] = FFT_b{ tw[k1, j2] * DFT_a{ x[j1*b + j2] } }.
    Faster than Bluestein on composite sizes on the accelerator this was
    first tuned on (not measured on H100)."""
    n = x.shape[-1]
    b, tw = _ct_consts(n, a, sign)
    A = x.reshape(x.shape[:-1] + (a, b))
    M1 = _dft_matrix(a, sign)
    B = jnp.einsum("...jn,kj->...kn", A, M1,       # DFT over j1
                   precision=lax.Precision.HIGHEST)
    C = B * tw
    if _is_pow2(b):
        D = jnp.fft.fft(C) if sign < 0 else jnp.fft.ifft(C) * b
    else:
        D = _fft_any(C, sign)
    return jnp.swapaxes(D, -1, -2).reshape(x.shape[:-1] + (n,))


def _fft_any(x, sign: int):
    """Method chooser for non-pow2 sizes (the plan-selection analog of
    src/fft/src/fft_utilities.c:34-68: codelets / mixed-radix / Rader ->
    matmul DFT / four-step CT / Bluestein)."""
    n = x.shape[-1]
    n2 = n & (-n)
    n1 = n // n2
    if n2 > 1 and n1 <= _DFT_MAX and n <= _CT_MAX:
        return _cooley_tukey(x, sign, n1)
    if n <= _DFT_MAX:
        return _dft_matmul(x, sign)
    if n1 > _DFT_MAX and n <= _CT_MAX:
        # odd part too large for one matmul: peel its largest
        # matmul-sized divisor and recurse on the rest
        a = _largest_odd_divisor(n1)
        if a:
            return _cooley_tukey(x, sign, a)
        if n2 > 1 and n2 <= _DFT_MAX and _is_prime(n1):
            # 2^k * prime: split off the pow2 part; the recursion's odd
            # remainder hits the Rader branch below
            return _cooley_tukey(x, sign, n2)
    if n > _DFT_MAX and _is_prime(n):
        return _rader(x, sign)
    return _bluestein(x, sign)


def fft(x, n: int | None = None):
    """Forward DFT over the last axis, unnormalized:
    y[k] = sum_t x[t] exp(-j 2 pi k t / N).  Any length N."""
    x = jnp.asarray(x)
    if not jnp.iscomplexobj(x):
        x = x.astype(jnp.complex64)
    if n is not None and n != x.shape[-1]:
        if n > x.shape[-1]:
            pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
            x = jnp.pad(x, pad)
        else:
            x = x[..., :n]
    size = x.shape[-1]
    if _is_pow2(size):
        return jnp.fft.fft(x)
    return _fft_any(x, FFT_FORWARD)


def ifft(x, n: int | None = None, normalize: bool = False):
    """Inverse DFT over the last axis.  Matches the reference convention of
    an UNNORMALIZED backward transform unless ``normalize``
    (fft_common.c executes raw backward; callers divide by N)."""
    x = jnp.asarray(x)
    if not jnp.iscomplexobj(x):
        x = x.astype(jnp.complex64)
    if n is not None and n != x.shape[-1]:
        if n > x.shape[-1]:
            pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
            x = jnp.pad(x, pad)
        else:
            x = x[..., :n]
    size = x.shape[-1]
    if _is_pow2(size):
        y = jnp.fft.ifft(x) * size
    else:
        y = _fft_any(x, FFT_BACKWARD)
    return y / size if normalize else y


def fft_plan(n: int, direction: int = FFT_FORWARD) -> Callable:
    """FFTW-style plan: returns a jit-friendly callable specialized to size n
    (the analog of fft_create_plan/fft_execute, fft_common.c:109/285).
    Method chooser: pow2 -> XLA native; composite with odd factor
    <= 2048 -> four-step mixed-radix (matmul DFT x XLA FFT); odd/prime
    n <= 2048 -> matmul DFT; else Bluestein."""
    if direction == FFT_FORWARD:
        return lambda x: fft(x, n)
    return lambda x: ifft(x, n)


def fft_shift(x):
    return jnp.fft.fftshift(x, axes=-1)


# ---------------------------------------------------------------------------
# real-to-real transforms (DCT/DST families, fft_r2r_1d.c)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dct_matrix(n: int, type: int):
    """FFTW REDFT basis matrix m[j, k] so that y[k] = sum_j x[j] m[j, k].

    Exact FFTW conventions (unnormalized), verified against reference golden
    vectors.  Sizes in practice are small (reference r2r tests use n<=32),
    so the O(n^2) matmul is the simplest form.
    """
    j = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    if type == 1:    # REDFT00: y_k = x_0 + (-1)^k x_{n-1} + 2 sum cos(pi j k/(n-1))
        m = 2.0 * np.cos(np.pi * j * k / (n - 1))
        m[0, :] = 1.0
        m[-1, :] = (-1.0) ** k.ravel()
    elif type == 2:  # REDFT10
        m = 2.0 * np.cos(np.pi * (j + 0.5) * k / n)
    elif type == 3:  # REDFT01
        m = 2.0 * np.cos(np.pi * j * (k + 0.5) / n)
        m[0, :] = 1.0
    elif type == 4:  # REDFT11
        m = 2.0 * np.cos(np.pi * (j + 0.5) * (k + 0.5) / n)
    else:
        raise ValueError(f"unsupported DCT type {type}")
    return jnp.asarray(m, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _dst_matrix(n: int, type: int):
    """FFTW RODFT basis matrix (same layout as _dct_matrix)."""
    j = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    if type == 1:    # RODFT00
        m = 2.0 * np.sin(np.pi * (j + 1) * (k + 1) / (n + 1))
    elif type == 2:  # RODFT10
        m = 2.0 * np.sin(np.pi * (j + 0.5) * (k + 1) / n)
    elif type == 3:  # RODFT01: y_k = (-1)^k x_{n-1} + 2 sum_{j<n-1} sin(pi(j+1)(k+.5)/n)
        m = 2.0 * np.sin(np.pi * (j + 1) * (k + 0.5) / n)
        m[-1, :] = (-1.0) ** k.ravel()
    elif type == 4:  # RODFT11
        m = 2.0 * np.sin(np.pi * (j + 0.5) * (k + 0.5) / n)
    else:
        raise ValueError(f"unsupported DST type {type}")
    return jnp.asarray(m, dtype=jnp.float32)


def dct(x, type: int = 2):
    """DCT-I..IV (FFTW REDFT00/10/01/11 conventions, unnormalized)."""
    x = jnp.asarray(x, dtype=jnp.float32)
    return jnp.einsum("...j,jk->...k", x, _dct_matrix(x.shape[-1], type))


def dst(x, type: int = 1):
    """DST-I..IV (FFTW RODFT00/10/01/11 conventions, unnormalized)."""
    x = jnp.asarray(x, dtype=jnp.float32)
    return jnp.einsum("...j,jk->...k", x, _dst_matrix(x.shape[-1], type))


_R2R = {
    "REDFT00": lambda x: dct(x, 1), "REDFT10": lambda x: dct(x, 2),
    "REDFT01": lambda x: dct(x, 3), "REDFT11": lambda x: dct(x, 4),
    "RODFT00": lambda x: dst(x, 1), "RODFT10": lambda x: dst(x, 2),
    "RODFT01": lambda x: dst(x, 3), "RODFT11": lambda x: dst(x, 4),
}


def r2r(x, kind: str):
    """FFTW-style real-to-real transform dispatch (fft_r2r_1d.c)."""
    if kind not in _R2R:
        raise ValueError(f"unknown r2r kind {kind!r}")
    return _R2R[kind](x)


# ---------------------------------------------------------------------------
# streaming spectral periodogram (spgram.c)
# ---------------------------------------------------------------------------

def spgram(nfft: int, window: str = "hamming", window_len: int | None = None,
           delay: int | None = None, alpha: float = -1.0,
           name: str = "spgram") -> Proc:
    """Streaming Welch periodogram (reference spgram.c:36-240).

    Processes a block [..., T]; emits the running averaged PSD accumulator in
    the carry; use `spgram_estimate(carry)` for the dB PSD.  alpha<0 means
    uniform averaging over all transforms (reference default).
    """
    from ..design.windows import window as make_window

    window_len = window_len or nfft // 2
    delay = delay or nfft // 4
    if window_len > nfft:
        raise ValueError("window length cannot exceed nfft")
    w = make_window(window, window_len, 10.0 if window == "kaiser" else 0.0)
    # normalize so sum(w^2) = 1 per transform (reference spgram energy calc)
    w = w / np.sqrt(np.sum(w * w))
    wj = jnp.asarray(w, dtype=jnp.float32)

    def init(batch_shape=(), dtype=jnp.complex64):
        return {
            "buf": jnp.zeros(batch_shape + (window_len,), dtype=jnp.complex64),
            "psd": jnp.zeros(batch_shape + (nfft,), dtype=jnp.float32),
            "count": jnp.zeros(batch_shape, dtype=jnp.int32),
        }

    def apply(params, carry, x):
        x = x.astype(jnp.complex64)
        buf = jnp.concatenate([carry["buf"], x], axis=-1)
        total = buf.shape[-1]
        n_xf = max((total - window_len) // delay + 1, 0)
        psd, count = carry["psd"], carry["count"]
        if n_xf > 0:
            # all windows at once: strided gather [.., n_xf, wlen], one
            # batched FFT, then a closed-form fold of the running average
            # (bit-equivalent recurrences; no Python-unrolled slices)
            idx = jnp.asarray(np.arange(n_xf)[:, None] * delay +
                              np.arange(window_len)[None, :], jnp.int32)
            frames = buf[..., idx]                      # [.., n_xf, wlen]
            X = fft(frames * wj, nfft)
            p = X.real * X.real + X.imag * X.imag       # [.., n_xf, nfft]
            if alpha < 0:
                # uniform mean is associative: fold all n_xf at once
                cf = count.astype(jnp.float32)[..., None]
                psd = (psd * cf + jnp.sum(p, axis=-2)) / (cf + n_xf)
            else:
                # EWMA psd' = (1-a)psd + a*p unrolled n_xf steps:
                # psd_n = (1-a)^n * psd_or_p0 + sum_i a(1-a)^(n-1-i) p_i,
                # where a fresh accumulator (count==0) seeds from p_0
                wts = (alpha * (1 - alpha)
                       ** np.arange(n_xf - 1, -1, -1)).astype(np.float32)
                base = jnp.einsum("...kf,k->...f", p, jnp.asarray(wts))
                seed = jnp.where((count == 0)[..., None], p[..., 0, :], psd)
                psd = (1 - alpha) ** n_xf * seed + base
            count = count + n_xf
        consumed = n_xf * delay
        new_buf = buf[..., consumed:][..., -window_len:]
        if new_buf.shape[-1] < window_len:
            pad = [(0, 0)] * (new_buf.ndim - 1) + [(window_len - new_buf.shape[-1], 0)]
            new_buf = jnp.pad(new_buf, pad)
        return psd, {"buf": new_buf, "psd": psd, "count": count}

    return Proc(params={"w": wj}, init=init, apply=apply, rate=(1, 1), name=name)


def spgram_psd_oneshot(x, nfft: int, window: str = "kaiser",
                       window_len: int | None = None, beta: float = 10.0):
    """One-shot PSD with the reference's exact semantics
    (spgramcf_execute_psd): window the LAST window_len samples with the
    reference scale sqrt(2)/(sqrt(sum(w^2)/wlen)*sqrt(nfft)), FFT, and
    return the fftshifted spectrum in dB."""
    from ..design.windows import window as make_window
    window_len = window_len or nfft // 2
    w = np.asarray(make_window(window, window_len, beta))
    g = np.sqrt(2.0) / (np.sqrt(np.sum(w * w) / window_len) *
                        np.sqrt(nfft))
    wj = jnp.asarray((w * g).astype(np.float32))
    xw = x[..., -window_len:] * wj
    X = fft(xw, nfft)
    mag = jnp.abs(fft_shift(X))
    return 20.0 * jnp.log10(jnp.maximum(mag, 1e-16))


def spgram_estimate(psd, fs: float = 1.0):
    """PSD accumulator -> dB, fftshifted (spgram_get_psd semantics)."""
    return 10.0 * jnp.log10(jnp.maximum(fft_shift(psd), 1e-20))


def asgram_render(psd_db, height: int = 1, levels: str = " .,-+*&NM#") -> str:
    """ASCII spectrogram line (reference asgram.c): quantize PSD into glyphs."""
    p = np.asarray(psd_db, dtype=np.float64)
    lo, hi = p.min(), p.max()
    idx = np.clip(((p - lo) / max(hi - lo, 1e-12)) * (len(levels) - 1), 0,
                  len(levels) - 1).astype(int)
    return "".join(levels[i] for i in idx)
