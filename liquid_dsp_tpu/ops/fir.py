"""FIR filtering as pure block processors with explicit carry.

Reference analogs (studied, not copied):
  * firfilt  — src/filter/src/firfilt.c:297-360 (per-sample ring buffer +
               dotprod).  Here: one valid convolution over the whole block;
               carry = last (L-1) input samples — exactly the overlap-save
               halo exchanged between devices when time is sharded.
  * firdecim — src/filter/src/firdecim.c (M:1 polyphase decimator) —
               strided convolution; y[n] = (x*h)[nM].
  * firinterp— src/filter/src/firinterp.c (1:M interpolator) — dilated
               (transposed) convolution.
  * firpfb   — src/filter/src/firpfb.c — polyphase bank: all branches
               computed batched; branch selection is a gather.
  * firhilb  — src/filter/src/firhilb.c — Hilbert real<->complex 2:1.
  * autocorr — src/filter/src/autocorr.c — windowed autocorrelation.

All ops accept [..., T] blocks (time last, leading axes batched/sharded).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..core import LTI, Proc, planar_per_plane
from .dotprod import conv1d

__all__ = ["firfilt", "firfilt_rect", "firdecim", "firinterp",
           "firpfb_execute", "firhilb",
           "firhilb_interp", "firhilb_r2c", "firhilb_c2r",
           "autocorr", "fir_freqresponse", "fir_apply"]


def firfilt_rect(n: int, name: str = "firfilt_rect") -> "Proc":
    """Length-n moving-sum (rectangular) FIR filter (reference
    firfilt_xxx_create_rect, src/filter/src/firfilt.c:174-195)."""
    if not (1 <= n <= 1024):
        raise ValueError("filter length must be in [1, 1024]")
    return firfilt(np.ones(n, np.float32), name=name)


def _np_taps(h, scale=1.0):
    """Coefficient prep on the host: taps are cast to 32-bit and scaled
    in numpy, so the device sees one ready array and never a float64
    one (JAX would silently narrow it)."""
    h = np.asarray(h)
    if scale != 1.0:
        h = h * scale
    if h.dtype == np.float64:
        h = h.astype(np.float32)
    elif h.dtype == np.complex128:
        h = h.astype(np.complex64)
    return h


def _as_jnp_taps(h):
    return jnp.asarray(_np_taps(h))


def fir_apply(h, carry, x, stride: int = 1):
    """One block of FIR filtering: returns (y, carry').

    carry is the last (len(h)-1) input samples (zeros initially).
    y[t] = sum_j h[j] * xp[t*stride - j] with xp = [carry | x], evaluated at
    output sample times aligned so y[0] corresponds to input x[0].
    """
    L = h.shape[-1]
    xp = jnp.concatenate([carry, x], axis=-1) if L > 1 else x
    y = conv1d(xp, h, stride=stride)
    new_carry = xp[..., xp.shape[-1] - (L - 1):] if L > 1 else carry
    return y, new_carry


def firfilt(h, scale: float | complex = 1.0, name: str = "firfilt",
            backend: str = "auto") -> Proc:
    """Direct-form FIR filter over blocks (reference firfilt_crcf).

    Block length T in -> T out; carry: [..., L-1] input tail.
    backend: 'xla' (lax.conv), 'matmul' (banded-tap matrix framed as
    [tiles, TILE+L-1] @ [TILE+L-1, TILE] — a real matrix product where
    the feature-dim-1 convolution is not), 'fft' (delegate to the
    overlap-save fftfilt apply — SAME carry, the last L-1 input
    samples), or 'auto' (the default: the platform policy's
    "fir_banded_matmul" entry, platform.py).
    """
    h_np = _np_taps(h, scale)
    L = int(h_np.shape[-1])
    h = jnp.asarray(h_np)
    params = {"h": h}
    if backend == "auto":
        from ..platform import policy
        backend = "matmul" if policy("fir_banded_matmul") else "xla"

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (L - 1,), dtype=dtype)

    if backend == "fft":
        from .fftfilt import fftfilt as _fftfilt
        _ff = _fftfilt(h_np, name=name)      # h_np already scaled
        # The fft backend forwards firfilt's own params dict into the
        # nested fftfilt apply; that is only sound while both Procs share
        # the {'h': identically-scaled-taps} contract — pin it here so a
        # param rename/rescale in fftfilt fails loudly at build time.
        assert set(_ff.params) == {"h"} and np.allclose(
            np.asarray(_ff.params["h"]), h_np), \
            "fftfilt param contract changed; fix firfilt backend='fft'"

        def apply(params, carry, x):
            return _ff.apply(params, carry, x)
    elif backend == "matmul":
        def apply(params, carry, x):
            return fir_apply_matmul(params["h"], _coerce(carry, x.dtype), x)
    elif backend == "xla":
        def apply(params, carry, x):
            return fir_apply(params["h"], _coerce(carry, x.dtype), x)
    else:
        raise ValueError(f"unknown firfilt backend {backend!r}")

    def planar_init(batch_shape=(), dtype=jnp.float32):
        z = jnp.zeros(batch_shape + (L - 1,), dtype)
        return (z, z)

    if not np.iscomplexobj(h_np):
        # real taps: filter each float plane independently (planar.py)
        def planar_apply(params, carry, x):
            (r, i), (cr, ci) = x, carry
            yr, cr2 = apply(params, cr, r)
            yi, ci2 = apply(params, ci, i)
            return (yr, yi), (cr2, ci2)
    else:
        # complex taps on float planes: 3-real-convolution Karatsuba
        # split (y = x*h needs m1 = r*hr, m2 = i*hi, m3 = (r+i)*(hr+hi);
        # yr = m1 - m2, yi = m3 - m1 - m2) — one fewer pass than the
        # naive 4 and no interleaved complex math anywhere
        def planar_apply(params, carry, x):
            h_ = params["h"]
            hr, hi = jnp.real(h_), jnp.imag(h_)
            (r, i), (cr, ci) = x, carry
            m1, cr2 = fir_apply_auto(hr, cr, r)
            m2, ci2 = fir_apply_auto(hi, ci, i)
            m3, _ = fir_apply_auto(hr + hi, cr + ci, r + i)
            return (m1 - m2, m3 - m1 - m2), (cr2, ci2)

    return Proc(params=params, init=init, apply=apply, rate=(1, 1), name=name,
                halo=L - 1, lti=LTI(h_np, 1, 0),
                planar_apply=planar_apply, planar_init=planar_init)


def banded_blocks_apply(band, xp, T_out, tile_in, tile_out):
    """Shared banded-matmul skeleton (used by the FIR/decimator band,
    the interpolator band, and the rational resampler's branch band):
    pad xp to (nt+nb-1)*tile_in, reshape into non-overlapping input
    tiles, and accumulate the per-block
    ``[.., nt, tile_in] @ [tile_in, tile_out]`` matmuls at HIGHEST
    precision; returns [.., nt*tile_out][..., :T_out].

    band: [rows, tile_out], numpy (constant-folded) or jnp (traced
    params).  Dtype mixes are handled here: complex input x real band
    splits into planes (2 real matmuls instead of a 3-4-pass complex
    one); real input x complex band upcasts the input so the band's
    imaginary part is not silently dropped by the cast."""
    rows = int(band.shape[0])
    band_cplx = (np.iscomplexobj(band) if isinstance(band, np.ndarray)
                 else jnp.iscomplexobj(band))
    nt = -(-T_out // tile_out)
    nb = -(-rows // tile_in)
    tot = (nt + nb - 1) * tile_in
    pad_r = tot - xp.shape[-1]
    if pad_r > 0:
        xp = jnp.pad(xp, [(0, 0)] * (xp.ndim - 1) + [(0, pad_r)])
    elif pad_r < 0:
        xp = xp[..., :tot]
    if band_cplx and not jnp.iscomplexobj(xp):
        xp = xp.astype(jnp.complex64)
    if jnp.iscomplexobj(xp) and not band_cplx:
        planes = jnp.stack([jnp.real(xp), jnp.imag(xp)], axis=0)
        y2 = banded_blocks_apply(band, planes, T_out, tile_in, tile_out)
        return lax.complex(y2[0], y2[1])
    xpt = xp.reshape(xp.shape[:-1] + (nt + nb - 1, tile_in))
    y = None
    for b in range(nb):
        blk = band[b * tile_in:(b + 1) * tile_in]
        if blk.shape[0] < tile_in:
            pad_b = [(0, tile_in - blk.shape[0]), (0, 0)]
            blk = (np.pad(blk, pad_b) if isinstance(blk, np.ndarray)
                   else jnp.pad(blk, pad_b))
        seg = lax.slice_in_dim(xpt, b, b + nt, axis=-2)
        contrib = jnp.matmul(seg, jnp.asarray(blk).astype(seg.dtype),
                             precision=lax.Precision.HIGHEST)
        y = contrib if y is None else y + contrib
    return y.reshape(y.shape[:-2] + (nt * tile_out,))[..., :T_out]


def _banded_matmul(h, xp, T, tile, stride: int = 1):
    """[.., Tp] -> [.., T] banded-tap matmul (T OUTPUT samples, one per
    `stride` inputs); xp already carries the L-1 history prefix.

    Gather-free formulation: the overlapping frames
    ``frames[k] = xp[k*S*tile : k*S*tile + S*tile+L-1]`` are never
    materialized.  Instead xp is reshaped into non-overlapping input
    tiles and the [S*tile+L-1, tile] band matrix is split into
    ceil-many [S*tile, tile] blocks, so
    ``y[k] = sum_b xpt[k+b] @ band_block[b]`` — pure reshapes +
    matmuls; stride > 1 folds the decimation into the band's column
    spacing (band[f, k] = h[k*S + L-1 - f]).  The im2col gather this
    replaces was several times slower on the accelerator this was first
    tuned on (not measured on H100)."""
    L = int(h.shape[-1])
    S = int(stride)
    tile_in = tile * S
    rows = tile_in + L - 1
    # banded tap matrix: band[f, k] = h[k*S + L-1 - f] for a valid tap.
    # HIGHEST in the shared skeleton: firfilt output feeds golden
    # accuracy contracts (1e-3 autotest convention)
    j = (np.arange(tile)[None, :] * S + (L - 1)
         - np.arange(rows)[:, None])
    if isinstance(h, np.ndarray):
        # host taps (params closed over as numpy constants): build the
        # band on host so it enters the jaxpr as one folded constant
        band = np.where((j >= 0) & (j < L), h[np.clip(j, 0, L - 1)],
                        np.zeros((), h.dtype))
    else:
        mask = jnp.asarray((j >= 0) & (j < L))
        band = jnp.where(mask, h[jnp.asarray(np.clip(j, 0, L - 1))],
                         jnp.zeros((), h.dtype))
    return banded_blocks_apply(band, xp, T, tile_in, tile)


def fir_apply_matmul(h, carry, x, tile: int = 256, stride: int = 1):
    """FIR as a banded-tap matmul: frames [.., nt, tile+L-1] times band
    [tile+L-1, tile], so each tile of outputs is one matrix product
    (the [B,1,T] convolution has feature dimension 1).  Identical output
    to fir_apply.

    Real taps + complex signal take a planar fast path: the two planes
    are stacked on a leading axis and filtered by ONE real matmul — a
    complex-dtype matmul lowers to 3-4 real passes, while filtering the
    planes needs exactly 2 and rides the batch tiling instead."""
    L = int(h.shape[-1])
    T = int(x.shape[-1]) // int(stride)
    xp = jnp.concatenate([carry.astype(x.dtype), x], axis=-1)
    new_carry = xp[..., xp.shape[-1] - (L - 1):] if L > 1 else carry
    if jnp.iscomplexobj(h) and not jnp.iscomplexobj(xp):
        xp = xp.astype(h.dtype)  # the band cast below must not drop imag
    if jnp.iscomplexobj(xp) and not jnp.iscomplexobj(h):
        planes = jnp.stack([jnp.real(xp), jnp.imag(xp)], axis=0)
        y2 = _banded_matmul(h, planes, T, tile, stride)
        return lax.complex(y2[0], y2[1]), new_carry
    return _banded_matmul(h, xp, T, tile, stride), new_carry


def fir_apply_auto(h, carry, x, stride: int = 1):
    """fir_apply with a trace-time backend pick by the platform policy
    ("fir_banded_matmul", platform.py); the strided band covers
    decimators too."""
    from ..platform import policy
    if policy("fir_banded_matmul") and x.shape[-1] % stride == 0:
        return fir_apply_matmul(h, carry, x, stride=stride)
    return fir_apply(h, carry, x, stride)


def _coerce(carry, dtype):
    """Carry stores input samples; follow the input stream's dtype (a fresh
    complex-initialized carry feeding a real stream drops the zero imag)."""
    if jnp.iscomplexobj(carry) and not jnp.issubdtype(dtype, jnp.complexfloating):
        carry = carry.real
    return carry.astype(dtype)


def firdecim(m: int, h, scale=1.0, name: str = "firdecim") -> Proc:
    """M:1 decimating FIR (reference firdecim.c).  Block length must be a
    multiple of m; T in -> T//m out."""
    h_np = _np_taps(h, scale)
    h = jnp.asarray(h_np)
    L = int(h.shape[-1])

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (L - 1,), dtype=dtype)

    def apply(params, carry, x):
        return fir_apply_auto(params["h"], _coerce(carry, x.dtype), x,
                              stride=m)

    pa, pi = ((None, None) if np.iscomplexobj(h_np) else
              planar_per_plane(apply, init))
    return Proc(params={"h": h}, init=init, apply=apply, rate=(1, m),
                name=name, halo=L - 1, lti=LTI(h_np, m, 0),
                planar_apply=pa, planar_init=pi)


def _interp_banded(hp, xp, T, k, Lp, tile: int = 512):
    """Interpolating banded matmul emitting the INTERLEAVED stream
    directly: each output tile of `tile` samples covers tile/k input
    samples x k phases, so column c of the band is phase c%k at input
    offset c//k — band[f, c] = hp[c%k, c//k + Lp-1 - f].  No output
    transpose (an explicit phase-major layout + swapaxes measured a
    full relayout of the 4x output stream).
    y[i*k + p] = sum_m hp[p, m] * xp[i + Lp-1 - m] (the conv1d
    convention of the CPU path)."""
    if tile % k:
        tile = k * (-(-tile // k))
    ti = tile // k                              # input samples per tile
    rows = ti + Lp - 1
    c = np.arange(tile)[None, :]
    f = np.arange(rows)[:, None]
    j = (c // k) + (Lp - 1) - f
    valid = (j >= 0) & (j < Lp)
    idx = (c % k) * Lp + np.clip(j, 0, Lp - 1)
    band = jnp.where(jnp.asarray(valid),
                     jnp.ravel(hp)[jnp.asarray(idx)],
                     jnp.zeros((), hp.dtype))
    return banded_blocks_apply(band, xp, T * k, ti, tile)


def firinterp(k: int, h, scale=1.0, name: str = "firinterp") -> Proc:
    """1:K interpolating FIR (reference firinterp.c): zero-stuff by k then
    filter.  T in -> T*k out; carry: last ceil((L-1)/k) input samples.

    y[n] = sum_j h[j] * xz[n - j] where xz is the zero-stuffed input —
    implemented as a polyphase matmul: for phase p in [0,k),
    y[i*k + p] = sum_m h[m*k + p] * x[i - m].
    """
    h_np = _np_taps(h, scale)
    L = int(h_np.shape[-1])
    # number of history input samples each phase needs
    n_hist = (L - 1) // k + (1 if (L - 1) % k else 0) if L > 1 else 0
    n_hist = max(n_hist, 0)
    # pad taps to a multiple of k and shape into polyphase branches:
    # hp[p, m] = h[m*k + p] — built in numpy (no eager device ops)
    Lp = -(-L // k)  # ceil
    h_pad = np.pad(h_np, (0, Lp * k - L))
    hp = jnp.asarray(h_pad.reshape(Lp, k).T.copy())  # [k, Lp]

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (Lp - 1,), dtype=dtype) if Lp > 1 else \
            jnp.zeros(batch_shape + (0,), dtype=dtype)

    def apply(params, carry, x):
        from ..platform import policy
        hp_ = params["hp"]
        xp = jnp.concatenate([carry, x], axis=-1) if Lp > 1 else x
        new_carry = xp[..., xp.shape[-1] - (Lp - 1):] if Lp > 1 else carry
        if policy("firinterp_banded"):
            # ONE banded matmul for ALL k phases: the per-phase bands
            # concatenate column-wise into [tile+Lp-1, k*tile] instead of
            # the k feature-dim-1 convs below.
            y = _interp_banded(hp_, xp, x.shape[-1], k, Lp)
            return y, new_carry
        # per-phase valid convolution of x with branch p -> [..., k, T]
        ys = [conv1d(xp, hp_[p]) for p in range(k)]
        y = jnp.stack(ys, axis=-1)  # [..., T, k]
        y = y.reshape(y.shape[:-2] + (y.shape[-2] * k,))
        return y, new_carry

    pa, pi = ((None, None) if np.iscomplexobj(h_np) else
              planar_per_plane(apply, init))
    return Proc(params={"hp": hp}, init=init, apply=apply, rate=(k, 1),
                name=name, planar_apply=pa, planar_init=pi)


def firpfb_execute(hp, x_window):
    """Evaluate ALL branches of a polyphase filter bank at once.

    hp: [npfb, Lp] branch taps; x_window: [..., Lp] most-recent samples
    (oldest first).  Returns [..., npfb].  The reference computes one branch
    per call (firpfb.c); here computing all branches is one matmul.
    """
    # y[b] = sum_m hp[b, m] * x[m]
    if jnp.iscomplexobj(x_window) and not jnp.iscomplexobj(hp):
        hp = hp.astype(x_window.real.dtype)
        re = jnp.einsum("bm,...m->...b", hp, x_window.real)
        im = jnp.einsum("bm,...m->...b", hp, x_window.imag)
        return lax.complex(re, im)
    return jnp.einsum("bm,...m->...b", hp, x_window)


def firhilb(m: int = 5, as_db: float = 60.0, name: str = "firhilb"):
    """Hilbert transform 2:1 decimator, real [..., 2T] -> complex [..., T]
    (reference firhilb.c decim_execute): quadrature = even samples
    through the 2m-tap odd-sampled imag branch, in-phase = odd samples
    delayed m (odd-grid) samples.  Sample-exact vs the reference."""
    from ..design.firdes import firdes_kaiser

    h_len = 4 * m + 1
    h = firdes_kaiser(h_len, 0.25, as_db, 0.0)
    t = np.arange(h_len, dtype=np.float64) - (h_len - 1) / 2.0
    him = np.imag(h * np.exp(1j * 0.5 * np.pi * t))
    # taps multiplying e[n-l]: heff[l] = him[2l+1] (reference stores the
    # reversed odd-sampled branch and dot-products oldest-first)
    heff = him[1::2].astype(np.float32)
    heff_j = jnp.asarray(heff)
    Lq = 2 * m

    def init(batch_shape=(), dtype=jnp.float32):
        return {"x": jnp.zeros(batch_shape + (4 * m,), jnp.float32)}

    def apply_r2c(params, carry, x):
        xp = jnp.concatenate([carry["x"], x], axis=-1)
        T = x.shape[-1] // 2
        e = xp[..., 0::2]                   # even grid, 2m history
        o = xp[..., 1::2]
        # valid-conv index t ends at e[t+Lq-1]; output i ends at
        # e[2m+i] -> t = i+1
        yq = conv1d(e, heff_j)[..., 1: T + 1]
        yi = o[..., m: m + T]
        y = lax.complex(yi, yq)
        new_carry = {"x": xp[..., xp.shape[-1] - 4 * m:]}
        return y, new_carry

    r2c = Proc(params={"hq": heff_j}, init=init, apply=apply_r2c,
               rate=(1, 2), name=name + "_r2c")
    return r2c


def _hilbert_branches(m: int, as_db: float):
    """(him, heff): full 4m+1-tap imaginary branch of the Hilbert
    prototype and its 2m odd-sample taps (reference firhilb.c:90-101)."""
    from ..design.firdes import firdes_kaiser
    h_len = 4 * m + 1
    h = firdes_kaiser(h_len, 0.25, as_db, 0.0)
    t = np.arange(h_len, dtype=np.float64) - (h_len - 1) / 2.0
    him = np.imag(h * np.exp(1j * 0.5 * np.pi * t))
    return him.astype(np.float32), him[1::2].astype(np.float32)


def firhilb_interp(m: int = 5, as_db: float = 60.0,
                   name: str = "firhilb_interp") -> Proc:
    """Hilbert 1:2 interpolator, complex [..., T] -> real [..., 2T]
    (reference firhilb.c:269-284 interp_execute): even outputs are the
    imaginary part delayed m input samples, odd outputs are the real
    part through the 2m-tap quadrature branch.  Sample-exact vs the
    reference window/dotprod loop."""
    _, heff = _hilbert_branches(m, as_db)
    heff_j = jnp.asarray(heff)

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"x": jnp.zeros(batch_shape + (2 * m,), jnp.complex64)}

    def apply(params, carry, x):
        (hq,) = params
        xp = jnp.concatenate([carry["x"].astype(x.dtype), x], axis=-1)
        T = x.shape[-1]
        y_even = jnp.imag(xp[..., m: m + T])        # w0 index m-1 = delay m
        y_odd = conv1d(jnp.real(xp), hq)[..., 1: T + 1]
        y = jnp.stack([y_even, y_odd], axis=-1)
        y = y.reshape(y.shape[:-2] + (2 * T,))
        return y, {"x": xp[..., xp.shape[-1] - 2 * m:]}

    return Proc(params=(heff_j,), init=init, apply=apply, rate=(2, 1),
                name=name)


def firhilb_r2c(m: int = 5, as_db: float = 60.0,
                name: str = "firhilb_r2c") -> Proc:
    """Single-rate Hilbert transform, real [..., T] -> analytic complex
    [..., T] (reference firhilb.c:172-210 r2c_execute): the toggled
    two-window polyphase is algebraically the full 4m+1-tap filter —
    in-phase = x delayed 2m samples (center tap), quadrature = conv
    with the odd-tap imaginary branch.  Sample-exact vs the reference
    toggle loop."""
    him, _ = _hilbert_branches(m, as_db)
    him_j = jnp.asarray(him)
    hist = 4 * m

    def init(batch_shape=(), dtype=jnp.float32):
        return {"x": jnp.zeros(batch_shape + (hist,), jnp.float32)}

    def apply(params, carry, x):
        (h,) = params
        xp = jnp.concatenate([carry["x"].astype(x.dtype), x], axis=-1)
        T = x.shape[-1]
        yi = xp[..., 2 * m: 2 * m + T]
        yq = conv1d(xp, h)[..., :T]
        return lax.complex(yi, yq), {"x": xp[..., xp.shape[-1] - hist:]}

    return Proc(params=(him_j,), init=init, apply=apply, rate=(1, 1),
                name=name)


def firhilb_c2r(name: str = "firhilb_c2r") -> Proc:
    """Single-rate complex -> real: the real part (reference
    firhilb.c:217-222 c2r_execute is exactly crealf)."""
    def init(batch_shape=(), dtype=jnp.complex64):
        return ()

    def apply(params, carry, x):
        return jnp.real(x), carry

    return Proc(params=(), init=init, apply=apply, rate=(1, 1), name=name)


def autocorr(window_size: int, delay: int, name: str = "autocorr") -> Proc:
    """Windowed autocorrelation r[t] = sum_{i<W} x[t-i] conj(x[t-i-d])
    (reference autocorr.c).  Carry: last W+d-1 samples."""
    W, d = int(window_size), int(delay)
    hist = W + d - 1

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (hist,), dtype=dtype)

    def apply(params, carry, x):
        xp = jnp.concatenate([carry, x], axis=-1)
        T = x.shape[-1]
        # r[t] = sum_i x[t-i]*conj(x[t-i-d]), i = 0..W-1; t indexes x
        prod = xp[..., d:] * jnp.conj(xp[..., : xp.shape[-1] - d])
        # windowed sum over trailing W products ending at each output
        # time, as a ones-tap banded matmul (box sums via cumsum were
        # far slower on the accelerator this was first tuned on —
        # CLAUDE.md; not measured on H100)
        pr, _ = fir_apply_matmul(
            jnp.ones((W,), jnp.float32),
            jnp.zeros(prod.shape[:-1] + (W - 1,), prod.dtype), prod)
        r = pr[..., W - 1:]
        return r, xp[..., xp.shape[-1] - hist:]

    return Proc(params={}, init=init, apply=apply, rate=(1, 1), name=name)


def fir_freqresponse(h, fc):
    """Complex frequency response H(e^{j 2 pi fc}) (firfilt.c:371)."""
    h = jnp.asarray(h)
    n = jnp.arange(h.shape[-1])
    e = jnp.exp(-1j * 2 * jnp.pi * fc * n)
    return jnp.sum(h * e, axis=-1)
