"""Block FIR filtering via FFT (overlap-save).

Reference analog: src/filter/src/fftfilt.c:193-260 — the reference uses
overlap-ADD with a saved output tail; we use overlap-SAVE with a saved input
tail so the carry is identical to firfilt's (the last L-1 input samples).
The two are mathematically equivalent; overlap-save's carry doubles as the
ppermute halo when the time axis is sharded across devices (SURVEY.md §5).

Output is bit-identical (within float tolerance) to firfilt with the same
taps — the reference asserts the same equivalence (fftfilt vs firfilt RMSE,
examples/fftfilt_crcf_example.c:57-71).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import LTI, Proc, planar_per_plane
from .fft import fft, ifft

__all__ = ["fftfilt"]


def fftfilt(h, block_len: int | None = None, scale=1.0, name: str = "fftfilt") -> Proc:
    """FFT-based block FIR (reference fftfilt_crcf_create, fftfilt.c:70).

    h: [L] real or complex taps.  The FFT size is chosen per call from the
    static block length: nfft = next_pow2(T + L - 1); H is computed lazily
    per nfft and cached in params-free closure (sizes are static under jit).
    """
    h = np.asarray(h)
    L = int(h.shape[-1])
    hj = jnp.asarray(h * scale, dtype=jnp.complex64 if np.iscomplexobj(h) else jnp.float32)

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (L - 1,), dtype=dtype)

    def apply(params, carry, x):
        T = x.shape[-1]

        def npow2(n):
            p = 1
            while p < n:
                p <<= 1
            return p

        # segmented overlap-save: many small batched FFTs beat one giant
        # T-point FFT.  nfft ~ 16x the tap overlap keeps the L-1 wasted
        # lanes per segment under ~7% while the FFT stays small; the
        # floor (platform.py "fftfilt_nfft_floor") is small on the CPU
        # (cache-resident segments) and larger on the GPU (fewer, larger
        # batched FFTs), with the same 16x-overlap escape for long taps.
        from ..platform import policy
        floor = policy("fftfilt_nfft_floor")
        if block_len is not None:
            nfft = npow2(max(block_len, 2 * L))
        else:
            nfft = npow2(max(floor, 16 * (L - 1) if L > 1 else 2))
        nfft = min(nfft, npow2(T + L - 1))
        H = fft(params["h"].astype(jnp.complex64), nfft)
        xp = jnp.concatenate([carry.astype(x.dtype), x], axis=-1)
        new_carry = xp[..., xp.shape[-1] - (L - 1):] if L > 1 else carry

        hop = nfft - (L - 1)
        if hop <= 0 or T + L - 1 <= nfft:
            y_full = ifft(fft(xp, nfft) * H, normalize=True)
            y = y_full[..., L - 1: L - 1 + T]
        else:
            nseg = -(-T // hop)
            pad = (L - 1) + nseg * hop - xp.shape[-1]
            if pad > 0:
                xp = jnp.pad(xp, [(0, 0)] * (xp.ndim - 1) + [(0, pad)])
            idx = (np.arange(nseg)[:, None] * hop +
                   np.arange(nfft)[None, :])
            frames = xp[..., idx]                     # [..., nseg, nfft]
            Y = ifft(fft(frames, nfft) * H, normalize=True)
            y = Y[..., L - 1:].reshape(Y.shape[:-2] + (nseg * hop,))[..., :T]
        if not jnp.iscomplexobj(x):
            y = y.real
        return y, new_carry

    h_host = np.asarray(h * scale,
                        dtype=np.complex64 if np.iscomplexobj(h)
                        else np.float32)
    pa, pi = ((None, None) if np.iscomplexobj(h) else
              planar_per_plane(apply, init))
    return Proc(params={"h": hj}, init=init, apply=apply, rate=(1, 1),
                name=name, halo=L - 1, lti=LTI(h_host, 1, 0),
                planar_apply=pa, planar_init=pi)
