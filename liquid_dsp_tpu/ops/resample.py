"""Rate conversion: halfband (resamp2), dyadic cascade (msresamp2),
arbitrary polyphase (resamp), and multi-stage arbitrary (msresamp).

Reference analogs (studied, not copied — see SURVEY.md §2.3, §3.3):
  * resamp2  — src/filter/src/resamp2.c:60-124 (4m+1-tap halfband Kaiser
               prototype; decim/interp/analyzer/synthesizer modes).
  * msresamp2— src/filter/src/msresamp2.c (cascade of resamp2 stages).
  * resamp   — src/filter/src/resamp.c:45-308: per-sample loop with timing
               phase ``tau``, soft filterbank index ``bf = tau*npfb``,
               firpfb branch pair + linear interpolation.  The phase
               recurrence (resamp.c:305-307) is AFFINE in the sample index,
               so a whole block's branch indices are computable in closed
               form — the sequential per-sample loop becomes one gather +
               two batched dot products (the key vectorization; SURVEY.md
               §3.3 note).
  * msresamp — src/filter/src/msresamp.c:95-135: halfband cascade brings the
               rate into (0.5, 2], then an arbitrary resamp cleans up.

Block/carry design: rates are exact rationals (num, den).  A block of T
input samples (T % den == 0) emits exactly T*num/den outputs, and the
timing phase returns to the same value after every block — so shapes are
static under jit and the carry is just the filter tail (plus the phase
scalar, which lets blocks start mid-stream).
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp

from ..core import LTI, Proc, chain, planar_per_plane
from ..design.windows import kaiser, kaiser_beta_as
from .fir import firinterp, fir_apply, fir_apply_auto, _as_jnp_taps

__all__ = [
    "halfband_taps", "resamp2_decim", "resamp2_interp",
    "resamp2_analyzer", "resamp2_synthesizer",
    "msresamp2", "resamp", "msresamp", "as_rational",
]


def halfband_taps(m: int, f0: float = 0.0, as_db: float = 60.0) -> np.ndarray:
    """Kaiser-windowed halfband prototype, length 4m+1.

    Matches the construction in reference resamp2.c:95-106:
    h[i] = sinc(t/2) * kaiser(i; beta(As)) * exp(j*2*pi*t*f0), t = i - 2m.
    """
    if m < 2:
        raise ValueError("resamp2 filter semi-length must be at least 2")
    n = 4 * m + 1
    t = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(t / 2.0) * kaiser(n, kaiser_beta_as(as_db))
    if f0 != 0.0:
        h = h * np.exp(2j * np.pi * t * f0)
    return h.astype(np.complex64 if f0 != 0.0 else np.float32)


def resamp2_decim(m: int = 7, f0: float = 0.0, as_db: float = 60.0,
                  name: str = "resamp2_decim") -> Proc:
    """Halfband 2:1 decimator, sample-exact vs the reference
    (resamp2_crcf_decim_execute): y[i] = x_odd[i-m] + (h_odd * x_even)[i]
    — the odd input phase is delayed m (half-rate) samples, the even
    phase runs through the 2m odd-position taps of the halfband
    prototype.  DC gain 2, matching the reference (the analyzer form
    halves each branch; the decimator does not)."""
    full = halfband_taps(m, f0, as_db)
    h1 = np.ascontiguousarray(full[1::2])       # [2m] odd-position taps
    h1j = _as_jnp_taps(h1)
    L = 2 * m
    # carry = last H RAW input samples (even, so phase parity is
    # preserved): the even-phase FIR needs L-1 past even samples and the
    # delayed odd phase needs m past odd samples, both contained in the
    # last 4m-2 raw samples.  A raw-sample tail carry makes this stage
    # time-shardable via the standard ppermute halo exchange
    # (parallel/stream.py).
    H = 4 * m - 2

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (H,), dtype)

    def apply(params, carry, x):
        (h1_,) = params
        xa = jnp.concatenate([carry.astype(x.dtype), x], axis=-1)
        xe = xa[..., 0::2]                      # [..., (L-1) + T/2]
        xo = xa[..., 1::2]
        y1, _ = fir_apply_auto(h1_, xe[..., : L - 1], xe[..., L - 1:])
        y0 = xo[..., m - 1: xo.shape[-1] - m]   # odd phase delayed by m
        return y0 + y1, xa[..., xa.shape[-1] - H:]

    # LTI view for chain fusion: y[i] = sum_j full[j] x[2i + 1 - j]
    # (even prototype taps vanish except the unit center, which lands on
    # the delayed odd phase; odd taps hit the even phase — same samples).
    from .fir import _np_taps
    pa, pi = ((None, None) if np.iscomplexobj(h1) else
              planar_per_plane(apply, init))
    return Proc(params=(h1j,), init=init, apply=apply, rate=(1, 2),
                name=name, halo=H, lti=LTI(_np_taps(full), 2, 1),
                planar_apply=pa, planar_init=pi)


def resamp2_interp(m: int = 7, f0: float = 0.0, as_db: float = 60.0,
                   name: str = "resamp2_interp") -> Proc:
    """Halfband 1:2 interpolator (reference resamp2_crcf_interp,
    resamp2.c:345): zero-stuff then halfband filter (unity passband gain)."""
    return firinterp(2, halfband_taps(m, f0, as_db), name=name)


def _halfband_branches(m: int, as_db: float):
    """(h1, delay) — the 2m-tap odd-sample branch and center delay, as used
    by the analyzer/synthesizer QMF forms (reference resamp2.c:108-116)."""
    h = halfband_taps(m, 0.0, as_db)
    # odd taps, reversed (reference resamp2.c:109-111)
    h1 = h[::-1][1::2].copy()
    return h1


def resamp2_analyzer(m: int = 7, as_db: float = 60.0,
                     name: str = "resamp2_analyzer") -> Proc:
    """Quadrature-mirror analysis bank: [..., T] -> [..., 2, T//2]
    (low band, high band).  Reference resamp2.c:271-292:
    y0 = filt + delay, y1 = filt - delay with inputs scaled by 1/2.
    """
    h1 = _as_jnp_taps(_halfband_branches(m, as_db))
    L = int(h1.shape[-1])  # 2m

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"w0": jnp.zeros(batch_shape + (m,), dtype),
                "w1": jnp.zeros(batch_shape + (L - 1,), dtype)}

    # Delay branch = odd samples delayed by (m-1); filter branch =
    # conv(even samples, h1).  Both length T//2.
    def apply(params, carry, x):
        (h1_,) = params
        x = 0.5 * x
        x1 = x[..., 0::2]
        x0 = x[..., 1::2]
        xp0 = jnp.concatenate([carry["w0"].astype(x.dtype), x0], axis=-1)
        yd = xp0[..., : x0.shape[-1]]
        y1f, w1 = fir_apply_auto(h1_, carry["w1"].astype(x.dtype), x1)
        new_carry = {"w0": xp0[..., x0.shape[-1]:], "w1": w1}
        lo = y1f + yd
        hi = y1f - yd
        return jnp.stack([lo, hi], axis=-2), new_carry

    return Proc(params=(h1,), init=init, apply=apply, rate=(1, 1), name=name)


def resamp2_synthesizer(m: int = 7, as_db: float = 60.0,
                        name: str = "resamp2_synth") -> Proc:
    """Quadrature-mirror synthesis bank: [..., 2, T//2] -> [..., T].
    Reference resamp2.c:296+ (dual of the analyzer)."""
    h1 = _as_jnp_taps(_halfband_branches(m, as_db))
    L = int(h1.shape[-1])

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"w0": jnp.zeros(batch_shape + (m,), dtype),
                "w1": jnp.zeros(batch_shape + (L - 1,), dtype)}

    def apply(params, carry, x):
        (h1_,) = params
        lo = x[..., 0, :]
        hi = x[..., 1, :]
        s = lo + hi            # feeds delay branch (reference resamp2.c:302)
        d = lo - hi            # feeds filter branch (resamp2.c:303)
        xps = jnp.concatenate([carry["w0"].astype(s.dtype), s], axis=-1)
        yd = xps[..., : s.shape[-1]]
        yf, w1 = fir_apply_auto(h1_, carry["w1"].astype(d.dtype), d)
        new_carry = {"w0": xps[..., s.shape[-1]:], "w1": w1}
        # interleave: even samples from delay branch, odd from filter
        y = jnp.stack([yd, yf], axis=-1).reshape(*yf.shape[:-1],
                                                 2 * yf.shape[-1])
        return y, new_carry

    return Proc(params=(h1,), init=init, apply=apply, rate=(1, 1), name=name)


def msresamp2(direction: str, num_stages: int, fc: float = 0.4,
              f0: float = 0.0, as_db: float = 60.0,
              name: str = "msresamp2") -> Proc:
    """Dyadic 2^k resampler: cascade of halfband stages (reference
    msresamp2.c:38).  direction: 'interp' | 'decim'."""
    if num_stages == 0:
        # identity
        def init(batch_shape=(), dtype=jnp.complex64):
            return ()

        return Proc(params=(), init=init,
                    apply=lambda p, c, x: (x, c), rate=(1, 1), name=name,
                    halo=0)
    # reference stage design (msresamp2.c create): fc halves per stage,
    # each stage's semi-length from the transition band ft = (0.5-fc)/2
    # via the Kaiser length estimate, m = ceil((h_len-1)/4)
    from ..design.firdes import estimate_req_filter_len
    stages = []
    fc_i = fc
    for s in range(num_stages):
        fc_i = 0.5 * fc_i
        ft = (0.5 - fc_i) / 2.0
        h_len = estimate_req_filter_len(ft, as_db)
        m_stage = max(2, int(np.ceil((h_len - 1) / 4.0)))
        if direction == "decim":
            stages.append(resamp2_decim(m_stage, f0, as_db,
                                        name=f"{name}_hb{s}"))
        elif direction == "interp":
            stages.append(resamp2_interp(m_stage, f0, as_db,
                                         name=f"{name}_hb{s}"))
        else:
            raise ValueError(f"unknown direction {direction!r}")
    if direction == "interp":
        stages = stages[::-1]
    if direction == "decim":
        # each halfband decim stage has DC gain 2 (reference decimator
        # form); msresamp2 compensates with zeta = 2^-num_stages
        # (reference msresamp2.c:125,352)
        zeta = np.float32(0.5 ** num_stages)

        def gain_init(batch_shape=(), dtype=jnp.complex64):
            return ()

        stages.append(Proc(params=(), init=gain_init,
                           apply=lambda p, c, x: (zeta * x, c),
                           rate=(1, 1), name=f"{name}_zeta", halo=0,
                           lti=LTI(np.array([zeta], np.float32), 1, 0)))
    return chain(*stages, name=name)


def as_rational(rate, max_den: int = 1 << 12):
    """Normalize a rate spec to an exact (num, den) pair."""
    if isinstance(rate, tuple):
        fr = Fraction(rate[0], rate[1])
    else:
        fr = Fraction(rate).limit_denominator(max_den)
    if fr <= 0:
        raise ValueError("resampling rate must be positive")
    return fr.numerator, fr.denominator


def _pfb_taps(npfb: int, m: int, fc: float, as_db: float) -> np.ndarray:
    """Polyphase bank coefficient matrix [npfb, 2m].

    Prototype: length 2*m*npfb+1 Kaiser lowpass at fc/npfb, normalized to
    DC gain npfb (reference resamp.c:117-131); branch b taps are
    h[j*npfb + b] (delay-major layout).
    """
    from ..design.firdes import firdes_kaiser
    n = 2 * m * npfb + 1
    hf = firdes_kaiser(n, fc / npfb, as_db)
    hf = hf * (npfb / np.sum(hf))
    return hf[: n - 1].reshape(2 * m, npfb).T.astype(np.float32).copy()


def resamp(rate, m: int = 7, fc: float = 0.25, as_db: float = 60.0,
           npfb: int = 64, name: str = "resamp",
           backend: str = "auto") -> Proc:
    """Arbitrary-rate polyphase resampler (reference resamp.c).

    rate may be a float (rationalized) or an exact (num, den) tuple.
    Block constraint: T % den == 0, so each block emits exactly
    T * num / den samples and all shapes are static under jit.

    Device formulation: output k of a block lies at input position
    t_k = phi + k*den/num; its base sample i_k = floor(t_k) and soft bank
    index bf = frac(t_k)*npfb select pfb branches b, b+1 whose outputs are
    linearly interpolated (reference resamp.c:275-289).  All indices are
    affine in k (resamp.c:305-307 recurrence solved in closed form), so the
    block is one gather + two batched dot products.
    """
    num, den = as_rational(rate)
    H_host = _pfb_taps(npfb, m, fc, as_db)          # [npfb, 2m]
    H = jnp.asarray(H_host)
    L = 2 * m

    # per-phase-class taps: outputs k = num*j + c share one static phase
    # per class c (block phase stays integral since den | T), so class c
    # is one strided FIR — num dense convolutions replace the gather.
    # Combined support is L+1 to absorb the branch-wrap case (the
    # reference's boundary state evaluates branch 0 one sample later).
    Hc_host = np.zeros((num, L + 1), np.float32)
    qc_host = np.zeros(num, np.int32)
    for c in range(num):
        r_c = (c * den) % num
        qc_host[c] = (c * den) // num
        bf = (r_c / num) * npfb
        b = min(int(bf), npfb - 1)
        mu = bf - b
        # H rows index the n-th NEWEST sample (liquid firpfb loads taps
        # reversed); the conv window is ascending in time, so flip.
        if b + 1 < npfb:
            Hc_host[c, :L] = ((1 - mu) * H_host[b] +
                              mu * H_host[b + 1])[::-1]
        else:
            Hc_host[c, :L] = ((1 - mu) * H_host[b])[::-1]
            Hc_host[c, 1:] += (mu * H_host[0])[::-1]
    Hc = jnp.asarray(Hc_host)
    params = (H, Hc)

    # --- rational banded matmul ---
    # One rectangular band matrix maps overlapped input frames straight
    # to interleaved outputs: column (p*num + c) holds class c's
    # combined taps at row offset p*den + qc[c] + 1, so a frame of
    # tile_in inputs emits tile_in*num/den outputs as ONE matmul
    # instead of per-class feature-dim-1 convs (the policy's
    # "resamp_banded" entry picks).  Same math, same closed-form branch
    # schedule.
    tile_in = -(-192 // den) * den              # ~192-256, multiple of den
    P_t = tile_in // den
    tile_out = P_t * num
    rs_rows = tile_in + L + 1

    def _resamp_band() -> np.ndarray:
        B = np.zeros((rs_rows, tile_out), np.float32)
        for p in range(P_t):
            for c in range(num):
                r0 = p * den + int(qc_host[c]) + 1
                B[r0:r0 + L + 1, p * num + c] = Hc_host[c]
        return B

    band_host = _resamp_band() if num <= 64 else None

    def _banded_resamp(xp, T, n_out):
        """xp [.., L+T] (tail prefix included) -> y [.., n_out]
        (the shared banded-matmul skeleton, HIGHEST precision — resamp
        goldens are sample-exact and a default-precision product may
        run in TF32)."""
        from .fir import banded_blocks_apply
        return banded_blocks_apply(band_host, xp, n_out, tile_in,
                                   tile_out)

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"tail": jnp.zeros(batch_shape + (L,), dtype),
                "phi": jnp.zeros((), jnp.float64 if False else jnp.float32)}

    def apply(params, carry, x):
        from ..platform import policy
        H_, Hc_ = params
        T = x.shape[-1]
        if T % den != 0:
            raise ValueError(
                f"resamp rate {num}/{den}: block length {T} must be a "
                f"multiple of {den}")
        n_out = T * num // den
        xp = jnp.concatenate([carry["tail"].astype(x.dtype), x], axis=-1)
        use_band = num <= 64 and (
            backend == "matmul" or
            (backend == "auto" and policy("resamp_banded")))
        if use_band:
            # banded rectangular matmul (platform.py "resamp_banded")
            y = _banded_resamp(xp, T, n_out)
            new_carry = {"tail": xp[..., xp.shape[-1] - L:],
                         "phi": carry["phi"]}
            return y, new_carry
        if num <= 64:
            # class formulation: num strided convs (CPU: conv wins)
            J = T // den
            batch_shape = x.shape[:-1]
            xb = xp.reshape((-1, 1, xp.shape[-1]))
            xpad = jnp.pad(xb, ((0, 0), (0, 0), (0, 1)))
            ys = []
            for c in range(num):
                start = int(qc_host[c]) + 1
                w = Hc_[c].astype(x.dtype)[None, None, :]
                seg = jax.lax.dynamic_slice_in_dim(
                    xpad, start, (J - 1) * den + L + 1, axis=-1)
                yc = jax.lax.conv_general_dilated(
                    seg, w, (den,), "VALID")[:, 0]
                ys.append(yc)
            y = jnp.stack(ys, axis=-1).reshape((-1, J * num))
            y = y.reshape(batch_shape + (n_out,)) if batch_shape else \
                y.reshape((n_out,))
            new_carry = {"tail": xp[..., xp.shape[-1] - L:],
                         "phi": carry["phi"]}
            return y, new_carry
        k = jnp.arange(n_out)
        # exact integer split of t_k = phi + k*den/num:
        #   k*den = q*num + r  ->  t_k = phi + q + r/num
        q, r = jnp.divmod(k * den, num)
        frac = carry["phi"] + r.astype(jnp.float32) / num
        # phi in [0, 1): may push frac past 1
        i = q + frac.astype(jnp.int32)          # base input index
        frac = frac - jnp.floor(frac)
        bf = frac * npfb
        b = jnp.minimum(bf.astype(jnp.int32), npfb - 1)
        mu = bf - b
        # branch b+1 may wrap to branch 0 of the NEXT sample
        # (reference resamp.c boundary state, resamp.c:252-262)
        b1 = b + 1
        i1 = i + b1 // npfb
        b1 = b1 % npfb
        # output at base index i uses the window ENDING at x[i] (the
        # reference pushes x[i] before emitting, resamp.c:246): in padded
        # coords (L-sample tail prefix) that is xp[i+1 .. i+L]
        j = jnp.arange(L)
        w0 = jnp.take(xp, i[:, None] + 1 + j[None, :], axis=-1)  # [..., n_out, L]
        w1 = jnp.take(xp, i1[:, None] + 1 + j[None, :], axis=-1)
        t0 = jnp.take(H_, b, axis=0)[..., ::-1]   # [n_out, L] newest-first flip
        t1 = jnp.take(H_, b1, axis=0)[..., ::-1]
        y0 = jnp.einsum("...kj,kj->...k", w0, t0.astype(x.dtype)
                        if jnp.iscomplexobj(x) else t0)
        y1 = jnp.einsum("...kj,kj->...k", w1, t1.astype(x.dtype)
                        if jnp.iscomplexobj(x) else t1)
        y = y0 + mu.astype(y0.dtype) * (y1 - y0)
        new_phi = carry["phi"]  # invariant when den | T
        new_carry = {"tail": xp[..., xp.shape[-1] - L:], "phi": new_phi}
        return y, new_carry

    return Proc(params=params, init=init, apply=apply, rate=(num, den),
                name=name)


def msresamp(rate, as_db: float = 60.0, name: str = "msresamp") -> Proc:
    """Multi-stage arbitrary resampler (reference msresamp.c:95-135):
    halfband cascade brings the rate into (0.5, 2], an arbitrary
    polyphase resampler handles the remainder (m=7, fc=0.4, npfb=64 —
    reference msresamp.c:134)."""
    num, den = as_rational(rate)
    r = num / den
    n_hb = 0
    arb = Fraction(num, den)
    if r > 1.0:
        # boundary inclusive: exact powers of two resolve entirely into
        # halfband stages (the arb polyphase stage at rate 1 would cost
        # a full gather+dot pass for nothing)
        while arb >= 2:
            n_hb += 1
            arb = arb / 2
        stages = []
        if arb != 1:
            stages.append(resamp((arb.numerator, arb.denominator),
                                 m=7, fc=0.4, as_db=as_db, npfb=64,
                                 name=f"{name}_arb"))
        if n_hb:
            stages.append(msresamp2("interp", n_hb, 0.4, 0.0, as_db,
                                    name=f"{name}_hb"))
        return chain(*stages, name=name)
    else:
        while arb <= Fraction(1, 2):
            n_hb += 1
            arb = arb * 2
        stages = []
        if n_hb:
            stages.append(msresamp2("decim", n_hb, 0.4, 0.0, as_db,
                                    name=f"{name}_hb"))
        if arb != 1:
            stages.append(resamp((arb.numerator, arb.denominator),
                                 m=7, fc=0.4, as_db=as_db, npfb=64,
                                 name=f"{name}_arb"))
        return chain(*stages, name=name)
