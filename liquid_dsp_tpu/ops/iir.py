"""IIR filtering: transposed direct-form II and second-order-section
cascades as lax.scan recurrences.

Reference analogs (studied, not copied):
  * iirfilt    — src/filter/src/iirfilt.c:49+ (DF2T with nb/na taps, or
                 SOS cascade mode selected at create).
  * iirfiltsos — src/filter/src/iirfiltsos.c (single biquad, used as the
                 PLL loop filter).

The time recurrence is sequential (SURVEY.md §7 hard-parts #1): lax.scan
per shard; batch/channel axes vectorize.  For long blocks XLA pipelines
the scan body; the state is O(order) — tiny.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core import Proc, planar_per_plane, scan_unroll

__all__ = ["iirfilt", "iirfilt_sos", "iir_apply_tf", "iir_apply_sos",
           "iir_freqresponse", "iir_group_delay",
           "iirfilt_integrator", "iirfilt_differentiator",
           "iirfilt_dc_blocker", "iirfilt_pll"]


def _norm_ba(b, a):
    b = np.atleast_1d(np.asarray(b))
    a = np.atleast_1d(np.asarray(a))
    b = b / a[0]
    a = a / a[0]
    return b, a


def iir_apply_tf(b, a, carry, x):
    """One block of DF2T IIR filtering; carry = internal state [n-1].

    y[t] = b0*x[t] + s0;  s_i = b_{i+1} x - a_{i+1} y + s_{i+1}
    (standard transposed direct form II, matching reference iirfilt.c).
    """
    n = max(b.shape[-1], a.shape[-1])
    bp = jnp.pad(b, (0, n - b.shape[-1]))
    ap = jnp.pad(a, (0, n - a.shape[-1]))

    def step(s, xt):
        y = bp[0] * xt + s[..., 0]
        s_new = (bp[1:] * xt[..., None] - ap[1:] * y[..., None]
                 + jnp.concatenate([s[..., 1:],
                                    jnp.zeros_like(s[..., :1])], axis=-1))
        return s_new, y

    xt = jnp.moveaxis(x, -1, 0)
    # unroll: the platform policy's (platform.scan_unroll)
    s, yt = lax.scan(step, carry, xt, unroll=scan_unroll(16))
    return jnp.moveaxis(yt, 0, -1), s


def iir_apply_sos(B, A, carry, x):
    """Cascade of biquads; B, A: [n_sections, 3]; carry: [..., n_sections, 2]."""
    ns = B.shape[0]

    def step(s, xt):
        y = xt
        new_s = []
        for k in range(ns):
            sk = s[..., k, :]
            yk = B[k, 0] * y + sk[..., 0]
            s0 = B[k, 1] * y - A[k, 1] * yk + sk[..., 1]
            s1 = B[k, 2] * y - A[k, 2] * yk
            new_s.append(jnp.stack([s0, s1], axis=-1))
            y = yk
        return jnp.stack(new_s, axis=-2), y

    xt = jnp.moveaxis(x, -1, 0)
    s, yt = lax.scan(step, carry, xt, unroll=scan_unroll(16))
    return jnp.moveaxis(yt, 0, -1), s


def _df2t_ss(b, a):
    """DF2T state-space realization in float64/complex128:
    s' = A s + Bv x,  y = s[0] + D x  (C = e0).

    The state vector IS the DF2T internal state used by iir_apply_tf, so
    carries are value-compatible across the scan and block backends.
    """
    n = max(len(b), len(a))
    dt = np.complex128 if (np.iscomplexobj(b) or np.iscomplexobj(a)) \
        else np.float64
    bp = np.zeros(n, dt)
    ap = np.zeros(n, dt)
    bp[:len(b)] = b
    ap[:len(a)] = a
    p = n - 1
    A = np.zeros((p, p), dt)
    A[:, 0] = -ap[1:]
    A[np.arange(p - 1), np.arange(1, p)] = 1.0
    Bv = bp[1:] - ap[1:] * bp[0]
    C = np.zeros(p, dt)
    C[0] = 1.0
    return A, Bv, C, dt(bp[0])


def _ss_cascade(sections):
    """Series-compose state-space systems; the composite state is the
    CONCATENATION of the per-section states (so an SOS cascade's block
    carry is exactly the stacked per-section DF2T states)."""
    A1, B1, C1, D1 = sections[0]
    for A2, B2, C2, D2 in sections[1:]:
        p1, p2 = A1.shape[0], A2.shape[0]
        dt = np.result_type(A1, A2)
        A = np.zeros((p1 + p2, p1 + p2), dt)
        A[:p1, :p1] = A1
        A[p1:, p1:] = A2
        A[p1:, :p1] = np.outer(B2, C1)
        B1 = np.concatenate([B1, B2 * D1])
        C1 = np.concatenate([C1 * D2, C2])
        A1, D1 = A, D1 * D2
    return A1, B1, C1, D1


def _block_mats(A, Bv, C, D, L):
    """Precompute the exact block-processing operators for one L-block:
    y = Th @ u + Obs @ s0  (intra-block Toeplitz of the impulse response
    plus the zero-input response), s' = A^L s0 + K @ u.  All float64 on
    the host, cast to f32/c64 for the device."""
    p = A.shape[0]
    Apow = np.empty((L + 1, p, p), A.dtype)
    Apow[0] = np.eye(p, dtype=A.dtype)
    for k in range(1, L + 1):
        Apow[k] = Apow[k - 1] @ A
    h = np.empty(L, A.dtype)
    h[0] = D
    if L > 1:
        h[1:] = np.einsum("j,ijk,k->i", C, Apow[:L - 1], Bv)
    ii, kk = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    Th = np.where(ii >= kk, h[np.clip(ii - kk, 0, L - 1)], 0.0)
    Obs = np.einsum("j,ijk->ik", C, Apow[:L])              # [L, p]
    K = np.einsum("ijk,k->ji", Apow[L - 1::-1], Bv)        # [p, L]
    cplx = np.iscomplexobj(A)
    cast = (lambda m: np.asarray(m, np.complex64 if cplx else np.float32))
    return {"Th": cast(Th), "Obs": cast(Obs), "K": cast(K),
            "Apow": cast(Apow)}


def iir_apply_block(params, carry, x):
    """Exact block-processed IIR: intra-block outputs are one
    lower-triangular Toeplitz matmul of the impulse response,
    inter-block state flows through a lax.scan of length T/L with an
    O(order)-dim state — the block formulation of the sequential
    recurrence (the intra-block part is NOT a truncation: the carried
    state supplies the entire past exactly).  Reference analog:
    src/filter/src/iirfilt.c:49+ executes the same filter per-sample.

    Matmuls are pinned HIGHEST: the outputs feed golden accuracy
    contracts (CLAUDE.md precision rule)."""
    Th = jnp.asarray(params["Th"])
    Obs = jnp.asarray(params["Obs"])
    K = jnp.asarray(params["K"])
    Apow = jnp.asarray(params["Apow"])
    L, p = Obs.shape
    HI = lax.Precision.HIGHEST
    batch = x.shape[:-1]
    s = carry.reshape(batch + (p,))
    T = x.shape[-1]
    nb, r = divmod(T, L)
    outs = []
    if nb:
        xb = x[..., :nb * L].reshape(batch + (nb, L))
        w = jnp.einsum("...nl,pl->...np", xb, K, precision=HI)
        wt = jnp.moveaxis(w, -2, 0)
        ALT = Apow[L].T

        def step(si, wn):
            return jnp.matmul(si, ALT.astype(si.dtype),
                              precision=HI) + wn, si

        s, s_pre = lax.scan(step, s, wt, unroll=scan_unroll(8))
        s_pre = jnp.moveaxis(s_pre, 0, -2)
        yb = (jnp.einsum("...nl,ml->...nm", xb, Th, precision=HI)
              + jnp.einsum("...np,mp->...nm", s_pre, Obs, precision=HI))
        outs.append(yb.reshape(batch + (nb * L,)))
    if r:
        xr = x[..., nb * L:]
        yr = (jnp.einsum("...l,ml->...m", xr, Th[:r, :r], precision=HI)
              + jnp.einsum("...p,mp->...m", s, Obs[:r], precision=HI))
        outs.append(yr)
        s = (jnp.einsum("...p,qp->...q", s, Apow[r], precision=HI)
             + jnp.einsum("...l,ql->...q", xr, K[:, L - r:], precision=HI))
    y = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)
    return y, s.reshape(carry.shape)


def _resolve_iir_backend(backend: str, A) -> str:
    """'auto' picks the block formulation off-CPU (the CPU default stays
    the bit-compatible scan); unstable/overflowing systems (spectral
    radius > ~1) fall back to scan — A^L is not representable."""
    if backend not in ("auto", "scan", "block", "pscan"):
        raise ValueError(f"unknown iir backend {backend!r}")
    if backend == "auto":
        # 'auto' stays unresolved until trace time (like fir_apply_auto):
        # the Proc carries BOTH param sets so a Proc built under one
        # backend runs correctly under another.  Unstable
        # filters pin scan (the block form's A^L powers overflow).
        if _iir_stable(A):
            return "auto"
        return "scan"
    if backend == "block" and not _iir_stable(A):
        backend = "scan"
    return backend


def _iir_stable(A) -> bool:
    return (A.shape[0] == 0
            or np.abs(np.linalg.eigvals(A)).max() <= 1.0 + 1e-9)


def _auto_is_block() -> bool:
    """Trace-time backend pick for iir backend='auto': the platform
    policy's "iir_block" entry (platform.py)."""
    from ..platform import policy
    return policy("iir_block")


def iirfilt(b, a, name: str = "iirfilt", backend: str = "auto",
            block_size: int = 128) -> Proc:
    """IIR filter from transfer-function coefficients (reference
    iirfilt_crcf_create).

    backend: 'scan' (sequential lax.scan, CPU default), 'block' (exact
    block state-space processing, off-CPU default — see iir_apply_block),
    or 'auto'."""
    if backend == "pscan":
        raise ValueError("pscan backend is SOS-only (iirfilt_sos)")
    b, a = _norm_ba(b, a)
    n = max(len(b), len(a))
    cplx = np.iscomplexobj(b) or np.iscomplexobj(a)
    bj = jnp.asarray(b.astype(np.complex64 if cplx else np.float32))
    aj = jnp.asarray(a.astype(np.complex64 if cplx else np.float32))
    ss = _df2t_ss(b, a)
    backend = _resolve_iir_backend(backend, ss[0])
    if backend == "auto":
        params = {"b": bj, "a": aj, **_block_mats(*ss, block_size)}
    elif backend == "block":
        params = _block_mats(*ss, block_size)
    else:
        params = {"b": bj, "a": aj}

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (n - 1,), dtype)

    def apply(params, carry, x):
        use_block = (backend == "block"
                     or (backend == "auto" and _auto_is_block()))
        if use_block:
            return iir_apply_block(params, carry.astype(x.dtype), x)
        return iir_apply_tf(params["b"], params["a"],
                            carry.astype(x.dtype), x)

    pa, pi = ((None, None) if cplx
              else planar_per_plane(apply, init))
    return Proc(params=params, init=init, apply=apply, name=name,
                planar_apply=pa, planar_init=pi)


def iir_apply_sos_pscan(B, A, carry, x):
    """Biquad cascade via parallel (associative) scan: each section's
    DF2T update is a linear recurrence s[n] = M s[n-1] + v[n], so the
    whole block evaluates in O(log T) depth on the device instead of a
    sequential T-step loop — an algorithm change the reference
    has no analog for (SURVEY.md §7 hard-parts #1 strategy).

    Same state convention as iir_apply_sos: carry [..., ns, 2].
    """
    ns = B.shape[0]
    y = x
    new_states = []
    for k in range(ns):
        b0, b1, b2 = B[k, 0], B[k, 1], B[k, 2]
        a1, a2 = A[k, 1], A[k, 2]
        # DF2T: y = b0 x + s0;  s0' = b1 x - a1 y + s1;  s1' = b2 x - a2 y
        # substitute y: s0' = (b1 - a1 b0) x - a1 s0 + s1
        #               s1' = (b2 - a2 b0) x - a2 s0
        M = jnp.asarray([[-a1, 1.0], [-a2, 0.0]], x.dtype)
        c1 = b1 - a1 * b0
        c2 = b2 - a2 * b0
        T = y.shape[-1]
        v = jnp.stack([c1 * y, c2 * y], axis=-1)          # [..., T, 2]
        Ms = jnp.broadcast_to(M, y.shape[:-1] + (T, 2, 2))

        def combine(l, r):
            Ml, vl = l
            Mr, vr = r
            return (Mr @ Ml,
                    jnp.einsum("...ij,...j->...i", Mr, vl) + vr)

        Mc, vc = jax.lax.associative_scan(combine, (Ms, v), axis=-3)
        s_prev = carry[..., k, :]
        # state AFTER step n: s[n] = Mc[n] s_init + vc[n]
        s_all = jnp.einsum("...tij,...j->...ti", Mc, s_prev) + vc
        # y[n] = b0 x[n] + s0[n-1]
        s0_prev = jnp.concatenate(
            [s_prev[..., None, 0], s_all[..., :-1, 0]], axis=-1)
        y = b0 * y + s0_prev
        new_states.append(s_all[..., -1, :])
    return y, jnp.stack(new_states, axis=-2)


def iirfilt_sos(B, A, name: str = "iirfilt_sos",
                backend: str = "auto", block_size: int = 128) -> Proc:
    """IIR filter as a second-order-section cascade (reference
    iirfilt_crcf_create_sos); B, A: [n_sections, 3] with A[:,0]=1.

    backend: 'scan' (sequential lax.scan, CPU default), 'block' (exact
    block state-space processing of the composed cascade, off-CPU
    default — the carry stays the stacked per-section DF2T states, so
    it is value-compatible with scan), 'pscan' (parallel associative
    scan; kept for reference — far slower than scan on the accelerator
    this was first tuned on, not measured on H100),
    or 'auto'."""
    B = np.atleast_2d(np.asarray(B, np.float32))
    A = np.atleast_2d(np.asarray(A, np.float32))
    A0 = A[:, :1]
    B = B / A0
    A = A / A0
    ns = B.shape[0]
    # cast on the host: the device sees 32-bit coefficients
    B = np.asarray(B)
    A = np.asarray(A)
    cplx = np.iscomplexobj(B) or np.iscomplexobj(A)
    Bj = jnp.asarray(B.astype(np.complex64 if cplx else np.float32))
    Aj = jnp.asarray(A.astype(np.complex64 if cplx else np.float32))
    ss = _ss_cascade([_df2t_ss(np.asarray(B[k], np.float64 if not cplx
                                          else np.complex128),
                               np.asarray(A[k], np.float64 if not cplx
                                          else np.complex128))
                      for k in range(ns)])
    backend = _resolve_iir_backend(backend, ss[0])
    if backend == "auto":
        params = {"B": Bj, "A": Aj, **_block_mats(*ss, block_size)}
    elif backend == "block":
        params = _block_mats(*ss, block_size)
    else:
        params = {"B": Bj, "A": Aj}

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape + (ns, 2), dtype)

    def apply(params, carry, x):
        use_block = (backend == "block"
                     or (backend == "auto" and _auto_is_block()))
        if use_block:
            return iir_apply_block(params, carry.astype(x.dtype), x)
        fn = iir_apply_sos_pscan if backend == "pscan" else iir_apply_sos
        return fn(params["B"], params["A"], carry.astype(x.dtype), x)

    pa, pi = (None, None) if cplx else planar_per_plane(apply, init)
    return Proc(params=params, init=init, apply=apply, name=name,
                planar_apply=pa, planar_init=pi)


def iir_freqresponse(b, a, fc):
    """H(e^{j 2 pi fc}) for transfer-function coefficients."""
    b = np.atleast_1d(b)
    a = np.atleast_1d(a)
    z = np.exp(-2j * np.pi * np.asarray(fc))  # z := z^-1
    num = sum(bk * z ** k for k, bk in enumerate(b))
    den = sum(ak * z ** k for k, ak in enumerate(a))
    return num / den


def iir_group_delay(b, a, fc, df: float = 1e-4):
    """Group delay via numerical phase derivative (reference
    group_delay.c iir_group_delay semantics)."""
    h1 = iir_freqresponse(b, a, fc - df / 2)
    h2 = iir_freqresponse(b, a, fc + df / 2)
    dphi = np.angle(h2 * np.conj(h1))
    return -dphi / (2 * np.pi * df)


# ---------------------------------------------------------------------------
# factory constructors (reference iirfilt.c:264-411)


def _pintelon_sos(mags_z, args_z, mags_p, args_p, k):
    """Digital zpk (magnitude/angle-in-degrees form, as published in
    [Pintelon:1990]) -> SOS arrays via design.iirdes.zpk2sos."""
    from ..design.iirdes import zpk2sos
    z = np.asarray(mags_z) * np.exp(1j * np.deg2rad(np.asarray(args_z)))
    p = np.asarray(mags_p) * np.exp(1j * np.deg2rad(np.asarray(args_p)))
    return zpk2sos(z, p, k)


def iirfilt_integrator(name: str = "iirfilt_integrator") -> Proc:
    """8th-order digital integrator, [Pintelon:1990] Table II constants
    (studied from reference iirfilt_xxx_create_integrator,
    src/filter/src/iirfilt.c:264-310)."""
    B, A = _pintelon_sos(
        [1.175839, 3.371020, 3.371020, 4.549710, 4.549710,
         5.223966, 5.223966, 5.443743],
        [180.0, -125.1125, 125.1125, -80.96404, 80.96404,
         -40.09347, 40.09347, 0.0],
        [0.5805235, 0.2332021, 0.2332021, 0.1814755, 0.1814755,
         0.1641457, 0.1641457, 1.0],
        [180.0, -114.0968, 114.0968, -66.33969, 66.33969,
         -21.89539, 21.89539, 0.0],
        -1.89213380759321e-05)
    return iirfilt_sos(B, A, name=name)


def iirfilt_differentiator(name: str = "iirfilt_differentiator") -> Proc:
    """8th-order digital differentiator, [Pintelon:1990] Table IV
    constants (reference iirfilt.c:313-359)."""
    B, A = _pintelon_sos(
        [1.702575, 5.877385, 5.877385, 4.197421, 4.197421,
         5.350284, 5.350284, 1.0],
        [180.0, -221.4063, 221.4063, -144.5972, 144.5972,
         -66.88802, 66.88802, 0.0],
        [0.8476936, 0.2990781, 0.2990781, 0.2232427, 0.2232427,
         0.1958670, 0.1958670, 0.1886088],
        [180.0, -125.5188, 125.5188, -81.52326, 81.52326,
         -40.51510, 40.51510, 0.0],
        2.09049284907492e-05)
    return iirfilt_sos(B, A, name=name)


def iirfilt_dc_blocker(alpha: float,
                       name: str = "iirfilt_dc_blocker") -> Proc:
    """First-order DC-blocking filter H(z) = (1 - z^-1)/(1 - (1-a)z^-1)
    (reference iirfilt.c:366-376)."""
    if not (0.0 < alpha < 1.0):
        raise ValueError("alpha must be in (0, 1)")
    b = np.array([1.0, -1.0], np.float32)
    a = np.array([1.0, -1.0 + alpha], np.float32)
    return iirfilt(b, a, name=name)


def iirfilt_pll(w: float, zeta: float = 0.7071, K: float = 1000.0,
                name: str = "iirfilt_pll") -> Proc:
    """Phase-locked-loop loop filter: one active-lag second-order
    section (reference iirfilt.c:382-411)."""
    if not (0.0 < w < 1.0):
        raise ValueError("bandwidth must be in (0, 1)")
    if not (0.0 < zeta < 1.0):
        raise ValueError("damping factor must be in (0, 1)")
    if K <= 0.0:
        raise ValueError("loop gain must be positive")
    from ..design.iirdes import iirdes_pll_active_lag
    b, a = iirdes_pll_active_lag(w, zeta, K)
    return iirfilt_sos(b[None, :], a[None, :], name=name)
