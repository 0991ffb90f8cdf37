"""Symbol timing recovery (symsync): polyphase matched-filter pair with
a timing-error feedback loop.

Reference analog (studied, not copied): reference src/filter/src/
symsync.c:76-607 — matched + derivative-matched firpfb pair; timing
error q = Re(conj(mf)*dmf) ([Mengali:1997] Eq. 8.3.5, symsync.c:530),
2nd-order IIR loop filter (coefficients from set_lf_bw, symsync.c:380-
407), timing phase tau advances by `del` per output with the
resamp-style filterbank index recurrence.

Design: the per-sample feedback loop is a lax.scan over input
samples (SURVEY.md §7 hard part #1).  Each input step emits at most
ceil(rate)+1 outputs; outputs are returned padded with a validity mask
plus a count (variable-rate output, SURVEY.md §7 hard part #2).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..core import Proc, scan_unroll
from ..design.firdes import firdes_prototype
from ..platform import policy

__all__ = ["symsync", "symsync_run", "symsync_banks",
           "symsync_kaiser_banks", "symsync_kaiser"]


def symsync_banks(ftype: str, k: int, m: int, beta: float, npfb: int):
    """(MF, dMF) polyphase banks [npfb, 2*k*m] (reference
    firpfb_create_rnyquist / _create_drnyquist, firpfb.c:188-213)."""
    H = firdes_prototype(ftype, k * npfb, m, beta).astype(np.float64)
    return _derivative_bank(H, npfb)


def _derivative_bank(H: np.ndarray, npfb: int):
    """Central-difference derivative prototype, normalized like
    symsync_banks (reference firpfb _create_drnyquist scaling)."""
    dH = np.empty_like(H)
    dH[1:-1] = H[2:] - H[:-2]
    dH[0] = H[1] - H[-1]
    dH[-1] = H[0] - H[-2]
    dH *= 0.06 / np.max(np.abs(H * dH))
    Lb = (len(H) - 1) // npfb
    mf = np.stack([H[b + np.arange(Lb) * npfb] for b in range(npfb)])
    dmf = np.stack([dH[b + np.arange(Lb) * npfb] for b in range(npfb)])
    return mf.astype(np.float32), dmf.astype(np.float32)


def symsync_kaiser_banks(k: int, m: int, npfb: int):
    """Wideband Kaiser INTERPOLATING-filter banks for signals that are
    already Nyquist-shaped (reference symsync.c:252-289 _create_kaiser:
    cut-off fc=0.75 nominal sits outside the signal band, As=40 dB, so
    the bank acts as a fractional-delay interpolator, not a matched
    filter)."""
    from ..design.firdes import firdes_kaiser
    n = 2 * npfb * k * m + 1
    fc = 0.75
    H = firdes_kaiser(n, fc / (k * npfb), 40.0).astype(np.float64)
    # normalize to the prototype-bank convention symsync_run expects
    # (branch DC gain ~= k after the /k in the output path)
    H *= (k * npfb) / H.sum()
    return _derivative_bank(H, npfb)


def _lf_consts(bw: float):
    """Loop-filter coefficients (reference symsync.c set_lf_bw:380-407)."""
    alpha = 1.0 - bw
    beta = 0.22 * bw
    a_, b_ = 0.5, 0.495
    return {"B0": beta, "A0": 1.0 - a_ * alpha, "A1": -b_ * alpha,
            "rate_adj": 0.5 * bw}


def _timing_update(st, q_raw, active, k_out: int, locked: bool, C,
                   npfb: int):
    """One emit's timing-loop state update (shared by the scan-body and
    hoisted formulations — identical arithmetic, so both produce the
    same loop dynamics)."""
    run_loop = (st["decim"] == k_out) & active & (not locked)
    q = jnp.clip(q_raw, -1.0, 1.0)
    q_hat = (C["B0"] / C["A0"]) * q + st["v0"]
    v0 = -(C["A1"] / C["A0"]) * q_hat
    rate = st["rate"] + C["rate_adj"] * q_hat
    dl = rate + q_hat
    new = {
        "tau": st["tau"] + jnp.where(active, st["del"], 0.0),
        "rate": jnp.where(run_loop, rate, st["rate"]),
        "del": jnp.where(run_loop, dl, st["del"]),
        "v0": jnp.where(run_loop, v0, st["v0"]),
        "v1": jnp.where(run_loop, jnp.zeros_like(v0), st["v1"]),
        "decim": jnp.where(
            active, jnp.where(st["decim"] == k_out, 1,
                              st["decim"] + 1), st["decim"]),
    }
    new["bf"] = new["tau"] * npfb
    new["b"] = jnp.round(new["bf"]).astype(jnp.int32)
    return {**st, **new}


_STATE_KEYS = ("tau", "bf", "b", "rate", "del", "v0", "v1", "decim")


def _symsync_run_hoisted(mf_bank, dmf_bank, carry, x, k: int,
                         k_out: int = 1, bw: float = 0.01,
                         locked: bool = False,
                         post=None, post_carry=None):
    """Hoisted-MF formulation: ALL branch matched-filter outputs are
    computed OUTSIDE the scan as one multi-channel FIR of the input
    (HIGHEST-precision conv), so the scan body shrinks to the timing
    loop plus four one-hot selections of precomputed scalars.  The
    per-step window maintenance and the in-body tap-selection matmul —
    the dominant body cost — disappear; the
    branch outputs themselves are loop-INdependent (the loop only picks
    WHICH branch to read), which is what makes the hoist exact.

    Value-equivalent to the scan-body formulation (same _timing_update
    arithmetic; MF dots reassociated by the conv, goldens at 1e-5).
    Memory: branch outputs are [.., Tc, 2*npfb] per chunk; the block is
    processed in Tc-sample chunks under an outer scan."""
    npfb, Lb = mf_bank.shape
    C = _lf_consts(bw)
    max_out = int(np.ceil(k / k_out)) + 1
    T = int(x.shape[-1])
    Tc = _hoist_chunk(T)
    nch = T // Tc
    batch = x.shape[:-1]
    cplx = jnp.iscomplexobj(x)
    iota = jnp.arange(npfb, dtype=jnp.int32)
    # correlation kernels: out[t] = sum_j xp[t+j] * bank[b, ::-1][j]
    # (XLA conv is cross-correlation; rows 0..npfb-1 MF, rest dMF)
    kern = jnp.asarray(np.concatenate(
        [mf_bank[:, ::-1], dmf_bank[:, ::-1]], axis=0)[:, None, :])

    def branch_outputs(xp_planes):
        # [P*batch..., Tc + Lb - 1] planes -> [P..., Tc, 2*npfb]
        flat = xp_planes.reshape((-1, 1, xp_planes.shape[-1]))
        y = lax.conv_general_dilated(
            flat, kern, (1,), "VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=lax.Precision.HIGHEST)          # [N, 2npfb, Tc]
        y = jnp.moveaxis(y, -2, -1)
        return y.reshape(xp_planes.shape[:-1] + (Tc, 2 * npfb))

    def emit(st, ma):
        # ma: [.., 4*npfb] (mf_re | dmf_re | mf_im | dmf_im) or
        #     [.., 2*npfb] (mf | dmf) for real input
        active = st["b"] < npfb
        bc = jnp.clip(st["b"], 0, npfb - 1)
        oh = (bc[..., None] == iota).astype(jnp.float32)
        # ONE one-hot reduce selects every plane's mf AND dmf at once
        sel = jnp.einsum("...b,...gb->...g",
                         oh, ma.reshape(ma.shape[:-1] + (-1, npfb)))
        mf_re, dmf_re = sel[..., 0], sel[..., 1]
        if cplx:
            mf_im, dmf_im = sel[..., 2], sel[..., 3]
            mf = lax.complex(mf_re, mf_im)
            q_raw = mf_re * dmf_re + mf_im * dmf_im
        else:
            mf = mf_re
            q_raw = mf_re * dmf_re
        st2 = _timing_update(st, q_raw, active, k_out, locked, C, npfb)
        return st2, (jnp.where(active, mf / k, 0.0), active)

    def inner_step(c, ma):
        st, pc = c
        outs, valid, extras = [], [], []
        for _ in range(max_out):
            st, (oi, vi) = emit(st, ma)
            outs.append(oi)
            valid.append(vi)
            if post is not None:
                # fuse the downstream per-symbol stage (symtrack's
                # PLL+LMS) into the SAME scan: one pass over the block
                # instead of a second max_out*T-slot scan
                pc, ex = post(pc, oi, vi)
                extras.append(ex)
        st = dict(st, tau=st["tau"] - 1.0, bf=st["bf"] - npfb,
                  b=st["b"] - npfb)
        ex_st = (tuple(jnp.stack([e[j] for e in extras], axis=-1)
                       for j in range(len(extras[0])))
                 if post is not None else ())
        return (st, pc), (jnp.stack(outs, axis=-1),
                          jnp.stack(valid, axis=-1), ex_st)

    def _flatten_t(a):
        # [Tc, .., max_out] -> [.., Tc*max_out]
        return jnp.moveaxis(a, 0, -2).reshape(
            a.shape[1:-1] + (a.shape[0] * max_out,))

    def outer_step(c, xc):
        st, pc, prefix = c
        xp = jnp.concatenate([prefix, xc], axis=-1)
        if cplx:
            planes = jnp.stack([jnp.real(xp), jnp.imag(xp)], axis=0)
            ma = branch_outputs(planes)          # [2, .., Tc, 2npfb]
            ma = jnp.concatenate([ma[0], ma[1]], axis=-1)
        else:
            ma = branch_outputs(xp)
        mt = jnp.moveaxis(ma, -2, 0)             # [Tc, .., G*npfb]
        (st, pc), (ys, vs, ex) = lax.scan(inner_step, (st, pc), mt,
                                          unroll=scan_unroll(16))
        ys = _flatten_t(ys)
        vs = _flatten_t(vs)
        ex = tuple(_flatten_t(e) for e in ex)
        return ((st, pc, xp[..., xp.shape[-1] - (Lb - 1):]),
                (ys, vs, ex))

    st0 = {kk: carry[kk] for kk in _STATE_KEYS}
    prefix0 = carry["win"][..., 1:].astype(x.dtype)
    xcs = jnp.moveaxis(x.reshape(batch + (nch, Tc)), -2, 0)
    ((st, pc, _), (ys, vs, ex)) = lax.scan(
        outer_step, (st0, post_carry, prefix0), xcs)

    def _flatten_c(a):
        # [nch, .., Tc*max_out] -> [.., T*max_out]
        return jnp.moveaxis(a, 0, -2).reshape(
            a.shape[1:-1] + (T * max_out,))

    ys = _flatten_c(ys)
    vs = _flatten_c(vs)
    win = jnp.concatenate([prefix0, x], axis=-1)[..., -Lb:] \
        if T >= 1 else carry["win"]
    new_carry = {**st, "win": win}
    if post is not None:
        return ys, vs, new_carry, tuple(_flatten_c(e) for e in ex), pc
    return ys, vs, new_carry


def _hoist_chunk(T: int) -> int:
    """Largest divisor of T in [256, 4096] for the hoisted path's
    branch-output chunking (bounds the [.., Tc, 2*npfb] live buffer)."""
    best = T
    for cand in range(min(T, 4096), 255, -1):
        if T % cand == 0:
            return cand
    return best


def symsync_run(mf_bank, dmf_bank, carry, x, k: int, k_out: int = 1,
                bw: float = 0.01, locked: bool = False, hoist=None):
    """Run the synchronizer over a block; returns (y, valid, carry').

    hoist=None takes the platform policy's "symsync_hoist" entry
    (platform.py): the hoisted-MF formulation (_symsync_run_hoisted) or
    the original scan body (golden bit-compat on the CPU).
    Blocks with no chunk divisor <= 4096 (large primes) stay on the
    scan path — a single-chunk hoist would materialize the whole
    [.., T, 2*npfb] branch-output buffer."""
    if hoist is None:
        hoist = (policy("symsync_hoist")
                 and _hoist_chunk(int(x.shape[-1])) <= 4096)
    if hoist and x.shape[-1] >= 2:
        return _symsync_run_hoisted(mf_bank, dmf_bank, carry, x, k,
                                    k_out, bw, locked)
    npfb, Lb = mf_bank.shape
    C = _lf_consts(bw)
    max_out = int(np.ceil(k / k_out)) + 1

    # ONE stacked bank [npfb, 2*Lb]: a single branch selection yields
    # BOTH the MF and dMF taps (halves the one-hot matmul work in the
    # scan body — the body cost IS the symsync throughput)
    both_j = jnp.asarray(np.concatenate(
        [mf_bank[:, ::-1], dmf_bank[:, ::-1]], axis=1))
    iota = jnp.arange(npfb, dtype=jnp.int32)
    onehot = policy("symsync_onehot_select")

    def bank_sel(bank, bc):
        """Branch-b taps: a one-hot matmul where the platform policy
        says so ("symsync_onehot_select", platform.py — traced-index
        gathers serialized on the accelerator this was first tuned on;
        not measured on H100), else the gather.  HIGHEST precision keeps the
        selection exact (the goldens are sample-exact)."""
        if onehot:
            oh = (bc[..., None] == iota).astype(bank.dtype)
            return jnp.einsum("...b,bj->...j", oh, bank,
                              precision=lax.Precision.HIGHEST)
        return jnp.take(bank, bc, axis=0)

    def step(c, xt):
        win = jnp.concatenate([c["win"][..., 1:], xt[..., None]], axis=-1)
        outs = jnp.zeros(xt.shape + (max_out,), win.dtype)
        valid = jnp.zeros(xt.shape + (max_out,), jnp.bool_)
        state = dict(c, win=win)
        cplx = jnp.iscomplexobj(win)
        # real-plane window dots: taps are REAL, so mf/dmf split into
        # two real dots per plane instead of complex-promoted einsums
        # (the same all-real-body trick as agc_scan)
        wr = jnp.real(win) if cplx else win
        wi = jnp.imag(win) if cplx else None

        def emit(i, st):
            active = st["b"] < npfb

            bc = jnp.clip(st["b"], 0, npfb - 1)
            taps = bank_sel(both_j, bc)
            tmf, tdmf = taps[..., :Lb], taps[..., Lb:]
            mf_re = jnp.einsum("...j,...j->...", wr, tmf)
            dmf_re = jnp.einsum("...j,...j->...", wr, tdmf)
            if cplx:
                mf_im = jnp.einsum("...j,...j->...", wi, tmf)
                dmf_im = jnp.einsum("...j,...j->...", wi, tdmf)
                mf = lax.complex(mf_re, mf_im)
                q_raw = mf_re * dmf_re + mf_im * dmf_im
            else:
                mf = mf_re
                q_raw = mf_re * dmf_re
            # one-pole loop filter == iirfiltsos with B=[B0,0,0],
            # A=[A0,A1,0] normalized by A0 (DF2T), inside _timing_update
            st2 = _timing_update(st, q_raw, active, k_out, locked, C,
                                 npfb)
            out_i = jnp.where(active, mf / k, 0.0)
            return st2, (out_i, active)

        for i in range(max_out):
            state, (oi, vi) = emit(i, state)
            outs = outs.at[..., i].set(oi)
            valid = valid.at[..., i].set(vi)

        state["tau"] = state["tau"] - 1.0
        state["bf"] = state["bf"] - npfb
        state["b"] = state["b"] - npfb
        return state, (outs, valid)

    xt = jnp.moveaxis(x, -1, 0)
    carry, (ys, vs) = lax.scan(step, carry, xt, unroll=scan_unroll(8))
    # [T, ..., max_out] -> [..., T*max_out]
    ys = jnp.moveaxis(ys, 0, -2).reshape(x.shape[:-1] + (-1,))
    vs = jnp.moveaxis(vs, 0, -2).reshape(x.shape[:-1] + (-1,))
    return ys, vs, carry


def symsync(ftype: str = "arkaiser", k: int = 2, m: int = 5,
            beta: float = 0.3, npfb: int = 32, k_out: int = 1,
            bw: float = 0.01, name: str = "symsync") -> Proc:
    """Streaming symbol synchronizer Proc.

    apply returns ((y_padded, valid_mask), carry): downstream consumers
    compact with the mask (variable-rate output).
    """
    mf, dmf = symsync_banks(ftype, k, m, beta, npfb)
    Lb = mf.shape[1]

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"win": jnp.zeros(batch_shape + (Lb,), dtype),
                "tau": jnp.zeros(batch_shape, jnp.float32),
                "bf": jnp.zeros(batch_shape, jnp.float32),
                "b": jnp.zeros(batch_shape, jnp.int32),
                "rate": jnp.full(batch_shape, float(k) / k_out, jnp.float32),
                "del": jnp.full(batch_shape, float(k) / k_out, jnp.float32),
                "v0": jnp.zeros(batch_shape, jnp.float32),
                "v1": jnp.zeros(batch_shape, jnp.float32),
                "decim": jnp.full(batch_shape, k_out, jnp.int32)}

    def apply(params, carry, x):
        y, v, c = symsync_run(mf, dmf, carry, x, k, k_out, bw)
        return (y, v), c

    return Proc(params={"mf": jnp.asarray(mf), "dmf": jnp.asarray(dmf)},
                init=init, apply=apply, rate=(k_out, k), name=name)


def symsync_kaiser(k: int = 2, m: int = 5, npfb: int = 32, k_out: int = 1,
                   bw: float = 0.01, name: str = "symsync_kaiser") -> Proc:
    """Symbol synchronizer with a wideband Kaiser interpolating bank for
    already-Nyquist-shaped input (reference symsync_crcf_create_kaiser,
    symsync.c:252-289).  Same streaming contract as symsync()."""
    mf, dmf = symsync_kaiser_banks(k, m, npfb)
    Lb = mf.shape[1]

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"win": jnp.zeros(batch_shape + (Lb,), dtype),
                "tau": jnp.zeros(batch_shape, jnp.float32),
                "bf": jnp.zeros(batch_shape, jnp.float32),
                "b": jnp.zeros(batch_shape, jnp.int32),
                "rate": jnp.full(batch_shape, float(k) / k_out, jnp.float32),
                "del": jnp.full(batch_shape, float(k) / k_out, jnp.float32),
                "v0": jnp.zeros(batch_shape, jnp.float32),
                "v1": jnp.zeros(batch_shape, jnp.float32),
                "decim": jnp.full(batch_shape, k_out, jnp.int32)}

    def apply(params, carry, x):
        y, v, c = symsync_run(mf, dmf, carry, x, k, k_out, bw)
        return (y, v), c

    return Proc(params={"mf": jnp.asarray(mf), "dmf": jnp.asarray(dmf)},
                init=init, apply=apply, rate=(k_out, k), name=name)
