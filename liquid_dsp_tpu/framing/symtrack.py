"""symtrack: streaming symbol tracker (AGC -> symbol sync -> LMS EQ ->
carrier PLL -> demod).

Reference analog (studied, not copied): symtrack_cccf
(reference src/framing/src/symtrack.c:42-124): agc_crcf -> symsync (2
samples/symbol rnyquist) -> eqlms_cccf -> nco PLL driven by the modem's
demod phase error -> symbol decisions.

Design: AGC and symbol sync are the existing scan-based Procs; the
carrier PLL runs as one scan over recovered symbols; the equalizer
update is decision-directed LMS.  Variable-rate boundaries are compacted
between stages (host-side), matching the burst/streaming use case.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops.agc import agc
from ..ops.symsync import symsync
from ..ops.equalize import eqlms_lowpass_weights, eqlms_run
from ..modem import constellation

__all__ = ["SymtrackResult", "symtrack", "symtrack_stream", "Symtrack"]


class SymtrackResult(NamedTuple):
    symbols: np.ndarray    # recovered (equalized, derotated) symbols
    decisions: np.ndarray  # hard decisions (indices)


def _pll_scan(table, syms, bw: float):
    """Carrier tracking loop over symbols: mix, slice, phase-error
    feedback with a 2nd-order loop (reference symtrack internal PLL)."""
    alpha = bw
    beta = 0.5 * bw * bw
    tab = jnp.asarray(table)

    def step(c, s):
        theta, dtheta = c
        v = s * jnp.exp(-1j * theta)
        d2 = jnp.abs(v - tab) ** 2
        idx = jnp.argmin(d2)
        ref = tab[idx]
        e = jnp.angle(v * jnp.conj(ref))
        dtheta = dtheta + beta * e
        theta = theta + dtheta + alpha * e
        return (theta, dtheta), (v, idx)

    (_, _), (v, idx) = lax.scan(
        step, (jnp.float32(0.0), jnp.float32(0.0)), jnp.asarray(syms))
    return np.asarray(v), np.asarray(idx)


def symtrack(x, ftype: str = "arkaiser", k: int = 2, m: int = 7,
             beta: float = 0.3, ms: str = "qpsk",
             eq_len: int = 13, eq_mu: float = 0.05,
             pll_bw: float = 0.05, bandwidth: float = 0.9) -> SymtrackResult:
    """Track a continuous stream of modulated samples and return the
    recovered symbols (reference symtrack_cccf_execute_block)."""
    x = jnp.asarray(np.asarray(x, np.complex64))
    # 1. AGC
    ag = agc(bandwidth=0.02)
    y, _ = ag(x, batch_shape=())
    # 2. symbol timing recovery
    ss = symsync(ftype, k, m, beta, bw=0.02)
    (sy, sv), _ = ss(y, batch_shape=())
    syms = np.asarray(sy)[np.asarray(sv)]
    if len(syms) == 0:
        return SymtrackResult(np.zeros(0, np.complex64),
                              np.zeros(0, np.int64))
    # 3. carrier tracking PLL
    table = constellation(ms)
    v, _ = _pll_scan(table, syms.astype(np.complex64), pll_bw)
    # 4. decision-directed LMS equalizer
    L = eq_len
    # x2_sum primed at L (unit-power symbols post-AGC) so the normalized
    # step size doesn't blow up while the window fills
    # lowpass-initialized equalizer (reference symtrack.c:122
    # eqlms_create_lowpass(eq_len, 0.45))
    carry = {"w": jnp.asarray(eqlms_lowpass_weights(L), jnp.complex64),
             "buf": jnp.zeros(L, jnp.complex64),
             "x2_sum": jnp.float32(L),
             "n": jnp.int32(L)}  # window treated as already full
    tab = jnp.asarray(table)

    def slicer(yv):
        # nearest constellation point (scalar or batched)
        return tab[jnp.argmin(jnp.abs(yv[..., None] - tab) ** 2, axis=-1)]

    veq, _ = eqlms_run(None, eq_mu, carry, jnp.asarray(v), slicer=slicer)
    veq = np.asarray(veq)
    from ..modem import demodulate
    dec = np.asarray(demodulate(table, jnp.asarray(veq)))
    return SymtrackResult(veq, dec)


# ---------------------------------------------------------------------------
# Streaming symbol tracker: persistent Proc + object wrapper
# ---------------------------------------------------------------------------
#
# The reference symtrack_cccf is a PERSISTENT object: state (AGC gain,
# timing phase, equalizer weights, carrier phase) survives across
# execute() calls indefinitely (reference src/framing/src/symtrack.c:
# 42-124).  The streaming Proc below chains every stage's carry; the
# variable-rate boundary after symsync is handled by GATED updates (the
# fused PLL+LMS scan is a no-op on invalid slots), so the whole tracker
# is one jittable block apply with static shapes — block-by-block
# output is bit-identical to the one-shot symtrack() on the same
# capture.

def symtrack_stream(ftype: str = "arkaiser", k: int = 2, m: int = 7,
                    beta: float = 0.3, ms: str = "qpsk",
                    eq_len: int = 13, eq_mu: float = 0.05,
                    pll_bw: float = 0.05, agc_bw: float = 0.02,
                    sync_bw: float = 0.02,
                    name: str = "symtrack_stream", fused=None):
    """Streaming symbol tracker Proc.

    apply(params, carry, x[..., T]) -> ((syms, decisions, valid), carry')
    where the outputs are at the symsync slot rate with a validity mask
    (compact with the mask).  All stage states persist in the carry.
    fused=None takes the platform policy's "symtrack_fused" entry
    (platform.py): the PLL+LMS stage inside the hoisted symsync scan,
    or a second scan after it; True/False force one (the conformance
    replay compares the two).
    """
    from ..core import Proc, scan_unroll
    ag = agc(bandwidth=agc_bw)
    ss = symsync(ftype, k, m, beta, bw=sync_bw)
    table = np.asarray(constellation(ms)).astype(np.complex64)
    tab_re = table.real.copy()
    tab_im = table.imag.copy()
    alpha = float(pll_bw)
    beta2 = 0.5 * float(pll_bw) ** 2
    L = int(eq_len)
    mu = float(eq_mu)
    w0 = eqlms_lowpass_weights(L).astype(np.complex64)
    w0_re, w0_im = w0.real.copy(), w0.imag.copy()

    def init(batch_shape=(), dtype=jnp.complex64):
        w = lax.complex(jnp.asarray(w0_re), jnp.asarray(w0_im))
        return {"agc": ag.init(batch_shape, dtype),
                "ss": ss.init(batch_shape, dtype),
                "theta": jnp.zeros(batch_shape, jnp.float32),
                "dtheta": jnp.zeros(batch_shape, jnp.float32),
                # x2_sum/n primed at L: window treated as already full
                # (reference symtrack.c:122 eqlms_create_lowpass init)
                "eq_w": jnp.broadcast_to(w, batch_shape + (L,)).astype(dtype),
                "eq_buf": jnp.zeros(batch_shape + (L,), dtype),
                "eq_x2": jnp.full(batch_shape, float(L), jnp.float32),
                "eq_n": jnp.full(batch_shape, L, jnp.int32)}

    from ..ops.symsync import symsync_banks, _symsync_run_hoisted
    mf_b, dmf_b = symsync_banks(ftype, k, m, beta, 32)

    def apply(params, carry, x):
        y, agc_c = ag.apply(ag.params, carry["agc"], x)
        trj = jnp.asarray(tab_re)
        tij = jnp.asarray(tab_im)
        iota = jnp.arange(tab_re.shape[0], dtype=jnp.int32)

        # QPSK specialization: the nearest point is the QUADRANT, so the
        # slicer is sign arithmetic instead of an argmin + one-hot pair
        # (~half the PLL/LMS body ops; decisions identical off the
        # measure-zero axis ties, and BOTH the fused and sequential
        # paths share this function so they stay mutually exact)
        s2v = float(np.abs(tab_re[0]))
        qpsk_like = (tab_re.shape[0] == 4
                     and np.allclose(np.abs(tab_re), s2v)
                     and np.allclose(np.abs(tab_im), s2v))
        if qpsk_like:
            qmap = np.zeros(4, np.int32)       # [2*(re<0)+(im<0)] -> idx
            for a in (0, 1):
                for b in (0, 1):
                    pt = ((-1 if a else 1) * s2v, (-1 if b else 1) * s2v)
                    qmap[2 * a + b] = int(np.argmin(
                        (tab_re - pt[0]) ** 2 + (tab_im - pt[1]) ** 2))
            k00, k01, k10, k11 = (int(qmap[0]), int(qmap[1]),
                                  int(qmap[2]), int(qmap[3]))

        def nearest(v_re, v_im):
            """Nearest constellation point on PLANES, gather-free
            (CLAUDE.md): QPSK takes the sign path; other tables argmin
            |v - t|^2 + one-hot reduce — exact, since each one-hot
            product is value*1 or value*0."""
            if qpsk_like:
                a = (v_re < 0).astype(jnp.int32)
                b = (v_im < 0).astype(jnp.int32)
                idx = (k00 + (k10 - k00) * a + (k01 - k00) * b
                       + (k11 - k10 - k01 + k00) * a * b)
                r_re = jnp.where(v_re < 0, -s2v, s2v).astype(jnp.float32)
                r_im = jnp.where(v_im < 0, -s2v, s2v).astype(jnp.float32)
                return idx, r_re, r_im
            d2 = ((v_re[..., None] - trj) ** 2
                  + (v_im[..., None] - tij) ** 2)
            idx = jnp.argmin(d2, axis=-1)
            oh = (idx[..., None] == iota).astype(jnp.float32)
            return idx, jnp.sum(oh * trj, -1), jnp.sum(oh * tij, -1)

        def post(c, s, vm):
            """Carrier PLL + DD-LMS on one symbol slot, ALL-REAL body
            (the agc/symsync real-plane trick): complex
            arithmetic is decomposed onto (re, im) planes so the scan
            body carries no complex ops."""
            s_re, s_im = jnp.real(s), jnp.imag(s)
            cth = jnp.cos(c["theta"])
            sth = jnp.sin(c["theta"])
            # vmix = s * exp(-j theta)
            v_re = s_re * cth + s_im * sth
            v_im = s_im * cth - s_re * sth
            _, r_re, r_im = nearest(v_re, v_im)
            # e = angle(vmix * conj(ref))
            e = jnp.arctan2(v_im * r_re - v_re * r_im,
                            v_re * r_re + v_im * r_im)
            dtheta_n = c["dtheta"] + beta2 * e
            theta_n = c["theta"] + dtheta_n + alpha * e
            # decision-directed normalized LMS on the mixed symbol
            b_re = jnp.concatenate([c["eb_re"][..., 1:], v_re[..., None]],
                                   axis=-1)
            b_im = jnp.concatenate([c["eb_im"][..., 1:], v_im[..., None]],
                                   axis=-1)
            x2 = v_re * v_re + v_im * v_im
            x2_sum = c["eq_x2"] + x2 - (c["eb_re"][..., 0] ** 2
                                        + c["eb_im"][..., 0] ** 2)
            w_re, w_im = c["ew_re"], c["ew_im"]
            # yeq = sum(conj(w) * buf)
            y_re = jnp.sum(w_re * b_re + w_im * b_im, axis=-1)
            y_im = jnp.sum(w_re * b_im - w_im * b_re, axis=-1)
            dec, d_re, d_im = nearest(y_re, y_im)
            e_re = d_re - y_re
            e_im = d_im - y_im
            n = c["eq_n"] + 1
            gate = (n >= L).astype(jnp.float32)
            g = ((gate * mu) / jnp.maximum(x2_sum, 1e-12))[..., None]
            # w += g * conj(err) * buf
            w_re = w_re + g * (e_re[..., None] * b_re
                               + e_im[..., None] * b_im)
            w_im = w_im + g * (e_re[..., None] * b_im
                               - e_im[..., None] * b_re)
            vme = vm[..., None]
            new = {"theta": jnp.where(vm, theta_n, c["theta"]),
                   "dtheta": jnp.where(vm, dtheta_n, c["dtheta"]),
                   "ew_re": jnp.where(vme, w_re, c["ew_re"]),
                   "ew_im": jnp.where(vme, w_im, c["ew_im"]),
                   "eb_re": jnp.where(vme, b_re, c["eb_re"]),
                   "eb_im": jnp.where(vme, b_im, c["eb_im"]),
                   "eq_x2": jnp.where(vm, x2_sum, c["eq_x2"]),
                   "eq_n": jnp.where(vm, n, c["eq_n"])}
            return new, (y_re, y_im, dec)

        # planar PLL/LMS carry (the Proc carry keeps the complex form)
        pll_c = {"theta": carry["theta"], "dtheta": carry["dtheta"],
                 "ew_re": jnp.real(carry["eq_w"]),
                 "ew_im": jnp.imag(carry["eq_w"]),
                 "eb_re": jnp.real(carry["eq_buf"]),
                 "eb_im": jnp.imag(carry["eq_buf"]),
                 "eq_x2": carry["eq_x2"], "eq_n": carry["eq_n"]}

        def _repack(pc):
            return {"theta": pc["theta"], "dtheta": pc["dtheta"],
                    "eq_w": lax.complex(pc["ew_re"], pc["ew_im"]),
                    "eq_buf": lax.complex(pc["eb_re"], pc["eb_im"]),
                    "eq_x2": pc["eq_x2"], "eq_n": pc["eq_n"]}

        from ..ops.symsync import _hoist_chunk
        from ..platform import policy
        use_fused = policy("symtrack_fused") if fused is None else fused
        if use_fused and _hoist_chunk(
                int(x.shape[-1])) <= 4096:
            # (the chunk guard mirrors symsync_run's: prime-ish block
            # lengths would materialize the whole branch-output buffer)
            # FUSED path: the PLL+LMS stage rides inside
            # the hoisted symsync scan as its post-emit hook — one pass
            # over the block instead of symsync scan + a second
            # max_out*T-slot scan
            _, sv, ss_c, (yr, yi, dt2), pll_c = _symsync_run_hoisted(
                mf_b, dmf_b, carry["ss"], y, k, 1, sync_bw,
                post=post, post_carry=pll_c)
            return ((lax.complex(yr, yi), dt2, sv),
                    {"agc": agc_c, "ss": ss_c, **_repack(pll_c)})
        (sy, sv), ss_c = ss.apply(ss.params, carry["ss"], y)
        st = jnp.moveaxis(sy, -1, 0)
        vt = jnp.moveaxis(sv, -1, 0)

        def step(c, inp):
            s, valid = inp
            return post(c, s, valid)

        pll_c, (yr, yi, dt) = lax.scan(step, pll_c, (st, vt),
                                       unroll=scan_unroll(8))
        out = (lax.complex(jnp.moveaxis(yr, 0, -1),
                           jnp.moveaxis(yi, 0, -1)),
               jnp.moveaxis(dt, 0, -1), sv)
        return out, {"agc": agc_c, "ss": ss_c, **_repack(pll_c)}

    return Proc(params=(), init=init, apply=apply, rate=(1, k), name=name)


class Symtrack:
    """Persistent symbol-tracker object (the reference symtrack_cccf
    create/execute/reset contract).  Feed arbitrary-length sample
    arrays; returns (symbols, decisions) recovered so far this call.
    State survives across calls; reset() re-arms everything."""

    def __init__(self, ftype: str = "arkaiser", k: int = 2, m: int = 7,
                 beta: float = 0.3, ms: str = "qpsk",
                 eq_len: int = 13, eq_mu: float = 0.05,
                 pll_bw: float = 0.05, block_len: int = 4096):
        self._proc = symtrack_stream(ftype, k, m, beta, ms, eq_len, eq_mu,
                                     pll_bw)
        self._k = k
        self.block_len = int(block_len) // k * k
        self._jit = jax.jit(self._proc.apply)
        self.reset()

    def reset(self):
        self._carry = self._proc.init()
        self._pending = np.zeros(0, np.complex64)

    def execute(self, x):
        self._pending = np.concatenate(
            [self._pending, np.asarray(x, np.complex64)])
        syms, decs = [], []
        while len(self._pending) >= self.block_len:
            blk = self._pending[:self.block_len]
            self._pending = self._pending[self.block_len:]
            (sy, dec, sv), self._carry = self._jit(
                (), self._carry, jnp.asarray(blk))
            sv = np.asarray(sv)
            syms.append(np.asarray(sy)[sv])
            decs.append(np.asarray(dec)[sv])
        if syms:
            return (np.concatenate(syms), np.concatenate(decs))
        return (np.zeros(0, np.complex64), np.zeros(0, np.int64))
