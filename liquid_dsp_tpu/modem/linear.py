"""Linear modems: all 52 reference modulation schemes, vectorized.

Reference analog (studied, not copied): the reference ``modem`` object
(src/modem/src/modem_common.c:46 struct; enum include/liquid.h:5091-5141)
modulates/demodulates ONE symbol at a time through per-scheme function
pointers (modem_psk.c, modem_qam.c, modem_apsk.c, modem_arb.c, ...).

Design: every scheme reduces to a dense constellation TABLE indexed by
the input symbol (the reference itself does this for most schemes via
``modulate_using_map``/``_init_map``).  Modulation is a gather; hard
demodulation is a vectorized nearest-point search (one [T, M] distance
matmul); soft demodulation is exact max-log LLR over the
table (the reference approximates with a nearest-neighbor LUT,
modem_common.c:392-409).  DPSK keeps a phase-accumulator carry.

Constellation constructions mirror the reference's math:
  * PSK   — exp(j*2*pi*gray^-1(s)/M)                 (modem_psk.c:49-87)
  * DPSK  — differential PSK, carry = running phase  (modem_dpsk.c:48-95)
  * ASK   — (2*gray^-1(s)-M+1)*alpha, alpha=sqrt(3/(M^2-1))
                                                     (modem_ask.c:34-80)
  * QAM   — rectangular I/Q split with gray coding   (modem_qam.c:30-120)
  * APSK  — ring tables (p, r, phi, map)             (modem_apsk.c:55-131;
            data extracted from modem_apsk_const.c by tools/extract_modem_tables.py)
  * BPSK/QPSK/OOK — closed forms (modem_bpsk.c:57, modem_qpsk.c:58, modem_ook.c:54)
  * SQAM32/128 — quarter-table + quadrant reflections (modem_sqam32.c:55-95)
  * V29/ARB*OPT/ARB64VT — extracted point tables, unit-energy normalized
            (modem_arb.c:205-210)
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import jax.numpy as jnp

from ..core import Proc

__all__ = [
    "MODEM_SCHEMES", "constellation", "bits_per_symbol",
    "gray_encode", "gray_decode",
    "modulate", "demodulate", "demodulate_soft", "phase_error",
    "modem_modulator", "modem_demodulator", "dpsk_modulator",
    "dpsk_demodulator",
]

_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        path = pathlib.Path(__file__).parent / "_tables.npz"
        _TABLES = dict(np.load(path))
    return _TABLES


def gray_encode(x):
    """Binary -> Gray (reference modem_utilities.c:244)."""
    x = np.asarray(x)
    return x ^ (x >> 1)


def gray_decode(x):
    """Gray -> binary via prefix-xor (reference modem_utilities.c:250)."""
    out = np.asarray(x).copy()
    s = 1
    while True:
        shifted = out >> s
        if not shifted.any():
            break
        out = out ^ shifted
        s <<= 1
    return out


def _psk_table(m: int) -> np.ndarray:
    M = 1 << m
    s = np.arange(M)
    lin = gray_decode(s)
    return np.exp(2j * np.pi * lin / M).astype(np.complex64)


def _ask_table(m: int) -> np.ndarray:
    M = 1 << m
    alpha = np.sqrt(3.0 / (M * M - 1))  # == reference ASK*_ALPHA table
    lin = gray_decode(np.arange(M))
    return ((2 * lin - M + 1) * alpha).astype(np.complex64)


def _qam_table(m: int) -> np.ndarray:
    M = 1 << m
    if m % 2:
        mi, mq = (m + 1) >> 1, (m - 1) >> 1
    else:
        mi = mq = m >> 1
    Mi, Mq = 1 << mi, 1 << mq
    # unity-energy normalization == reference (R)QAM*_ALPHA constants
    alpha = np.sqrt(3.0 / ((Mi * Mi - 1) + (Mq * Mq - 1)))
    s = np.arange(M)
    si = gray_decode(s >> mq)
    sq = gray_decode(s & (Mq - 1))
    return ((2 * si - Mi + 1) * alpha +
            1j * (2 * sq - Mq + 1) * alpha).astype(np.complex64)


def _apsk_table(m: int) -> np.ndarray:
    M = 1 << m
    t = _tables()
    p = t[f"apsk{M}_p"]
    r = t[f"apsk{M}_r"]
    phi = t[f"apsk{M}_phi"]
    smap = t[f"apsk{M}_map"]
    # point for ring-ordinal index s (reference modem_apsk.c:108-131)
    pts = np.zeros(M, np.complex64)
    edges = np.concatenate([[0], np.cumsum(p)])
    for level in range(len(p)):
        for k in range(p[level]):
            s = edges[level] + k
            pts[s] = r[level] * np.exp(1j * (phi[level] +
                                             2 * np.pi * k / p[level]))
    return pts[smap].astype(np.complex64)


def _sqam_table(quarter: np.ndarray, m: int) -> np.ndarray:
    M = 1 << m
    q_bits = m - 2
    s = np.arange(M)
    quad = (s >> q_bits) & 0x3
    p = quarter[s & ((1 << q_bits) - 1)]
    out = np.where(quad == 0, p,
                   np.where(quad == 1, np.conj(p),
                            np.where(quad == 2, -np.conj(p), -p)))
    return out.astype(np.complex64)


def _arb_table(name: str) -> np.ndarray:
    pts = _tables()[name].astype(np.complex64)
    # I/Q balance (mean removal) then unity-energy scale: during init the
    # scheme is still LIQUID_MODEM_ARB, so the reference applies BOTH to
    # every arbitrary table (modem_arb.c:54,205-210)
    pts = pts - np.mean(pts)
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def _build_schemes():
    schemes = {}
    for m in range(1, 9):
        M = 1 << m
        schemes[f"psk{M}"] = (m, functools.partial(_psk_table, m))
        schemes[f"dpsk{M}"] = (m, functools.partial(_psk_table, m))
        schemes[f"ask{M}"] = (m, functools.partial(_ask_table, m))
        if M >= 4:
            schemes[f"qam{M}"] = (m, functools.partial(_qam_table, m))
            schemes[f"apsk{M}"] = (m, functools.partial(_apsk_table, m))
    schemes["bpsk"] = (1, lambda: np.array([1, -1], np.complex64))
    # bit0 -> real sign, bit1 -> imag sign (reference modem_qpsk.c:58-59)
    # float32 scale keeps the table complex64 under NEP-50 promotion
    schemes["qpsk"] = (2, lambda: np.array(
        [1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j], np.complex64)
        / np.float32(np.sqrt(2)))
    schemes["ook"] = (1, lambda: np.array([np.sqrt(2), 0], np.complex64))
    schemes["sqam32"] = (5, lambda: _sqam_table(
        _tables()["modem_arb_sqam32"], 5))
    schemes["sqam128"] = (7, lambda: _sqam_table(
        _tables()["modem_arb_sqam128"], 7))
    schemes["v29"] = (4, functools.partial(_arb_table, "modem_arb_V29"))
    schemes["arb16opt"] = (4, functools.partial(_arb_table, "modem_arb16opt"))
    schemes["arb32opt"] = (5, functools.partial(_arb_table, "modem_arb32opt"))
    schemes["arb64opt"] = (6, functools.partial(_arb_table, "modem_arb64opt"))
    schemes["arb128opt"] = (7, functools.partial(_arb_table, "modem_arb128opt"))
    schemes["arb256opt"] = (8, functools.partial(_arb_table, "modem_arb256opt"))
    schemes["arb64vt"] = (6, functools.partial(_arb_table, "modem_arb_vt64"))
    return schemes


_SCHEMES = _build_schemes()
MODEM_SCHEMES = tuple(sorted(_SCHEMES))


def bits_per_symbol(scheme: str) -> int:
    return _SCHEMES[scheme.lower()][0]


@functools.lru_cache(maxsize=None)
def constellation(scheme: str) -> np.ndarray:
    """Constellation table [M]: index = input symbol, value = TX point."""
    scheme = scheme.lower()
    if scheme.startswith("arb:"):
        raise ValueError("use modem_modulator(table=...) for custom tables")
    m, build = _SCHEMES[scheme]
    table = build()
    assert len(table) == (1 << m)
    return table


def modulate(table, syms):
    """Map integer symbols [..., T] -> constellation points.

    Where the platform policy says so (platform.py "modulate_onehot")
    this is a one-hot matmul against the table planes, not a gather:
    traced-index gathers serialized on the accelerator this was first
    tuned on (not measured on H100).  The selection is exact (every product is
    value*1 or value*0; HIGHEST so no reduced-precision pass rounds
    table values).  Otherwise the gather (bit-identical)."""
    from ..platform import policy
    table = jnp.asarray(table)
    M = table.shape[0]
    if not policy("modulate_onehot"):
        return jnp.take(table, syms, axis=0)
    from jax import lax as _lax
    if M > 4096:
        # one-hot matmul memory scales with M; above the cap gather the
        # float planes separately
        re = jnp.take(jnp.real(table), syms, axis=0)
        im = jnp.take(jnp.imag(table), syms, axis=0)
        return _lax.complex(re, im)
    onehot = (syms[..., None] == jnp.arange(M)).astype(jnp.float32)
    re = jnp.einsum("...tm,m->...t", onehot, jnp.real(table),
                    precision=_lax.Precision.HIGHEST)
    im = jnp.einsum("...tm,m->...t", onehot, jnp.imag(table),
                    precision=_lax.Precision.HIGHEST)
    return _lax.complex(re, im)


def demodulate(table, y):
    """Nearest-point hard demodulation: [..., T] -> integer symbols.

    One |y - s|^2 distance computation over the full table — exact
    maximum-likelihood slicing for every scheme (the reference uses
    per-scheme decision regions with identical decisions).
    """
    table = jnp.asarray(table)
    # |y - s|^2 = |y|^2 - 2 Re(y conj(s)) + |s|^2; argmin over s drops |y|^2
    metric = (-2.0 * (y[..., None] * jnp.conj(table)).real
              + (jnp.abs(table) ** 2))
    return jnp.argmin(metric, axis=-1)


def phase_error(table, y, syms):
    """Residual phase of y vs its decided constellation point (feeds PLL
    tracking loops, analog of reference demod_phase_error)."""
    s_hat = modulate(table, syms)
    return jnp.angle(y * jnp.conj(s_hat) + 1e-12)


def demodulate_soft(table, y, noise_var: float = 1.0):
    """Exact max-log LLR per bit: [..., T] -> [..., T, m].

    llr[b] = (min_{s: bit b=0} |y-s|^2 - min_{s: bit b=1} |y-s|^2) / N0;
    positive LLR -> bit 1.  (Reference approximates with a nearest-point
    LUT over 2^p candidates, modem_common.c _demodsoft_gentab.)
    """
    table = jnp.asarray(table)
    M = table.shape[0]
    m = int(np.log2(M))
    d2 = jnp.abs(y[..., None] - table) ** 2  # [..., T, M]
    sym = np.arange(M)
    llrs = []
    for b in range(m - 1, -1, -1):  # MSB first
        mask1 = (sym >> b) & 1
        d0 = jnp.min(jnp.where(mask1 == 0, d2, jnp.inf), axis=-1)
        d1 = jnp.min(jnp.where(mask1 == 1, d2, jnp.inf), axis=-1)
        llrs.append((d0 - d1) / noise_var)
    return jnp.stack(llrs, axis=-1)


def soft_to_hard(llrs):
    """Pack per-bit LLRs [..., T, m] back into integer symbols."""
    m = llrs.shape[-1]
    bits = (llrs > 0).astype(jnp.int32)
    weights = jnp.asarray(np.asarray([1 << (m - 1 - i) for i in range(m)], np.int32))
    return jnp.sum(bits * weights, axis=-1)


# ---------------------------------------------------------------------------
# Proc wrappers


def modem_modulator(scheme: str = None, table=None,
                    name: str = "modem_mod") -> Proc:
    """Streaming modulator Proc: int symbols [..., T] -> complex samples."""
    tab = np.asarray(constellation(scheme) if table is None else table,
                     np.complex64)  # numpy: see modem_demodulator note

    def init(batch_shape=(), dtype=jnp.complex64):
        return ()

    def apply(params, carry, s):
        return modulate(params["table"], s), carry

    return Proc(params={"table": tab}, init=init, apply=apply, name=name)


def modem_demodulator(scheme: str = None, table=None, soft: bool = False,
                      noise_var: float = 1.0,
                      name: str = "modem_demod") -> Proc:
    """Streaming hard (or soft) demodulator Proc."""
    # params keep the NUMPY table: jit materializes it as a compiled
    # constant
    tab = np.asarray(constellation(scheme) if table is None else table,
                     np.complex64)

    def init(batch_shape=(), dtype=jnp.complex64):
        return ()

    def apply(params, carry, y):
        if soft:
            return demodulate_soft(params["table"], y, noise_var), carry
        return demodulate(params["table"], y), carry

    return Proc(params={"table": tab}, init=init, apply=apply, name=name)


def dpsk_modulator(m: int, name: str = "dpsk_mod") -> Proc:
    """Differential PSK modulator: phase accumulates per symbol
    (reference modem_dpsk.c:66-80).  Carry: running phase."""
    M = 1 << m
    # numpy: a compiled constant under jit
    lin = gray_decode(np.arange(M)).astype(np.int32)

    def init(batch_shape=(), dtype=jnp.complex64):
        # integer phase accumulator (units of 2*pi/M) — exact, so blocked
        # streaming is bit-identical to one-shot
        return jnp.zeros(batch_shape, jnp.int32)

    def apply(params, carry, s):
        inc = jnp.take(lin, s)
        acc = jnp.mod(carry[..., None] + jnp.cumsum(inc, axis=-1), M)
        y = jnp.exp(2j * np.pi / M * acc).astype(jnp.complex64)
        return y, acc[..., -1]

    return Proc(params={}, init=init, apply=apply, name=name)


def dpsk_demodulator(m: int, name: str = "dpsk_demod") -> Proc:
    """Differential PSK demodulator: phase difference between consecutive
    samples sliced on the PSK grid (reference modem_dpsk.c:82-115).
    Carry: previous sample's phase."""
    M = 1 << m
    genc = gray_encode(np.arange(M)).astype(np.int32)

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape, jnp.float32)

    def apply(params, carry, y):
        theta = jnp.angle(y)
        prev = jnp.concatenate([carry[..., None], theta[..., :-1]], axis=-1)
        d = theta - prev
        lin = jnp.mod(jnp.round(d * M / (2 * np.pi)), M).astype(jnp.int32)
        s = jnp.take(genc, lin)
        return s, theta[..., -1]

    return Proc(params={}, init=init, apply=apply, name=name)
