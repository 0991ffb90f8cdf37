"""Convolutional codes: v27/v29/v39/v615 encoders with Viterbi decoding,
plus the punctured rate-1/2 variants.

Reference analog (studied, not copied): reference src/fec/src/fec_conv.c
(encode shift-register loop :76-118 — K-1 flush bits; decode delegates
to external libfec Viterbi), puncture matrices fec_conv_pmatrix.c:26-98,
byte lengths fec.c:225-241 (unpunctured: r*n + ceil((K-1)*r/8) bytes;
punctured: nn + ceil(nn/p) bits, nn = 8n+K-1).  The reference cannot run
these without libfec; we implement them natively.

Polynomials are the generators libfec uses, in the left-shift register
convention (sr = (sr << 1) | bit; output = parity(sr & poly)) — the
bit-reversals of the classic right-shift octal sets:
  v27  K=7  r=1/2: 0x6D, 0x4F            (reversed octal 133, 171)
  v29  K=9  r=1/2: 0x1AF, 0x11D          (reversed octal 753, 561)
  v39  K=9  r=1/3: 0x1ED, 0x19B, 0x127   (octal 755, 633, 447)
  v615 K=15 r=1/6: octal 42631, 47245, 56507, 73363, 77267, 64537
                                          (the Cassini/Pathfinder code)
MSB-first packing throughout.

Design: Viterbi is a lax.scan over time of a vectorized
add-compare-select across all 2^(K-1) states (SURVEY.md §7 hard part #3)
with traceback via stored decisions.  Works on hard bits or soft LLRs
(branch metrics = Hamming or negative-correlation).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .block import unpack_bits, pack_bits
from ..core import scan_unroll

__all__ = ["CONV_SCHEMES", "conv_get_enc_msg_length", "conv_encode",
           "conv_decode", "PUNCTURE_MATRICES"]

_POLYS = {
    "v27": (7, (0x6D, 0x4F)),
    "v29": (9, (0x1AF, 0x11D)),
    "v39": (9, (0x1ED, 0x19B, 0x127)),
    "v615": (15, (0o42631, 0o47245, 0o56507, 0o73363, 0o77267, 0o64537)),
}
_PUNCTURABLE = ("v27", "v29")  # reference punctures only the r=1/2 codes

# puncture matrices (reference fec_conv_pmatrix.c:26-98), row-major
# [rate_num rows of output streams x period columns]
PUNCTURE_MATRICES = {
    "p23": [[1, 1], [1, 0]],
    "p34": [[1, 1, 0], [1, 0, 1]],
    "p45": [[1, 1, 1, 1], [1, 0, 0, 0]],
    "p56": [[1, 1, 0, 1, 0], [1, 0, 1, 0, 1]],
    "p67": [[1, 1, 1, 0, 1, 0], [1, 0, 0, 1, 0, 1]],
    "p78": [[1, 1, 1, 1, 0, 1, 0], [1, 0, 0, 0, 1, 0, 1]],
}
_P29 = {  # K=9 variants differ (fec_conv_pmatrix.c:63-98)
    "p23": [[1, 1], [1, 0]],
    "p34": [[1, 1, 1], [1, 0, 0]],
    "p45": [[1, 1, 0, 1], [1, 0, 1, 0]],
    "p56": [[1, 0, 1, 1, 0], [1, 1, 0, 0, 1]],
    "p67": [[1, 1, 0, 1, 1, 0], [1, 0, 1, 0, 0, 1]],
    "p78": [[1, 1, 0, 1, 0, 1, 1], [1, 0, 1, 0, 1, 0, 0]],
}

CONV_SCHEMES = tuple(
    [b for b in _POLYS] +
    [f"{b}{p}" for b in _PUNCTURABLE for p in PUNCTURE_MATRICES])


def _parse(scheme: str):
    scheme = scheme.lower()
    base = next((b for b in ("v615", "v39", "v29", "v27")
                 if scheme.startswith(b)), None)
    if base is None:
        raise ValueError(f"unknown convolutional scheme {scheme!r}")
    K, polys = _POLYS[base]
    pmat = None
    if len(scheme) > len(base):
        tag = scheme[len(base):]
        table = _P29 if base == "v29" else PUNCTURE_MATRICES
        if base not in _PUNCTURABLE or tag not in table:
            raise ValueError(f"unknown puncturing {tag!r}")
        pmat = np.asarray(table[tag], np.uint8)
    return K, polys, pmat


def _parity_bits(v: np.ndarray) -> np.ndarray:
    """Bitwise parity of each element (vectorized popcount & 1)."""
    v = v.astype(np.uint32)
    v ^= v >> 16
    v ^= v >> 8
    v ^= v >> 4
    v ^= v >> 2
    v ^= v >> 1
    return (v & 1).astype(np.uint8)


def conv_get_enc_msg_length(scheme: str, dec_len: int) -> int:
    """Encoded bytes, matching the reference formulas exactly:
    unpunctured ceil(r*(8n+K-1)/8) (reference fec.c:225-228, e.g.
    v27 -> 2n+2, v615 -> 6n+11); punctured nn + ceil(nn/p) bits with
    nn = 8n+K-1 (reference fec_conv_get_enc_msg_len, fec.c:324-331 —
    exact, because every puncture pattern keeps p+1 of 2p bits)."""
    K, polys, pmat = _parse(scheme)
    nn = 8 * dec_len + K - 1
    if pmat is None:
        nbits_out = len(polys) * nn
    else:
        p = pmat.shape[1]
        nbits_out = nn + -(-nn // p)
    return -(-nbits_out // 8)


def conv_encode(scheme: str, msg) -> np.ndarray:
    """Encode a byte array; returns encoded bytes (MSB-first packing)."""
    K, polys, pmat = _parse(scheme)
    r = len(polys)
    bits = unpack_bits(np.asarray(msg, np.uint8))
    # K-1 flush bits, like the reference (fec_conv.c tail loop :107-118)
    bits = np.concatenate([bits, np.zeros(K - 1, np.uint8)])
    n = len(bits)
    # shift register history via sliding window of the last K bits
    padded = np.concatenate([np.zeros(K - 1, np.uint8), bits])
    win = np.lib.stride_tricks.sliding_window_view(padded, K)  # [n, K]
    weights = 1 << np.arange(K - 1, -1, -1)
    sr = (win * weights).sum(axis=1).astype(np.uint32)          # [n]
    outs = [ _parity_bits(sr & p) for p in polys ]              # r x [n]
    enc = np.stack(outs, axis=1)                                # [n, r]
    if pmat is not None:
        period = pmat.shape[1]
        keep = pmat.T  # [period, r] column-major in time
        mask = np.resize(keep, (n, r) if n % period == 0 else
                         ((-(-n // period)) * period, r))[:n]
        enc = enc.reshape(-1)[mask.reshape(-1).astype(bool)]
    else:
        enc = enc.reshape(-1)
    return pack_bits(enc)


@lru_cache(maxsize=None)
def _trellis(K: int, polys):
    """Branch output bits per (state, input): state = previous K-1 bits."""
    ns = 1 << (K - 1)
    s = np.arange(ns, dtype=np.uint32)
    out = np.zeros((ns, 2, len(polys)), np.uint8)
    nxt = np.zeros((ns, 2), np.int32)
    for b in (0, 1):
        sr = (s << 1) | b  # K-bit register
        for r, p in enumerate(polys):
            out[:, b, r] = _parity_bits(sr & p)
        nxt[:, b] = (sr & (ns - 1)).astype(np.int32)
    return out, nxt


def conv_decode(scheme: str, enc, dec_len: int, soft=None) -> np.ndarray:
    """Viterbi decode to dec_len bytes.

    soft: optional float array of LLR-like metrics per encoded bit
    (positive = bit 1); when given, `enc` is ignored for metric purposes.
    Punctured bits are depunctured as erasures (zero metric).
    """
    K, polys, pmat = _parse(scheme)
    r = len(polys)
    nbits_in = 8 * dec_len + K - 1  # payload + flush (matches encode)
    if soft is None:
        ebits = unpack_bits(np.asarray(enc, np.uint8))
        metrics = 2.0 * ebits.astype(np.float32) - 1.0  # ±1, + = bit 1
    else:
        metrics = np.asarray(soft, np.float32)
    # depuncture into [nbits_in, r] with zeros at punctured positions
    branch_obs = np.zeros((nbits_in, r), np.float32)
    if pmat is None:
        need = nbits_in * r
        m = np.zeros(need, np.float32)
        m[: min(need, len(metrics))] = metrics[:need]
        branch_obs = m.reshape(nbits_in, r)
    else:
        period = pmat.shape[1]
        keep = np.resize(pmat.T, ((-(-nbits_in // period)) * period, r)
                         )[:nbits_in].astype(bool)
        flat = np.zeros(nbits_in * r, np.float32)
        sel = keep.reshape(-1)
        k = min(int(sel.sum()), len(metrics))
        idx = np.nonzero(sel)[0][:k]
        flat[idx] = metrics[:k]
        branch_obs = flat.reshape(nbits_in, r)

    out, nxt = _trellis(K, tuple(polys))
    ns = out.shape[0]
    # branch metric: correlation of observed ±1 metrics with expected bits
    exp = 2.0 * out.astype(np.float32) - 1.0  # [ns, 2, r]
    obs = jnp.asarray(branch_obs)             # [T, r]
    exp_j = jnp.asarray(exp)
    nxt_j = jnp.asarray(nxt)

    NEG = -1e9

    def step(pm, ob):
        # pm: [ns] path metrics; ob: [r]
        bm = jnp.einsum("sbr,r->sb", exp_j, ob)      # [ns, 2]
        cand = pm[:, None] + bm                      # [ns, 2]
        # scatter-max into next states
        flat_next = nxt_j.reshape(-1)                # [ns*2]
        flat_cand = cand.reshape(-1)
        new_pm = jnp.full((ns,), NEG, jnp.float32).at[flat_next].max(flat_cand)
        # decision: which (prev_state, bit) won for each next state
        is_winner = flat_cand == new_pm[flat_next]
        # index of winning flat branch per next state (first winner)
        order = jnp.arange(ns * 2)
        win_idx = jnp.full((ns,), ns * 2, jnp.int32).at[flat_next].min(
            jnp.where(is_winner, order, ns * 2).astype(jnp.int32))
        return new_pm, win_idx

    pm0 = jnp.full((ns,), NEG, jnp.float32).at[0].set(0.0)
    # unroll the ACS trellis loop when the state count is small (the
    # scan-step overhead dominates there; v615's 16384 states would
    # only bloat the program)
    pm, decisions = lax.scan(step, pm0, obs,
                             unroll=scan_unroll(8) if ns <= 256 else 1)

    # traceback from state 0 (flushed)
    def back(state, dec_t):
        flat = dec_t[state]
        prev_state = flat // 2
        bit = flat % 2
        return prev_state, bit

    state0 = jnp.asarray(0, jnp.int32)
    _, bits_rev = lax.scan(back, state0, decisions, reverse=True, unroll=scan_unroll(8))
    bits = np.asarray(bits_rev).astype(np.uint8)
    payload = bits[: 8 * dec_len]
    return pack_bits(payload)[:dec_len]
