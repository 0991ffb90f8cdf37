"""Linear block codes: repetition, Hamming family, SEC-DED, Golay.

Reference analogs (studied, not copied): reference src/fec/src/
fec_rep3.c / fec_rep5.c, fec_hamming{74,84,128,1511,3126}.c,
fec_secded{2216,3932,7264}.c, fec_golay2412.c.

The generator matrices below are DATA: each k-entry list is the image of
the unit input bits under the reference encoder (bit k-1 first), read out
from the reference implementation — the same role as extracted golden
vectors.  Encoding is a bit-level matmul mod 2; decoding is syndrome
computation (another bit matmul) followed by a table gather: the
syndrome table enumerates all correctable error patterns (1-bit for
Hamming/SEC-DED, up to 3-bit for Golay — a perfect code, so its 2^12
syndromes exactly cover weight<=3 errors).

DESIGN CHOICE: this whole byte path runs in HOST numpy, deliberately.
FEC operates on short byte packets after the receiver has gathered and
demodulated a frame; at those sizes device dispatch dominates any matmul
win, and keeping it host-side lets receivers decode headers eagerly
(flexframe's payload geometry depends on decoded header bytes).  The
matmul formulation means a device port is mechanical if a future
pipeline wants it fused.

Byte-stream framing matches the reference: the message is unpacked into
a MSB-first bit stream, chopped into k-bit symbols (zero-padded at the
end), each encoded to n bits, and the bit stream re-packed into bytes
(reference fec_block_get_enc_msg_len: nsym = ceil(8*len/k),
enc_bytes = ceil(nsym*n/8)).  SEC-DED codes are byte-oriented: p parity
bits are prepended as a byte per block (reference fec_secded2216.c).
"""
from __future__ import annotations

from functools import lru_cache
from itertools import combinations

import numpy as np

__all__ = [
    "_block_decode_soft", "_rep_decode_soft",
    "FEC_SCHEMES", "fec_get_enc_msg_length", "fec_encode", "fec_decode",
    "fec_get_rate", "unpack_bits", "pack_bits",
]


# --- generator-matrix data (unit-bit images of the reference encoders;
#     reference fec_hamming74.c:34 enc table, fec_hamming128_gentab.c,
#     fec_hamming1511.c / fec_hamming3126.c encode_symbol,
#     fec_golay2412.c:54 Gt) ---
_GCOLS = {
    "hamming74": (7, 4, [112, 76, 42, 105]),
    "hamming84": (8, 4, [225, 153, 85, 210]),
    "hamming128": (12, 8, [3584, 2432, 1344, 3360, 2072, 1044, 3090, 273]),
    "hamming1511": (15, 11, [28672, 19456, 10752, 26880, 16576, 8352, 24720,
                             2184, 18564, 10370, 26753]),
    "hamming3126": (31, 26, [
        1879048192, 1275068416, 704643072, 1761607680, 1086324736, 547356672,
        1620049920, 143130624, 1216610304, 679608320, 1753284608, 1073790976,
        536911872, 1610649600, 134252544, 1207993344, 671121920, 1744863488,
        8421504, 1082163264, 545292320, 1619034128, 142639112, 1216380932,
        679510018, 1753251841]),
    "golay2412": (24, 12, [9361408, 1946624, 3887616, 7770368, 15536256,
                           14299200, 11825184, 6877200, 13750280, 10727428,
                           4681730, 16769025]),
}

# SEC-DED parity columns: the parity byte produced by each unit data bit,
# probed from the reference fec_secded*_compute_parity and re-ordered to
# np.unpackbits order (byte 0 first, MSB first within each byte).
def _reorder_probe(probe, nbytes, group_rev):
    cols = []
    for k in range(nbytes):
        g = (nbytes - 1 - k) if group_rev else k
        for b in range(8):
            cols.append(probe[g * 8 + (7 - b)])
    return cols


_SECDED = {
    # (n_parity_bits, n_data_bits, parity column per unpacked data bit)
    "secded2216": (6, 16, _reorder_probe(
        [38, 26, 25, 56, 50, 28, 13, 44, 7, 19, 35, 49, 37, 41, 14, 22],
        2, False)),
    "secded3932": (7, 32, _reorder_probe(
        [97, 81, 25, 69, 67, 49, 41, 19, 98, 82, 74, 70, 50, 42, 35, 26,
         44, 100, 38, 37, 52, 22, 21, 84, 11, 88, 28, 76, 56, 14, 13, 73],
        4, True)),
    "secded7264": (8, 64, _reorder_probe(
        [11, 59, 55, 7, 25, 41, 73, 137, 22, 38, 70, 134, 19, 35, 67, 131,
         28, 44, 76, 140, 21, 37, 69, 133, 26, 42, 74, 138, 13, 205, 206, 14,
         112, 115, 179, 176, 81, 82, 84, 88, 161, 162, 164, 168,
         49, 50, 52, 56, 193, 194, 196, 200, 97, 98, 100, 104,
         145, 146, 148, 152, 224, 236, 220, 208],
        8, True)),
}


def unpack_bits(data) -> np.ndarray:
    """Bytes -> MSB-first bit array."""
    return np.unpackbits(np.asarray(data, np.uint8))


def pack_bits(bits) -> np.ndarray:
    """MSB-first bit array -> bytes (zero-padded to a byte boundary)."""
    bits = np.asarray(bits, np.uint8)
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits)


def _int_to_bits(v: int, n: int) -> np.ndarray:
    return np.asarray([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


@lru_cache(maxsize=None)
def _code_matrices(scheme: str):
    """(G [k,n], H [r,n], syndrome_table [2^r] of n-bit error ints)."""
    n, k, cols = _GCOLS[scheme]
    G = np.stack([_int_to_bits(c, n) for c in cols])  # [k, n]
    r = n - k
    # null space of G over GF(2): rref on G, parity part -> H
    H = _gf2_nullspace(G)
    assert H.shape == (r, n)
    assert not ((G @ H.T) % 2).any()
    t = 3 if scheme == "golay2412" else 1
    table = np.zeros(1 << r, np.int64)  # syndrome -> error pattern
    filled = np.zeros(1 << r, bool)
    for wt in range(1, t + 1):
        for pos in combinations(range(n), wt):
            e = np.zeros(n, np.uint8)
            e[list(pos)] = 1
            s = _bits_to_int((H @ e) % 2)
            if not filled[s]:
                table[s] = _bits_to_int(e)
                filled[s] = True
    return G, H, table


def _bits_to_int(bits) -> int:
    v = 0
    for b in np.asarray(bits, np.uint8).tolist():
        v = (v << 1) | int(b)
    return v


def _gf2_nullspace(G: np.ndarray) -> np.ndarray:
    """Basis of the null space of G (rows span the dual code)."""
    k, n = G.shape
    A = G.copy() % 2
    pivots = []
    row = 0
    for col in range(n):
        sel = None
        for rr in range(row, k):
            if A[rr, col]:
                sel = rr
                break
        if sel is None:
            continue
        A[[row, sel]] = A[[sel, row]]
        for rr in range(k):
            if rr != row and A[rr, col]:
                A[rr] ^= A[row]
        pivots.append(col)
        row += 1
        if row == k:
            break
    free = [c for c in range(n) if c not in pivots]
    H = np.zeros((len(free), n), np.uint8)
    for i, fc in enumerate(free):
        H[i, fc] = 1
        for prow, pcol in enumerate(pivots):
            H[i, pcol] = A[prow, fc]
    return H


def _golay_symbols(msg: np.ndarray):
    """12-bit symbols per the reference chunking (fec_golay2412.c encode:
    3-byte groups -> two 12-bit symbols; each remainder byte becomes its
    own zero-extended 12-bit symbol)."""
    n = len(msg)
    r = n % 3
    syms = []
    m = msg.astype(np.int64)
    for i in range(0, n - r, 3):
        s0, s1, s2 = m[i], m[i + 1], m[i + 2]
        syms.append(((s0 << 4) & 0x0FF0) | ((s1 >> 4) & 0x000F))
        syms.append(((s1 << 8) & 0x0F00) | (s2 & 0x00FF))
    for i in range(n - r, n):
        syms.append(int(m[i]) & 0xFF)
    return np.asarray(syms, np.int64)


def _block_encode(scheme: str, msg: np.ndarray) -> np.ndarray:
    n, k, _ = _GCOLS[scheme]
    G, _, _ = _code_matrices(scheme)
    if scheme == "golay2412":
        syms_int = _golay_symbols(msg)
        syms = ((syms_int[:, None] >> np.arange(k - 1, -1, -1)) & 1
                ).astype(np.uint8)
    else:
        bits = unpack_bits(msg)
        nsym = -(-len(bits) // k)
        bits = np.concatenate([bits,
                               np.zeros(nsym * k - len(bits), np.uint8)])
        syms = bits.reshape(-1, k)
    enc = (syms @ G) % 2  # [nsym, n] — batched bit matmul
    return pack_bits(enc.reshape(-1))


def _block_decode(scheme: str, enc: np.ndarray, dec_len: int) -> np.ndarray:
    n, k, _ = _GCOLS[scheme]
    G, H, table = _code_matrices(scheme)
    r = n - k
    bits = unpack_bits(enc)
    if scheme == "golay2412":
        rem = dec_len % 3
        nsym = 2 * (dec_len // 3) + rem
    else:
        nsym = -(-(8 * dec_len) // k)
    bits = bits[: nsym * n].reshape(nsym, n)
    synd = (bits @ H.T) % 2                       # [nsym, r]
    sidx = synd @ (1 << np.arange(r - 1, -1, -1))  # ints
    epat = table[sidx]                            # error patterns
    ebits = ((epat[:, None] >> np.arange(n - 1, -1, -1)) & 1).astype(np.uint8)
    fixed = bits ^ ebits
    # recover message bits: G is full-rank; since the code's data mapping
    # is linear, solve via the pseudo-inverse decode matrix D: u = c @ D
    D = _decode_matrix(scheme)
    u = (fixed @ D) % 2                           # [nsym, k]
    if scheme == "golay2412":
        # repack 12-bit symbols to bytes (reference fec_golay2412.c decode)
        w = 1 << np.arange(k - 1, -1, -1)
        syms = u @ w
        out = np.zeros(dec_len, np.uint8)
        rem = dec_len % 3
        full = dec_len // 3
        for g in range(full):
            m0, m1 = int(syms[2 * g]), int(syms[2 * g + 1])
            out[3 * g + 0] = (m0 >> 4) & 0xFF
            out[3 * g + 1] = ((m0 & 0x0F) << 4) | ((m1 >> 8) & 0x0F)
            out[3 * g + 2] = m1 & 0xFF
        for i in range(rem):
            out[3 * full + i] = int(syms[2 * full + i]) & 0xFF
        return out
    out = pack_bits(u.reshape(-1))[:dec_len]
    return out


@lru_cache(maxsize=None)
def _decode_matrix(scheme: str) -> np.ndarray:
    """D [n,k] with (u G) D = u for all u: right inverse of G."""
    n, k, _ = _GCOLS[scheme]
    G, _, _ = _code_matrices(scheme)
    # solve G X = I_k over GF(2) -> X [n,k]
    A = np.concatenate([G.copy() % 2, np.eye(k, dtype=np.uint8)], axis=1)
    # row-reduce [G | I]
    row = 0
    pivots = []
    for col in range(n):
        sel = None
        for rr in range(row, k):
            if A[rr, col]:
                sel = rr
                break
        if sel is None:
            continue
        A[[row, sel]] = A[[sel, row]]
        for rr in range(k):
            if rr != row and A[rr, col]:
                A[rr] ^= A[row]
        pivots.append(col)
        row += 1
        if row == k:
            break
    X = np.zeros((n, k), np.uint8)
    for prow, pcol in enumerate(pivots):
        X[pcol] = A[prow, n:]
    assert not ((G @ X) % 2 - np.eye(k, dtype=np.uint8)).any()
    return X


# --- SEC-DED (byte-oriented) ---


@lru_cache(maxsize=None)
def _secded_cols(scheme: str):
    p, m, cols = _SECDED[scheme]
    if cols is None or len(cols) != m:
        raise RuntimeError(f"secded columns for {scheme} not initialized")
    cols = np.asarray(cols, np.int64)
    # syndrome -> error position table: data-bit errors flip parity by
    # their column; parity-bit errors give unit syndromes
    table_pos = -np.ones(1 << p, np.int64)  # -1: uncorrectable/none
    for i, c in enumerate(cols.tolist()):
        table_pos[c] = i          # data bit i
    for j in range(p):
        table_pos[1 << j] = m + j  # parity bit (no data correction needed)
    return cols, table_pos


def _secded_encode(scheme: str, msg: np.ndarray) -> np.ndarray:
    """Parity byte prepended per block; a final partial block is padded
    with trailing zero bytes that are NOT transmitted (reference
    fec_secded2216.c encode: remainder path drops the zero bytes)."""
    p, m, _ = _SECDED[scheme]
    nbytes = m // 8
    cols, _ = _secded_cols(scheme)
    msg = np.asarray(msg, np.uint8)
    n = len(msg)
    nblk = -(-n // nbytes)
    buf = np.zeros(nblk * nbytes, np.uint8)
    buf[:n] = msg
    blocks = buf.reshape(nblk, nbytes)
    bits = np.unpackbits(blocks, axis=1)          # [nblk, m] MSB-first
    parity = np.bitwise_xor.reduce(bits * cols[None, :], axis=1)
    out = []
    start = 0
    for b in range(nblk):
        take = min(nbytes, n - start)
        out.append(np.concatenate([[parity[b]],
                                   blocks[b, :take]]).astype(np.uint8))
        start += take
    return np.concatenate(out)


def _secded_decode(scheme: str, enc: np.ndarray, dec_len: int) -> np.ndarray:
    p, m, _ = _SECDED[scheme]
    nbytes = m // 8
    cols, table_pos = _secded_cols(scheme)
    enc = np.asarray(enc, np.uint8)
    nblk = -(-dec_len // nbytes)
    # expand to full blocks, re-inserting the zero pad bytes the encoder
    # dropped from the final partial block
    blocks = np.zeros((nblk, nbytes), np.uint8)
    parity_rx = np.zeros(nblk, np.int64)
    pos_e = 0
    pos_d = 0
    for b in range(nblk):
        take = min(nbytes, dec_len - pos_d)
        parity_rx[b] = enc[pos_e]
        blocks[b, :take] = enc[pos_e + 1: pos_e + 1 + take]
        pos_e += 1 + take
        pos_d += take
    bits = np.unpackbits(blocks, axis=1)
    parity = np.bitwise_xor.reduce(bits * cols[None, :], axis=1)
    synd = parity ^ parity_rx
    pos = table_pos[synd & ((1 << p) - 1)]
    for blk in np.nonzero((pos >= 0) & (pos < m))[0]:
        bits[blk, pos[blk]] ^= 1
    fixed = np.packbits(bits, axis=1)
    return fixed.reshape(-1)[:dec_len]


# --- repetition ---


def _rep_encode(times: int, msg: np.ndarray) -> np.ndarray:
    return np.tile(np.asarray(msg, np.uint8), times)


def _rep_decode(times: int, enc: np.ndarray, dec_len: int) -> np.ndarray:
    enc = np.asarray(enc, np.uint8)[: times * dec_len]
    copies = np.unpackbits(enc.reshape(times, dec_len), axis=1)
    votes = copies.sum(axis=0)
    bits = (votes * 2 > times).astype(np.uint8)
    return np.packbits(bits)[:dec_len]


def _block_decode_soft(scheme: str, llr, dec_len: int) -> np.ndarray:
    """Soft-decision block decode: maximum-correlation codeword over all
    2^k candidates (reference fecsoft_hamming74_decode and friends use
    min soft distance — identical criterion).  One [nsym, n] @ [n, 2^k]
    matmul, evaluated in host numpy (BLAS) — see the module docstring
    for why the byte path stays host-side.

    llr: float per-bit metrics, positive = bit 1.
    """
    n, k, _ = _GCOLS[scheme]
    G, _, _ = _code_matrices(scheme)
    if scheme == "golay2412":
        rem = dec_len % 3
        nsym = 2 * (dec_len // 3) + rem
    else:
        nsym = -(-(8 * dec_len) // k)
    llr = np.asarray(llr, np.float32)
    need = nsym * n
    if len(llr) < need:
        llr = np.concatenate([llr, np.zeros(need - len(llr), np.float32)])
    llr = llr[:need].reshape(nsym, n)
    syms_all = ((np.arange(1 << k)[:, None] >>
                 np.arange(k - 1, -1, -1)) & 1).astype(np.uint8)
    C = (syms_all @ G) % 2                      # [2^k, n] codewords
    bip = (2.0 * C - 1.0).astype(np.float32)
    best = np.argmax(llr @ bip.T, axis=1)       # [nsym]
    u = syms_all[best]                          # [nsym, k]
    if scheme == "golay2412":
        w = 1 << np.arange(k - 1, -1, -1)
        syms = u @ w
        out = np.zeros(dec_len, np.uint8)
        rem = dec_len % 3
        full = dec_len // 3
        for g in range(full):
            m0, m1 = int(syms[2 * g]), int(syms[2 * g + 1])
            out[3 * g + 0] = (m0 >> 4) & 0xFF
            out[3 * g + 1] = ((m0 & 0x0F) << 4) | ((m1 >> 8) & 0x0F)
            out[3 * g + 2] = m1 & 0xFF
        for i in range(rem):
            out[3 * full + i] = int(syms[2 * full + i]) & 0xFF
        return out
    return pack_bits(u.reshape(-1))[:dec_len]


def _rep_decode_soft(times: int, llr, dec_len: int) -> np.ndarray:
    llr = np.asarray(llr, np.float32)[: times * 8 * dec_len]
    votes = llr.reshape(times, 8 * dec_len).sum(axis=0)
    return pack_bits((votes > 0).astype(np.uint8))[:dec_len]


# --- public dispatch (reference fec.c fec_create/encode/decode) ---

FEC_SCHEMES = ("none", "rep3", "rep5") + tuple(_GCOLS) + tuple(_SECDED)


def fec_get_enc_msg_length(scheme: str, dec_len: int) -> int:
    """Encoded byte count (reference fec.c fec_get_enc_msg_length)."""
    scheme = scheme.lower()
    if scheme == "none":
        return dec_len
    if scheme == "rep3":
        return 3 * dec_len
    if scheme == "rep5":
        return 5 * dec_len
    if scheme in _GCOLS:
        n, k, _ = _GCOLS[scheme]
        nsym = -(-(8 * dec_len) // k)
        return -(-(nsym * n) // 8)
    if scheme in _SECDED:
        p, m, _ = _SECDED[scheme]
        nbytes = m // 8
        # one parity byte per block; partial-block zero pad not sent
        return dec_len + (-(-dec_len // nbytes))
    raise ValueError(f"unknown fec scheme {scheme!r}; "
                     f"choose from {sorted(FEC_SCHEMES)}")


def fec_get_rate(scheme: str) -> float:
    return 1.0 if scheme == "none" else 1 / (
        fec_get_enc_msg_length(scheme, 1024) / 1024)


def fec_encode(scheme: str, msg) -> np.ndarray:
    scheme = scheme.lower()
    msg = np.asarray(msg, np.uint8)
    if scheme == "none":
        return msg.copy()
    if scheme == "rep3":
        return _rep_encode(3, msg)
    if scheme == "rep5":
        return _rep_encode(5, msg)
    if scheme in _GCOLS:
        return _block_encode(scheme, msg)
    if scheme in _SECDED:
        return _secded_encode(scheme, msg)
    raise ValueError(f"unknown fec scheme {scheme!r}")


def fec_decode(scheme: str, enc, dec_len: int) -> np.ndarray:
    scheme = scheme.lower()
    enc = np.asarray(enc, np.uint8)
    if scheme == "none":
        return enc[:dec_len].copy()
    if scheme == "rep3":
        return _rep_decode(3, enc, dec_len)
    if scheme == "rep5":
        return _rep_decode(5, enc, dec_len)
    if scheme in _GCOLS:
        return _block_decode(scheme, enc, dec_len)
    if scheme in _SECDED:
        return _secded_decode(scheme, enc, dec_len)
    raise ValueError(f"unknown fec scheme {scheme!r}")
