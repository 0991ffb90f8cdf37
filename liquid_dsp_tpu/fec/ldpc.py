"""LDPC belief-propagation (sum-product) decoding.

Reference analog (studied, not copied): reference src/fec/src/
sumproduct.c — internal iterative sum-product message passing over a
sparse parity-check matrix (used experimentally by the reference; not
exposed as a fec scheme).

Implementation: log-domain min-sum/sum-product over a dense or sparse
H, vectorized with numpy; returns hard decisions and a parity-satisfied
flag.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ldpc_sumproduct_decode", "ldpc_encode_systematic",
           "make_regular_ldpc", "ldpc_decoder_device"]


def make_regular_ldpc(n: int, k: int, col_weight: int = 3,
                      seed: int = 0) -> np.ndarray:
    """Random regular-ish parity-check matrix H [(n-k), n] (for tests and
    experimentation; the reference also generates its H internally)."""
    m = n - k
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        rows = rng.choice(m, size=min(col_weight, m), replace=False)
        H[rows, j] = 1
    # ensure no empty rows
    for i in range(m):
        if H[i].sum() == 0:
            H[i, rng.integers(0, n)] = 1
    return H


def ldpc_encode_systematic(H: np.ndarray, msg_bits: np.ndarray):
    """Systematic encode via Gaussian elimination: returns (codeword,
    column permutation) with codeword[perm] ordered as [parity | msg]."""
    H = np.asarray(H, np.uint8) % 2
    m, n = H.shape
    k = n - m
    A = H.copy()
    perm = np.arange(n)
    row = 0
    for col in range(n):
        if row >= m:
            break
        sel = None
        for r in range(row, m):
            if A[r, col]:
                sel = r
                break
        if sel is None:
            continue
        A[[row, sel]] = A[[sel, row]]
        for r in range(m):
            if r != row and A[r, col]:
                A[r] ^= A[row]
        # move pivot column into position `row`
        if col != row:
            A[:, [row, col]] = A[:, [col, row]]
            perm[[row, col]] = perm[[col, row]]
        row += 1
    if row < m:
        raise ValueError("parity-check matrix is rank deficient")
    # A = [I_m | P]; parity = P @ msg
    P = A[:, m:]
    msg_bits = np.asarray(msg_bits, np.uint8) % 2
    if len(msg_bits) != k:
        raise ValueError(f"expected {k} message bits")
    parity = (P @ msg_bits) % 2
    cw_perm = np.concatenate([parity, msg_bits]).astype(np.uint8)
    # un-permute into the original column order
    cw = np.zeros(n, np.uint8)
    cw[perm] = cw_perm
    return cw, perm


def ldpc_sumproduct_decode(H: np.ndarray, llr: np.ndarray,
                           max_iters: int = 50, min_sum: bool = False):
    """Decode soft inputs; llr[i] > 0 means bit i likely 0 (standard
    convention).  Returns (hard_bits, parity_ok, iterations)."""
    H = np.asarray(H, np.uint8)
    m, n = H.shape
    llr = np.asarray(llr, np.float64)
    rows, cols = np.nonzero(H)
    # messages on edges
    Lq = llr[cols].copy()          # variable -> check
    Lr = np.zeros_like(Lq)         # check -> variable
    for it in range(1, max_iters + 1):
        # check update: per row, combine incoming Lq
        for r in range(m):
            e = rows == r
            v = Lq[e]
            if min_sum:
                sgn = np.sign(v)
                sprod = np.prod(sgn) * sgn
                mags = np.abs(v)
                # min excluding self
                order = np.argsort(mags)
                m1 = mags[order[0]]
                m2 = mags[order[1]] if len(mags) > 1 else m1
                mins = np.where(np.arange(len(v)) == order[0], m2, m1)
                Lr[e] = sprod * mins
            else:
                t = np.tanh(np.clip(v / 2, -19, 19))
                prod = np.prod(t)
                with np.errstate(divide="ignore"):
                    ratio = prod / np.where(t == 0, 1e-30, t)
                Lr[e] = 2 * np.arctanh(np.clip(ratio, -1 + 1e-12,
                                               1 - 1e-12))
        # variable update
        post = llr.copy()
        np.add.at(post, cols, Lr)
        Lq = post[cols] - Lr
        hard = (post < 0).astype(np.uint8)
        if not ((H @ hard) % 2).any():
            return hard, True, it
    return hard, False, max_iters


def ldpc_decoder_device(H, max_iters: int = 50, min_sum: bool = False):
    """Build a jittable BATCHED belief-propagation decoder for H —
    the batched device form of ldpc_sumproduct_decode (reference
    src/fec/src/sumproduct.c runs one codeword at a time on the CPU).

    Returns decode_fn(llr [..., n] float, llr > 0 = bit 0) ->
    (hard [..., n] int32, parity_ok [...] bool) after max_iters fixed
    iterations (lax.scan — fixed trip count keeps the trace static).

    Device design: messages live in DENSE padded slot arrays — check-side
    [.., m, wr_max] and variable-side [.., n, wc_max] — connected by
    STATIC flat index maps (one gather each way per iteration; static
    index arrays are the cheap gather form, CLAUDE.md).  Padding
    slots carry neutral elements (tanh=1 / +inf magnitude), so
    irregular codes cost the max row/column weight.  The final parity
    check is one H @ hard matmul reduced mod 2 at HIGHEST precision
    (exact small-integer sums).
    """
    import jax.numpy as jnp
    from jax import lax

    H = np.asarray(H, np.uint8)
    m, n = H.shape
    rows, cols = np.nonzero(H)             # edge list, row-major
    E = len(rows)
    wr = int(np.bincount(rows, minlength=m).max())
    wc = int(np.bincount(cols, minlength=n).max())

    # slot assignment: edge e is check slot (rows[e], cslot[e]) and
    # variable slot (cols[e], vslot[e])
    cslot = np.zeros(E, np.int64)
    vslot = np.zeros(E, np.int64)
    rc = np.zeros(m, np.int64)
    vc = np.zeros(n, np.int64)
    for e in range(E):
        cslot[e] = rc[rows[e]]; rc[rows[e]] += 1
        vslot[e] = vc[cols[e]]; vc[cols[e]] += 1

    # flat gather maps (last flat index = the neutral padding slot)
    c2v = np.full(m * wr, n * wc, np.int32)     # check slot <- var slot
    v2c = np.full(n * wc, m * wr, np.int32)     # var slot <- check slot
    c2v[rows * wr + cslot] = (cols * wc + vslot).astype(np.int32)
    v2c[cols * wc + vslot] = (rows * wr + cslot).astype(np.int32)
    # variable index of each check slot (for Q init from llr); n = pad
    cvar = np.full(m * wr, n, np.int32)
    cvar[rows * wr + cslot] = cols.astype(np.int32)
    Hf = H.astype(np.float32)

    def decode_fn(llr):
        llr = jnp.asarray(llr)
        batch = llr.shape[:-1]
        llr_pad = jnp.pad(llr, [(0, 0)] * len(batch) + [(0, 1)])

        def excl_sign(neg):
            # exclude-self sign product from the parity of negative
            # counts (adds only) instead of a multiply-reduce
            tot = jnp.sum(neg, axis=-1, keepdims=True)
            par = jnp.mod(tot - neg, 2.0)
            return 1.0 - 2.0 * par

        def check_update(Q):
            # Q [.., m, wr] incoming; neutral pad slots already set
            if min_sum:
                neg = jnp.where(Q < 0, 1.0, 0.0)
                mag = jnp.abs(Q)
                m1 = jnp.min(mag, axis=-1, keepdims=True)
                # second minimum: min over slots with the argmin masked
                is_min = mag == m1
                first = jnp.cumsum(is_min, axis=-1) == 1
                only_first = is_min & first
                m2 = jnp.min(jnp.where(only_first, jnp.inf, mag),
                             axis=-1, keepdims=True)
                # cap: a weight-1 check's exclude-self min is an empty
                # product (m2 = inf from the pad slots) — the check
                # forces its single bit to 0; send a large FINITE
                # certainty instead of inf (inf - inf = NaN downstream)
                return excl_sign(neg) * jnp.minimum(
                    jnp.where(only_first, m2, m1), 1e6)
            # SAT is the largest float32 strictly below 1: the host
            # path's 1 - 1e-12 rounds to 1.0 in f32 and arctanh(1.0)
            # is inf — saturated BP bounds messages at 2*atanh(SAT)
            # ~ 17.3 instead (standard f32 BP practice).  The tanh
            # product is computed in the LOG domain (sum of log|t| +
            # sign parity): reduce-ADD instead of the reduce-multiply
            # that crashes this toolchain (see excl_sign).
            SAT = 1.0 - 1e-7
            t = jnp.clip(jnp.tanh(Q / 2), -SAT, SAT)
            neg = jnp.where(t < 0, 1.0, 0.0)
            lt = jnp.log(jnp.clip(jnp.abs(t), 1e-30, None))
            lsum = jnp.sum(lt, axis=-1, keepdims=True)
            mag = jnp.exp(lsum - lt)
            ratio = excl_sign(neg) * mag
            return 2 * jnp.arctanh(jnp.clip(ratio, -SAT, SAT))

        neutralQ = jnp.inf if min_sum else jnp.float32(38.0)  # tanh->1

        def pad_neutral(Qflat):
            # overwrite padding slots (c2v == n*wc) with the neutral
            return jnp.where(jnp.asarray(c2v) == n * wc, neutralQ, Qflat)

        def step(carry, _):
            Rv = carry                       # [.., n*wc+1] var-side R
            post = llr + jnp.sum(
                Rv[..., :n * wc].reshape(batch + (n, wc)), axis=-1)
            postp = jnp.pad(post, [(0, 0)] * len(batch) + [(0, 1)])
            Qv = (postp[..., jnp.asarray(cvar)]
                  - Rv[..., jnp.asarray(c2v)])      # check order, flat
            Qv = pad_neutral(Qv)
            R = check_update(Qv.reshape(batch + (m, wr)))
            Rflat = jnp.pad(R.reshape(batch + (m * wr,)),
                            [(0, 0)] * len(batch) + [(0, 1)])
            Rv2 = Rflat[..., jnp.asarray(v2c)]
            Rv2 = jnp.where(jnp.asarray(v2c) == m * wr, 0.0, Rv2)
            return jnp.pad(Rv2, [(0, 0)] * len(batch) + [(0, 1)]), None

        Rv0 = jnp.zeros(batch + (n * wc + 1,), jnp.float32)
        Rv, _ = lax.scan(step, Rv0, None, length=max_iters)
        post = llr + jnp.sum(
            Rv[..., :n * wc].reshape(batch + (n, wc)), axis=-1)
        hard = (post < 0).astype(jnp.int32)
        syn = jnp.einsum("...n,mn->...m", hard.astype(jnp.float32),
                         jnp.asarray(Hf),
                         precision=lax.Precision.HIGHEST)
        ok = jnp.all(jnp.mod(syn, 2.0) == 0, axis=-1)
        return hard, ok

    return decode_fn
