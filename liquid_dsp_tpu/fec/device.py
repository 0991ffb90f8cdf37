"""Device-resident soft block-FEC decode: the byte-plane decode matmul
on the accelerator, where it belongs inside a receiver pipeline.

The host byte path (`fec/block.py`) stays the right tool for packet
assembly, but a streaming receiver that has already produced corrected
payload SYMBOLS on device (framing/stream_rx.py) should not round-trip
them to the host just to run a [nsym, n] @ [n, 2^k] correlation — that
matmul belongs next to the rest of the receiver.  This module builds,
per qpacketmodem
configuration, a jittable decoder:

    symbols [..., nsym_mod] complex
      -> exact max-log LLRs (modem.demodulate_soft, on device)
      -> bit-level deinterleave as ONE static-index gather (the
         reference interleaver's depth-4 byte/bit-mask swap cascade is
         a fixed bit permutation for a given length; precomputed host-
         side by pushing an index ramp through deinterleave_soft —
         static numpy index arrays)
      -> [..., ncw, n] @ [n, 2^k] codebook correlation
         (Precision.HIGHEST: scores feed an argmax, and reduced-
         precision passes can flip borderline codeword decisions)
      -> argmax -> k-bit message indices [..., ncw] int32

plus a small host `finish` that packs message bits to bytes and checks
the CRC (byte packing + CRC are O(bytes) and control-flow-bound — the
reference's own callback hands bytes to host user code anyway,
src/framing/src/framesync64.c:68-70).

Soft max-correlation decode is the reference's own soft criterion
(fecsoft_hamming74_decode and friends minimize soft distance —
identical argmax); it is strictly stronger than the hard-decision path
under noise, so frames the hard decoder loses can still decode.

Reference analogs: fec soft decode dispatch src/fec/src/fec.c,
qpacketmodem_decode_soft src/framing/src/qpacketmodem.c:297-316.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

from .block import _GCOLS, _code_matrices
from .crc import crc_sizeof_key, crc_validate_message, crc_generate_key
from .packetizer import packetizer_compute_enc_msg_len
from .interleave import deinterleave_soft
from .dispatch import fec_get_enc_msg_length

__all__ = ["qpacket_soft_decoder", "packetizer_soft_decoder",
           "block_codebook", "conv_soft_decoder",
           "conv_packet_soft_decoder", "qpacket_conv_soft_decoder",
           "device_packet_finish"]


def _scores_argmax(cw, bip):
    """argmax over the codebook-correlation scores.

    Codebooks of at least the platform's `codebook_kernel_min_k`
    candidates (platform.py; golay2412, hamming1511 on the GPU) run the
    fused matmul+argmax kernel (ops/kernels/pallas_codebook.py), which
    keeps the [..., ncw, K] scores out of device memory.  Same result:
    float32 scores, first index on ties.  Elsewhere the einsum+argmax."""
    from ..platform import policy
    K = bip.shape[1]
    min_k = policy("codebook_kernel_min_k")
    if min_k is not None and K >= min_k:
        from ..ops.kernels.pallas_codebook import codebook_argmax
        return codebook_argmax(cw, bip)
    scores = jnp.einsum("...cn,nm->...cm", cw, jnp.asarray(bip),
                        precision=lax.Precision.HIGHEST)
    return jnp.argmax(scores, axis=-1).astype(jnp.int32)


@functools.lru_cache(maxsize=16)
def block_codebook(scheme: str):
    """(bipolar codebook [n, 2^k] float32, n, k) for a block scheme.
    bip[:, m] = 2*G(m) - 1 where G(m) is message m's codeword."""
    n, k, _ = _GCOLS[scheme]
    G, _, _ = _code_matrices(scheme)
    msgs = ((np.arange(1 << k)[:, None] >>
             np.arange(k - 1, -1, -1)) & 1).astype(np.uint8)
    C = (msgs @ G) % 2                       # [2^k, n]
    return (2.0 * C.T - 1.0).astype(np.float32), n, k


@functools.lru_cache(maxsize=16)
def _deint_perm(enc_len: int) -> np.ndarray:
    """Bit-level deinterleave permutation for an enc_len-byte packet:
    out_bit[i] = in_bit[perm[i]] (static int32 index array)."""
    ramp = np.arange(8 * enc_len, dtype=np.float32)
    return np.asarray(deinterleave_soft(ramp), np.float32).astype(np.int32)


def _golay_pack(msgs: np.ndarray, dec_len: int) -> np.ndarray:
    """Pack 12-bit message indices into bytes, two messages -> 3 bytes
    (mirrors fec/block.py golay byte layout); msgs [..., ncw]."""
    full, rem = divmod(dec_len, 3)
    m0 = msgs[..., 0:2 * full:2]
    m1 = msgs[..., 1:2 * full:2]
    out = np.zeros(msgs.shape[:-1] + (dec_len,), np.uint8)
    out[..., 0:3 * full:3] = (m0 >> 4) & 0xFF
    out[..., 1:3 * full:3] = ((m0 & 0x0F) << 4) | ((m1 >> 8) & 0x0F)
    out[..., 2:3 * full:3] = m1 & 0xFF
    for i in range(rem):
        out[..., 3 * full + i] = msgs[..., 2 * full + i] & 0xFF
    return out


def packetizer_soft_decoder(payload_len: int, crc: str = "crc24",
                            fec0: str = "none", fec1: str = "golay2412"):
    """Build (device_fn, finish) for a PACKETIZER configuration whose
    outer code is a block scheme and inner code is none.

    device_fn(llr [..., >= 8*enc_len] float, positive = bit 1) ->
      msgs [..., ncw] int32 — fully jittable; callers that demodulate
      their own soft bits (GMSK phase-derivative MF) feed them here.
    finish(msgs numpy [..., ncw]) -> (payload [..., payload_len] uint8,
      crc_ok [...] bool) — host byte packing + CRC.
    """
    if fec0 != "none":
        raise ValueError("device decoder supports fec0='none' "
                         "(frame64/flexframe default payload shape)")
    if fec1 not in _GCOLS:
        raise ValueError(f"outer scheme {fec1!r} is not a block code")
    if _GCOLS[fec1][1] > 16:
        # hamming3126's 31 x 2^26 codebook does not fit anywhere useful
        raise ValueError(f"{fec1!r} codebook too large for the matmul "
                         "decoder (k > 16)")
    dec_len = payload_len + crc_sizeof_key(crc)
    enc_len = fec_get_enc_msg_length(fec1, dec_len)
    assert enc_len == packetizer_compute_enc_msg_len(
        payload_len, crc, fec0, fec1)
    bip, n, k = block_codebook(fec1)
    if fec1 == "golay2412":
        rem = dec_len % 3
        ncw = 2 * (dec_len // 3) + rem
    else:
        ncw = -(-(8 * dec_len) // k)
    perm = _deint_perm(enc_len)              # [8*enc_len] int32, static
    need = 8 * enc_len

    def device_fn(llr):
        flat = jnp.asarray(llr)
        if flat.shape[-1] < need:
            pad = [(0, 0)] * (flat.ndim - 1) + [(0, need - flat.shape[-1])]
            flat = jnp.pad(flat, pad)
        deint = flat[..., :need][..., jnp.asarray(perm)]
        # 8*enc_len may exceed ncw*n by the final byte's pad bits
        cw = deint[..., :ncw * n].reshape(deint.shape[:-1] + (ncw, n))
        return _scores_argmax(cw, bip)

    def finish(msgs):
        msgs = np.asarray(msgs)
        buf = _pack_msgs(msgs, fec1, k, ncw, dec_len)
        payload = buf[..., :payload_len]
        nk = crc_sizeof_key(crc)
        flat = buf.reshape(-1, dec_len)
        ok = np.zeros(flat.shape[0], bool)
        for r in range(flat.shape[0]):
            key = 0
            for b in flat[r, payload_len:payload_len + nk]:
                key = (key << 8) | int(b)
            ok[r] = crc_validate_message(crc, flat[r, :payload_len], key)
        return payload, ok.reshape(buf.shape[:-1])

    return device_fn, finish


def conv_soft_decoder(scheme: str, dec_len: int):
    """Jittable batched soft Viterbi for a convolutional scheme:
    device_fn(llr [..., >= 8*enc_len] float, positive = bit 1) ->
    bits [..., 8*dec_len] int32 — the whole trellis on device.

    Device design (vs the host conv_decode in fec/conv.py, which mixes
    numpy depuncture with a per-packet scan):
      * depuncture is a STATIC scatter (erasures = zero metric),
      * the ACS step is batched over leading axes: each next state's 2
        predecessors are static index arrays, so the gather
        pm[..., prev] is static; branch metrics come from one einsum,
      * traceback is GATHER-FREE: the winning predecessor bit is a
        one-hot reduction over states and the predecessor state is the
        closed form (state >> 1) + j * (ns/2) — no traced jnp.take.

    v615 is rejected: its 16384-state ACS per bit is ~64x v29's work
    with the same sequential depth, far past any practical batching
    win on the device — it stays a host decode (documented in API_PARITY.md).
    Reference analog: fec_conv.c:225-266 (libfec Viterbi delegation).
    """
    from .conv import _parse, _trellis, conv_get_enc_msg_length
    import jax
    from ..core import scan_unroll

    K, polys, pmat = _parse(scheme)
    if K > 9:
        raise ValueError(
            f"{scheme!r}: 2^{K - 1} = {1 << (K - 1)} states per ACS step "
            "is host-only territory (see API_PARITY.md)")
    r = len(polys)
    ns = 1 << (K - 1)
    nbits_in = 8 * dec_len + K - 1
    enc_len = conv_get_enc_msg_length(scheme, dec_len)
    # static depuncture scatter: which llr index feeds each (t, stream)
    if pmat is None:
        keep_idx = np.arange(nbits_in * r, dtype=np.int32)
    else:
        period = pmat.shape[1]
        keep = np.resize(pmat.T, ((-(-nbits_in // period)) * period, r)
                         )[:nbits_in].astype(bool).reshape(-1)
        keep_idx = np.nonzero(keep)[0].astype(np.int32)
    n_kept = len(keep_idx)
    assert n_kept <= 8 * enc_len
    out, _ = _trellis(K, tuple(polys))
    exp = (2.0 * out.astype(np.float32) - 1.0)          # [ns, 2, r]
    NEG = np.float32(-1e9)
    half = np.int32(ns >> 1)

    def device_fn(llr):
        llr = jnp.asarray(llr)
        flat = jnp.zeros(llr.shape[:-1] + (nbits_in * r,), jnp.float32)
        flat = flat.at[..., jnp.asarray(keep_idx)].set(
            llr[..., :n_kept].astype(jnp.float32))
        obs = flat.reshape(flat.shape[:-1] + (nbits_in, r))
        bm = jnp.einsum("...tr,sbr->...tsb", obs, jnp.asarray(exp),
                        precision=lax.Precision.HIGHEST)
        bm = bm.reshape(bm.shape[:-2] + (ns * 2,))
        bm_t = jnp.moveaxis(bm, -2, 0)                  # [T, ..., ns*2]

        def acs(pm, bmt):
            # GATHER-FREE ACS: state s' has predecessors (s'>>1) and
            # (s'>>1) + ns/2, so pm[..., prev] is repeat-by-2 of each
            # pm half; and the flat branch index prev*2 + (s'&1) equals
            # s' (first half) / s' + ns (second half), so bmt[..., fidx]
            # is just a split.  The static fancy-index form lowered to
            # shape-dependent gather code that was far slower at
            # rectangular [batch, states] on the accelerator this was
            # first tuned on (not measured on H100).
            def rep2(a):       # [..., ns/2] -> [..., ns], a[s'>>1]
                return jnp.broadcast_to(
                    a[..., :, None], a.shape + (2,)
                ).reshape(a.shape[:-1] + (a.shape[-1] * 2,))
            cand0 = rep2(pm[..., :half]) + bmt[..., :ns]
            cand1 = rep2(pm[..., half:]) + bmt[..., ns:]
            j = (cand1 > cand0).astype(jnp.int32)            # [..., ns]
            new_pm = jnp.maximum(cand0, cand1)
            # normalize: path metrics grow linearly with T
            new_pm = new_pm - jnp.max(new_pm, axis=-1, keepdims=True)
            return new_pm, j

        pm0 = jnp.full((ns,), NEG, jnp.float32).at[0].set(0.0)
        pm0 = jnp.broadcast_to(pm0, llr.shape[:-1] + (ns,))
        _, decs = lax.scan(acs, pm0, bm_t,
                           unroll=scan_unroll(8) if ns <= 256 else 1)

        states = jnp.asarray(np.arange(ns, dtype=np.int32))

        def back(state, dec_t):
            # gather-free: one-hot select the winning predecessor index
            oh = (state[..., None] == states).astype(jnp.int32)
            j = jnp.sum(oh * dec_t, axis=-1)
            bit = state & 1
            prev_state = (state >> 1) + j * half
            return prev_state, bit

        state0 = jnp.zeros(llr.shape[:-1], jnp.int32)   # flushed to 0
        _, bits_rev = lax.scan(back, state0, decs, reverse=True,
                               unroll=scan_unroll(8))
        bits = jnp.moveaxis(bits_rev, 0, -1)            # [..., nbits_in]
        return bits[..., : 8 * dec_len]

    return device_fn, enc_len


def conv_packet_soft_decoder(payload_len: int, crc: str = "crc32",
                             fec0: str = "v27", fec1: str = "none"):
    """(device_fn, finish) for a packetizer configuration whose coding
    is ONE convolutional stage (the other 'none'): encode reduces to
    interleave4(conv_encode(buf)) either way, so the device path is a
    static deinterleave gather + the batched soft Viterbi.

    device_fn(llr [..., >= 8*enc_len]) -> bits [..., 8*dec_len] int32
    finish(bits numpy) -> (payload [..., payload_len] uint8, crc_ok)
    """
    from .conv import CONV_SCHEMES
    schemes = {fec0, fec1}
    conv = [s for s in schemes if s in CONV_SCHEMES]
    if len(conv) != 1 or (schemes - set(conv)) != {"none"}:
        raise ValueError("conv packet decoder needs exactly one conv "
                         f"stage and one 'none', got ({fec0!r}, {fec1!r})")
    scheme = conv[0]
    dec_len = payload_len + crc_sizeof_key(crc)
    vit_fn, enc_len = conv_soft_decoder(scheme, dec_len)
    assert enc_len == packetizer_compute_enc_msg_len(
        payload_len, crc, fec0, fec1)
    perm = _deint_perm(enc_len)
    need = 8 * enc_len

    def device_fn(llr):
        flat = jnp.asarray(llr)
        if flat.shape[-1] < need:
            pad = [(0, 0)] * (flat.ndim - 1) + [(0, need - flat.shape[-1])]
            flat = jnp.pad(flat, pad)
        deint = flat[..., :need][..., jnp.asarray(perm)]
        return vit_fn(deint)

    def finish(bits):
        bits = np.asarray(bits, np.uint8)
        buf = np.packbits(bits, axis=-1)[..., :dec_len]
        payload = buf[..., :payload_len]
        nk = crc_sizeof_key(crc)
        flat = buf.reshape(-1, dec_len)
        ok = np.zeros(flat.shape[0], bool)
        for rr in range(flat.shape[0]):
            key = 0
            for b in flat[rr, payload_len:payload_len + nk]:
                key = (key << 8) | int(b)
            ok[rr] = crc_validate_message(crc, flat[rr, :payload_len], key)
        return payload, ok.reshape(buf.shape[:-1])

    return device_fn, finish


def qpacket_conv_soft_decoder(payload_len: int, crc: str = "crc32",
                              fec0: str = "v27", fec1: str = "none",
                              ms: str = "qpsk"):
    """conv_packet_soft_decoder with the modem's exact max-log soft
    demodulator in front: device_fn(symbols [..., nsym] complex) ->
    bits [..., 8*dec_len] int32 (fully jittable, batched)."""
    from ..modem.linear import constellation

    llr_fn, finish = conv_packet_soft_decoder(payload_len, crc, fec0, fec1)
    table = np.asarray(constellation(ms), np.complex64)

    def device_fn(symbols):
        from ..modem.linear import demodulate_soft
        llr = demodulate_soft(jnp.asarray(table), symbols)
        return llr_fn(llr.reshape(llr.shape[:-2] + (-1,)))

    return device_fn, finish


def qpacket_soft_decoder(payload_len: int, crc: str = "crc24",
                         fec0: str = "none", fec1: str = "golay2412",
                         ms: str = "qpsk"):
    """Build (device_fn, finish) for a qpacketmodem configuration whose
    outer code is a block scheme and inner code is none (the frame64 /
    default flexframe payload shape): the packetizer decoder above with
    the modem's exact max-log soft demodulator in front.

    device_fn(symbols [..., nsym_mod] complex) -> msgs [..., ncw] int32
      — fully jittable, batches over leading axes (channels, slots).
    finish(msgs numpy [..., ncw]) -> (payload [..., payload_len] uint8,
      crc_ok [...] bool) — host byte packing + CRC.
    """
    from ..modem.linear import constellation

    llr_fn, finish = packetizer_soft_decoder(payload_len, crc, fec0, fec1)
    # complex64: constellation() can promote to complex128 under NEP-50
    table = np.asarray(constellation(ms), np.complex64)

    def device_fn(symbols):
        from ..modem.linear import demodulate_soft
        llr = demodulate_soft(jnp.asarray(table), symbols)  # [.., T, bps]
        return llr_fn(llr.reshape(llr.shape[:-2] + (-1,)))

    return device_fn, finish


# ---------------------------------------------------------------------------
# device byte pack + CRC: the LAST host stage of the payload path
# (reference framing syncs call crc_validate_message on the host CPU —
# e.g. src/framing/src/framesync64.c decode tail; here the receiver's
# block step emits payload bytes and CRC validity from the chip)


@functools.lru_cache(maxsize=32)
def _crc_affine(scheme: str, payload_len: int):
    """CRC keys are GF(2)-AFFINE in the message bits for a fixed message
    length: key_bits(m) = M^T bits(m) xor key_bits(0).  Columns are
    recovered from bit-impulse messages through the byte-exact host CRC
    (reference crc.c semantics), so the device parity matmul reproduces
    the reference key for every message.

    Returns (M [8*payload_len, width] uint8, cbits [width] uint8)."""
    width = 8 * crc_sizeof_key(scheme)
    nb = 8 * payload_len

    def keybits(msg):
        kk = crc_generate_key(scheme, msg)
        return np.array([(kk >> (width - 1 - w)) & 1
                         for w in range(width)], np.uint8)

    cbits = keybits(np.zeros(payload_len, np.uint8))
    M = np.zeros((nb, width), np.uint8)
    for i in range(nb):
        msg = np.zeros(payload_len, np.uint8)
        msg[i >> 3] = 0x80 >> (i & 7)
        M[i] = keybits(msg) ^ cbits
    return M, cbits


def _pack_msgs(msgs: np.ndarray, fec1: str, k: int, ncw: int,
               dec_len: int) -> np.ndarray:
    """Host byte packing of decoded message indices (block-code path);
    the single source of truth shared by the host finish and the
    impulse-response discovery of the device relabel matrix."""
    if fec1 == "golay2412":
        return _golay_pack(msgs, dec_len)
    bits = ((msgs[..., None] >>
             np.arange(k - 1, -1, -1)) & 1).astype(np.uint8)
    bits = bits.reshape(msgs.shape[:-1] + (ncw * k,))[..., :8 * dec_len]
    return np.packbits(bits, axis=-1)[..., :dec_len]


def device_packet_finish(payload_len: int, crc: str = "crc24",
                         fec0: str = "none", fec1: str = "golay2412"):
    """Jittable byte pack + CRC validation for a decoded packet — the
    device-side counterpart of the host `finish` functions above.

    Input matches the corresponding decoder family:
      * block configs (fec0='none', fec1 a block code): msgs [..., ncw]
        int32 as produced by packetizer_soft_decoder's device_fn;
      * conv configs (one conv stage + 'none'): bits [..., 8*dec_len]
        int32 as produced by conv_packet_soft_decoder's device_fn.

    Returns finish_fn(dec) -> (payload [..., payload_len] int32 bytes,
    crc_ok [...] bool), fully jittable.

    Device design: byte packing is a 0/1-weight matmul (bit -> byte place
    value), and the CRC is its GF(2)-affine parity matmul (_crc_affine)
    reduced mod 2 — both pinned HIGHEST (the sums are exact small
    integers in f32; a reduced-precision pass would round them).
    The 'checksum' scheme is integer-affine instead: byte-sum + key
    must vanish mod 256.
    """
    from .conv import CONV_SCHEMES
    if crc not in ("none", "checksum", "crc8", "crc16", "crc24", "crc32"):
        raise ValueError(f"unknown crc scheme {crc!r}")
    dec_len = payload_len + crc_sizeof_key(crc)
    # Exactness precondition: the f32 HIGHEST matmuls below
    # are exact only while every integer sum stays < 2^24.  Parity sums
    # are bounded by the 8*dec_len contributing bits (~2 MB bound); the
    # checksum byte-sum by 255 per byte — the BINDING bound, admitting
    # dec_len < ~64 KB.  Frame payloads are hundreds of bytes.
    assert 8 * dec_len < 2 ** 24 and 255 * dec_len < 2 ** 24, \
        f"payload_len {payload_len} exceeds f32-exact CRC matmul bound"
    width = 8 * crc_sizeof_key(crc) if crc.startswith("crc") else 0

    msgs_mode = fec0 == "none" and fec1 in _GCOLS
    if fec0 == "none" and fec1 == "none":
        # uncoded (or already-decoded) packet: bits input, identity map
        k = ncw = 0
        nsrc = 8 * dec_len
        relabel = np.arange(8 * dec_len, dtype=np.int64)
    elif msgs_mode:
        if _GCOLS[fec1][1] > 16:
            raise ValueError(f"{fec1!r} codebook too large (k > 16)")
        _, n, k = block_codebook(fec1)
        if fec1 == "golay2412":
            ncw = 2 * (dec_len // 3) + dec_len % 3
        else:
            ncw = -(-(8 * dec_len) // k)
        nsrc = ncw * k
        # impulse-response discovery: which buf bit each msg bit feeds
        relabel = np.full(8 * dec_len, -1, np.int64)
        for cpos in range(ncw):
            for j in range(k):
                m = np.zeros(ncw, np.int64)
                m[cpos] = 1 << (k - 1 - j)
                nz = np.nonzero(np.unpackbits(
                    _pack_msgs(m, fec1, k, ncw, dec_len)))[0]
                assert len(nz) <= 1, "byte packing must be a bit relabel"
                if len(nz):
                    relabel[nz[0]] = cpos * k + j
    else:
        schemes = {fec0, fec1}
        conv = [s for s in schemes if s in CONV_SCHEMES]
        if len(conv) != 1 or (schemes - set(conv)) != {"none"}:
            raise ValueError(
                f"unsupported finish config ({fec0!r}, {fec1!r})")
        k = ncw = 0
        nsrc = 8 * dec_len
        relabel = np.arange(8 * dec_len, dtype=np.int64)

    Wall = np.zeros((nsrc, dec_len), np.float32)
    for q in range(8 * dec_len):
        s = relabel[q]
        if s >= 0:
            Wall[s, q >> 3] += float(0x80 >> (q & 7))
    W = np.ascontiguousarray(Wall[:, :payload_len])

    if width:
        M, cbits = _crc_affine(crc, payload_len)
        P = np.zeros((nsrc, width), np.uint8)
        for i in range(8 * payload_len):
            s = relabel[i]
            if s >= 0:
                P[s] ^= M[i]
        for w in range(width):
            s = relabel[8 * payload_len + w]
            if s >= 0:
                P[s, w] ^= 1
        Pf = P.astype(np.float32)
        cf = cbits.astype(np.float32)
    sumw = Wall.sum(axis=1).astype(np.float32)   # checksum byte weights
    HI = lax.Precision.HIGHEST

    def finish_fn(dec):
        dec = jnp.asarray(dec)
        if msgs_mode:
            bits = (dec[..., None] >> jnp.arange(k - 1, -1, -1)) & 1
            src = bits.reshape(dec.shape[:-1] + (nsrc,)).astype(jnp.float32)
        else:
            src = dec[..., :nsrc].astype(jnp.float32)
        payload = jnp.einsum("...i,ij->...j", src, jnp.asarray(W),
                             precision=HI)
        payload = payload.astype(jnp.int32)
        if crc == "none":
            ok = jnp.ones(dec.shape[:-1], bool)
        elif crc == "checksum":
            tot = jnp.einsum("...i,i->...", src, jnp.asarray(sumw),
                             precision=HI)
            ok = jnp.mod(tot, 256.0) == 0
        else:
            par = jnp.einsum("...i,iw->...w", src, jnp.asarray(Pf),
                             precision=HI) + jnp.asarray(cf)
            ok = jnp.all(jnp.mod(par, 2.0) == 0, axis=-1)
        return payload, ok

    return finish_fn


def packetizer2_soft_decoder(payload_len: int, crc: str = "crc32",
                             fec0: str = "secded7264",
                             fec1: str = "hamming84"):
    """TWO-stage block packetizer decode fully on device — the
    flexframe HEADER configuration (crc32, secded7264, hamming84,
    reference flexframegen.c header encoder).  Returns
    decode_fn(llr [..., >= 8*enc_len], positive = bit 1) ->
    (buf_bytes [..., dec_len] int32, crc_ok [...] bool), jittable.

    Device design:
      * outer stage (fec1): bit deinterleave (static gather) + soft
        codebook matmul + argmax (the packetizer_soft_decoder path);
      * inner stage (fec0 SECDED): byte deinterleave (static bit
        relabel), then per 72-bit block the syndrome is a GF(2) parity
        MATMUL of the data bits against the column matrix xor the
        received parity bits, the error position a one-hot row of a
        [2^p, m] flip table selected by the syndrome value, and the
        correction a mod-2 add — no gathers, no per-block loops
        (reference fec_secded7264.c decodes byte-at-a-time on the CPU);
      * byte pack + CRC: the GF(2)-affine parity matmul of
        device_packet_finish.
    """
    from .block import _SECDED, _secded_cols
    from .packetizer import _plan
    if fec0 not in _SECDED:
        raise ValueError(f"fec0 {fec0!r} is not a SECDED scheme")
    if fec1 not in _GCOLS or _GCOLS[fec1][1] > 16:
        raise ValueError(f"fec1 {fec1!r} needs a small block codebook")
    k_tot, stages = _plan(payload_len, crc, fec0, fec1)
    (fs0, d0, e0, _), (fs1, d1, e1, _) = stages
    assert fs0 == fec0 and fs1 == fec1 and d1 == e0
    dec_len = d0
    bip, n1, k1 = block_codebook(fec1)
    ncw = -(-(8 * d1) // k1)
    perm_out = _deint_perm(e1)                  # [8*e1]
    perm_in = _deint_perm(e0)                   # [8*e0]
    need = 8 * e1

    p, m, _ = _SECDED[fec0]
    cols, table_pos = _secded_cols(fec0)
    nbytes = m // 8
    nblk = -(-d0 // nbytes)
    # static layout: deinterleaved stage-0 bit index for each block's
    # parity byte and data bytes (-1 = zero pad in the final block).
    # The parity byte carries p <= 8 syndrome bits in its LOW bits
    # (fec_secded2216.c packs v[0] & 0x3f), i.e. byte bits (8-p)..7.
    lay_par = np.zeros((nblk, 8), np.int64)
    lay_dat = np.full((nblk, m), -1, np.int64)
    pos_e = pos_d = 0
    out_take = []
    for b in range(nblk):
        take = min(nbytes, d0 - pos_d)
        lay_par[b] = 8 * pos_e + np.arange(8)
        for j in range(take):
            lay_dat[b, 8 * j: 8 * j + 8] = \
                8 * (pos_e + 1 + j) + np.arange(8)
        out_take.append(take)
        pos_e += 1 + take
        pos_d += take
    # gather maps into the deinterleaved bit vector (append one zero
    # slot for the -1 pads)
    gp = np.where(lay_par >= 0, lay_par, 8 * e0).astype(np.int32)[:, 8 - p:]
    gd = np.where(lay_dat >= 0, lay_dat, 8 * e0).astype(np.int32)
    COLS = ((cols[:, None] >> (p - 1 - np.arange(p))[None, :]) & 1
            ).astype(np.float32)                # [m, p]
    FLIP = np.zeros((1 << p, m), np.float32)
    for s in range(1, 1 << p):
        pos = table_pos[s]
        if 0 <= pos < m:
            FLIP[s, pos] = 1.0
    pow2 = (1 << (p - 1 - np.arange(p))).astype(np.float32)
    # corrected data bits -> buf bits (first 8*d0 of the concatenated
    # per-block data bits, skipping final-block pads)
    sel = []
    for b in range(nblk):
        sel.extend(range(b * m, b * m + 8 * out_take[b]))
    sel = np.asarray(sel, np.int32)
    fin = device_packet_finish(payload_len, crc, "none", "none")
    HI = lax.Precision.HIGHEST

    def decode_fn(llr):
        flat = jnp.asarray(llr)
        if flat.shape[-1] < need:
            pad = [(0, 0)] * (flat.ndim - 1) + [(0, need - flat.shape[-1])]
            flat = jnp.pad(flat, pad)
        deint = flat[..., :need][..., jnp.asarray(perm_out)]
        cw = deint[..., :ncw * n1].reshape(deint.shape[:-1] + (ncw, n1))
        msgs = _scores_argmax(cw, bip)
        bits = (msgs[..., None] >> jnp.arange(k1 - 1, -1, -1)) & 1
        bits = bits.reshape(msgs.shape[:-1] + (ncw * k1,))[..., :8 * d1]
        bits = bits.astype(jnp.float32)
        # inner byte deinterleave (bit relabel) + zero pad slot
        deint0 = bits[..., jnp.asarray(perm_in)]
        deint0 = jnp.pad(deint0, [(0, 0)] * (deint0.ndim - 1) + [(0, 1)])
        par_bits = deint0[..., jnp.asarray(gp)]      # [.., nblk, 8]
        dat_bits = deint0[..., jnp.asarray(gd)]      # [.., nblk, m]
        synd = jnp.mod(
            jnp.einsum("...bm,mp->...bp", dat_bits, jnp.asarray(COLS),
                       precision=HI) + par_bits, 2.0)
        sval = jnp.einsum("...bp,p->...b", synd, jnp.asarray(pow2),
                          precision=HI).astype(jnp.int32)
        onehot = (sval[..., None] ==
                  jnp.arange(1 << p)).astype(jnp.float32)
        flip = jnp.einsum("...bs,sm->...bm", onehot, jnp.asarray(FLIP),
                          precision=HI)
        fixed = jnp.mod(dat_bits + flip, 2.0)
        buf_bits = fixed.reshape(fixed.shape[:-2] + (nblk * m,)
                                 )[..., jnp.asarray(sel)]
        return fin(buf_bits.astype(jnp.int32))

    return decode_fn
