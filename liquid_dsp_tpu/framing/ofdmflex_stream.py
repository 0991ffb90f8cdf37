"""Full-device streaming OFDM flexframe receiver.

The reference's `ofdmflexframesync` runs its whole pipeline in-stream —
S0 seek, S1 sync, per-symbol EQ, header decode, payload decode, callback
(reference src/framing/src/ofdmflexframesync.c:63-93).  The host-looped
`OFDMFlexFrameSync` (ofdmflexframe.py) keeps that contract for arbitrary
per-frame configurations; THIS module is the device-resident fixed-config
pipeline: for a known payload configuration (the deployed-link case),
every stage from raw samples to FEC-decoded message indices runs inside
ONE jitted block step:

    samples [..., T]
      -> Schmidl-Cox S0 detect-everywhere (banded-matmul window sums)
      -> per-candidate window extraction (stacked planes + fori_loop
         dynamic_slice — occupancy-scaled)
      -> batched S1 timing matmul + channel EQ + CP-strip FFT + pilot
         phase/timing tracking (multichannel.ofdm.ofdm_demod_window)
      -> header: BPSK max-log LLRs, static descramble sign mask,
         deinterleave gather, Golay codebook matmul, argmax
      -> payload: exact max-log LLRs for the configured modem, same
         device block-FEC decode (fec/device.py)

      -> byte pack + CRC validation + header field checks ON DEVICE
         (fec.device.device_packet_finish: packing is a 0/1-weight
         matmul, the CRC a GF(2)-affine parity matmul)

Only the user callback remains on the host (the reference's callback
hands bytes to host user code anyway, ofdmflexframesync.c callback
field).

The header is 14 bytes coded crc32 + Golay(24,12), scrambled, BPSK
(reference ofdmflexframegen.c:495-523).  Its packetizer configuration
(crc32, fec0=golay2412, fec1=none) produces byte-identical output to
(crc32, none, golay2412) — both reduce to interleave4(golay(buf)) — so
the device block-FEC decoder applies to the header too; the scramble is
a fixed bit mask, i.e. a static +-1 sign flip in LLR domain.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core import Proc
from ..multichannel.ofdm import (OFDMParams, ofdm_params, ofdm_demod_consts,
                                 ofdm_s1_search, ofdm_demod_body,
                                 s0_detect_block)
from ..modem.linear import constellation, bits_per_symbol, demodulate_soft
from ..fec.packetizer import packetizer_compute_enc_msg_len
from ..fec.device import (packetizer_soft_decoder, qpacket_soft_decoder,
                          device_packet_finish)
from ..utils.random import _MASKS
from .ofdmflexframe import OFDMFLEXFRAME_H_USER, _H_CRC, _H_FEC, _PROTOCOL
from .wire import crc_to_wire, fec_to_wire, modem_to_wire

__all__ = ["ofdmflex_rx_stream", "OFDMFlexStreamBlock", "OFDMFlexStreamRX"]

_CH = 256                     # detection chunk size (must divide block)


class OFDMFlexStreamBlock(NamedTuple):
    """Per-block batched full-RX result; leading axis = candidate slot."""
    valid: jnp.ndarray        # [..., P] bool
    sample_index: jnp.ndarray # [..., P] int32, absolute stream index
    rxy: jnp.ndarray          # [..., P] S0 plateau metric
    cfo: jnp.ndarray          # [..., P] refined CFO, rad/sample
    evm_db: jnp.ndarray       # [..., P] pilot-referenced EVM
    hdr_msgs: jnp.ndarray     # [..., P, ncw_h] int32 Golay message idx
    pay_msgs: jnp.ndarray     # [..., P, ncw_p] int32 FEC message idx
    hdr_bytes: jnp.ndarray    # [..., P, hdr_len] int32 decoded header
    hdr_ok: jnp.ndarray       # [..., P] bool CRC + expected-config check
    pay_bytes: jnp.ndarray    # [..., P, payload_len] int32
    pay_ok: jnp.ndarray       # [..., P] bool payload CRC


def _geometry(params: OFDMParams, payload_len: int, crc: str, fec0: str,
              fec1: str, ms: str):
    h_enc_len = packetizer_compute_enc_msg_len(
        OFDMFLEXFRAME_H_USER + 6, _H_CRC, _H_FEC, "none")
    h_syms_n = 8 * h_enc_len
    p_enc_len = packetizer_compute_enc_msg_len(payload_len, crc, fec0, fec1)
    bps = bits_per_symbol(ms)
    p_syms = -(-(8 * p_enc_len) // bps)
    nh = -(-h_syms_n // params.M_data)
    npd = -(-p_syms // params.M_data)
    return h_enc_len, h_syms_n, p_syms, nh, npd


def ofdmflex_rx_stream(block_len: int, payload_len: int,
                       crc: str = "crc32", fec0: str = "none",
                       fec1: str = "golay2412", ms: str = "qpsk",
                       M: int = 64, cp_len: int = 16,
                       params: OFDMParams | None = None,
                       threshold: float = 0.7,
                       max_frames: int = 4) -> Proc:
    """Device-resident streaming OFDM flexframe receiver for one payload
    configuration.  apply(params_, carry, x[..., block_len]) ->
    (OFDMFlexStreamBlock, carry').  Use OFDMFlexStreamRX for the host
    byte/CRC finish + callback contract."""
    if params is None:
        params = ofdm_params(M, cp_len)
    T = int(block_len)
    if T % _CH != 0:
        raise ValueError(f"block_len must be a multiple of {_CH}")
    P_ = int(max_frames)
    Mn, cp = params.M, params.cp_len
    h_enc_len, h_syms_n, p_syms, nh, npd = _geometry(
        params, payload_len, crc, fec0, fec1, ms)
    n_syms = nh + npd
    dc = ofdm_demod_consts(params, n_syms)
    WIN = dc["WIN"]
    span = (3 + n_syms) * (Mn + cp)              # full frame length
    hist = -(-WIN // _CH) * _CH                  # lookahead >= WIN
    n_chunk = (hist + T - Mn) // _CH
    Md = params.M_data

    # header LLR decode chain: BPSK LLR -> static descramble sign ->
    # device packetizer decoder (deinterleave gather + Golay codebook
    # matmul + argmax).  Scramble XOR in bit domain == sign flip in LLR
    # domain (positive LLR = bit 1).
    hdr_llr_fn, _hdr_finish = packetizer_soft_decoder(
        OFDMFLEXFRAME_H_USER + 6, _H_CRC, "none", _H_FEC)
    scr_bits = np.unpackbits(np.resize(_MASKS, h_enc_len))
    scr_sign = (1.0 - 2.0 * scr_bits).astype(np.float32)    # [h_syms_n]
    pay_fn, _pay_finish = qpacket_soft_decoder(payload_len, crc, fec0,
                                               fec1, ms)
    bpsk_t = np.asarray(constellation("bpsk"), np.complex64)
    # device byte pack + CRC (+ expected-config header field check): the
    # deployed-link receiver accepts only headers announcing ITS config,
    # so the check is a static compare of 6 header byte positions
    hdr_fin = device_packet_finish(OFDMFLEXFRAME_H_USER + 6, _H_CRC,
                                   "none", _H_FEC)
    pay_fin = device_packet_finish(payload_len, crc, fec0, fec1)
    ku = OFDMFLEXFRAME_H_USER
    _exp = {ku + 0: _PROTOCOL,
            ku + 1: (payload_len >> 8) & 0xFF,
            ku + 2: payload_len & 0xFF,
            ku + 3: modem_to_wire(ms),
            ku + 4: ((crc_to_wire(crc) & 0x07) << 5) |
                    (fec_to_wire(fec0) & 0x1F),
            ku + 5: fec_to_wire(fec1) & 0x1F}
    exp_idx = np.asarray(sorted(_exp), np.int32)
    exp_val = np.asarray([_exp[i] for i in sorted(_exp)], np.int32)

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"buf": jnp.zeros(batch_shape + (hist,), jnp.complex64),
                "base": jnp.full(batch_shape, -hist, jnp.int32),
                "last_end": jnp.full(batch_shape, -(1 << 30), jnp.int32)}

    def _apply_1d(carry, x):
        buf = jnp.concatenate([carry["buf"], x.astype(jnp.complex64)],
                              axis=-1)                       # [hist+T]
        valid, d0, cfo0, peak, cand, pos, n_cand = s0_detect_block(
            buf, carry["last_end"], Mn, threshold, span, T, n_chunk,
            P_, _CH)
        # ---- two-stage extraction: NO vmapped dynamic
        # slices anywhere.  Stage A slices the SHORT S1-search window
        # [2, WA] per valid candidate (dynamic-trip fori_loop, stacked
        # planes), finds `best` with a batched conv correlation; stage
        # B slices the S1-aligned [2, M+body_len] window at d0+best and
        # demodulates without any internal dynamic slice (the old
        # vmapped ofdm_demod_window lowered its two per-candidate
        # dynamic slices to SEQUENTIAL while loops, which dominated the
        # full-RX cost on the accelerator this was first tuned on; not
        # measured on H100) ----
        buf2 = jnp.stack([jnp.real(buf), jnp.imag(buf)])
        need_end = max(0, (T - 1 + WIN) - (hist + T))
        if need_end:
            buf2 = jnp.pad(buf2, ((0, 0), (0, need_end)))
        WA = dc["W1"] + Mn - 1
        WB = Mn + dc["body_len"]
        trip = jnp.minimum(n_cand, P_)

        def _fill_a(i, acc):
            w = lax.dynamic_slice(buf2, (0, d0[i]), (2, WA))
            return lax.dynamic_update_slice(acc, w[None], (i, 0, 0))

        wa = lax.fori_loop(0, trip, _fill_a,
                           jnp.zeros((P_, 2, WA), jnp.float32))
        best = ofdm_s1_search(dc, wa, cfo0)                  # [P]

        def _fill_b(i, acc):
            w = lax.dynamic_slice(buf2, (0, d0[i] + best[i]), (2, WB))
            return lax.dynamic_update_slice(acc, w[None], (i, 0, 0))

        wb = lax.fori_loop(0, trip, _fill_b,
                           jnp.zeros((P_, 2, WB), jnp.float32))
        data, perr, cfo_out = jax.vmap(
            lambda w, c, b: ofdm_demod_body(dc, w, c, b))(wb, cfo0, best)
        evm_db = 20.0 * jnp.log10(jnp.sqrt(
            jnp.mean(jnp.abs(perr) ** 2, axis=(-2, -1))) + 1e-12)
        # ---- header decode on device ----
        h_stream = data[:, :nh].reshape(P_, nh * Md)[:, :h_syms_n]
        llr_h = demodulate_soft(jnp.asarray(bpsk_t), h_stream)[..., 0]
        hdr_msgs = hdr_llr_fn(llr_h * scr_sign)              # [P, ncw_h]
        # ---- payload decode on device ----
        p_stream = data[:, nh:].reshape(P_, npd * Md)[:, :p_syms]
        pay_msgs = pay_fn(p_stream)                          # [P, ncw_p]
        # ---- byte pack + CRC + header config check, still on device ----
        hdr_bytes, h_crc_ok = hdr_fin(hdr_msgs)
        hdr_ok = h_crc_ok & jnp.all(
            hdr_bytes[..., jnp.asarray(exp_idx)] == jnp.asarray(exp_val),
            axis=-1)
        pay_bytes, pay_ok = pay_fin(pay_msgs)
        out = OFDMFlexStreamBlock(
            valid=valid, sample_index=carry["base"] + d0,
            rxy=peak, cfo=cfo_out, evm_db=evm_db,
            hdr_msgs=hdr_msgs, pay_msgs=pay_msgs,
            hdr_bytes=hdr_bytes, hdr_ok=hdr_ok,
            pay_bytes=pay_bytes, pay_ok=pay_ok)
        last_n0 = jnp.max(jnp.where(cand, pos, -(1 << 30)))
        new_last = jnp.maximum(
            carry["last_end"],
            jnp.where(n_cand > 0, last_n0 + span, -(1 << 30))) - T
        new_carry = {"buf": buf[..., T:], "base": carry["base"] + T,
                     "last_end": jnp.maximum(new_last, -(1 << 30))}
        return out, new_carry

    from .stream_rx import batched_apply
    apply = batched_apply(_apply_1d, T)

    return Proc(params=(), init=init, apply=apply, rate=(1, 1),
                name="ofdmflex_rx_stream")


class OFDMFlexStreamRX:
    """Host wrapper: feeds blocks through the device pipeline and
    finishes each valid slot (byte pack + CRC + header field checks)
    with the reference callback contract (header, header_ok, payload,
    payload_ok, stats).  Fixed payload configuration; frames whose
    decoded header disagrees with it are reported header_ok=False
    (the deployed-link receiver semantics)."""

    def __init__(self, payload_len: int, callback=None, crc: str = "crc32",
                 fec0: str = "none", fec1: str = "golay2412",
                 ms: str = "qpsk", M: int = 64, cp_len: int = 16,
                 params: OFDMParams | None = None, block_len: int = 4096,
                 threshold: float = 0.7, max_frames: int = 4):
        self.callback = callback
        self.cfg = (payload_len, crc, fec0, fec1, ms)
        self.params = params if params is not None else ofdm_params(M, cp_len)
        self.block_len = int(block_len)
        self._proc = ofdmflex_rx_stream(
            block_len, payload_len, crc, fec0, fec1, ms,
            params=self.params, threshold=threshold, max_frames=max_frames)
        self._carry = self._proc.init()
        self._jit = jax.jit(self._proc.apply)
        self._pending = np.zeros(0, np.complex64)
        self.frames: list = []
        self.num_frames_detected = 0

    def execute(self, x):
        self._pending = np.concatenate(
            [self._pending, np.asarray(x, np.complex64)])
        results = []
        while len(self._pending) >= self.block_len:
            blk = self._pending[:self.block_len]
            self._pending = self._pending[self.block_len:]
            out, self._carry = self._jit((), self._carry, jnp.asarray(blk))
            results.extend(self._finish(out))
        return results

    def flush(self):
        # enough zeros that any in-flight frame's full window is fed
        hist = int(np.asarray(self._carry["buf"]).shape[-1])
        pad = (-len(self._pending)) % self.block_len + \
            -(-(hist + self.block_len) // self.block_len) * self.block_len
        return self.execute(np.zeros(pad, np.complex64))

    def _finish(self, out):
        # every decode product (bytes, CRC, header config check) arrived
        # from the device; the host only formats frames + fires callbacks
        valid = np.asarray(out.valid)
        hdr_bytes = np.asarray(out.hdr_bytes).astype(np.uint8)
        pay_bytes = np.asarray(out.pay_bytes).astype(np.uint8)
        hdr_ok = np.asarray(out.hdr_ok)
        pay_ok = np.asarray(out.pay_ok)
        # one transfer per array, not four scalar readbacks per frame
        rxy = np.asarray(out.rxy)
        cfo = np.asarray(out.cfo)
        evm = np.asarray(out.evm_db)
        sidx = np.asarray(out.sample_index)
        res = []
        for p in np.nonzero(valid)[0]:
            self.num_frames_detected += 1
            h_ok = bool(hdr_ok[p])
            header = hdr_bytes[p, :OFDMFLEXFRAME_H_USER]
            stats = {"rxy": float(rxy[p]), "cfo": float(cfo[p]),
                     "evm_db": float(evm[p]),
                     "sample_index": int(sidx[p]),
                     "payload_len": self.cfg[0], "ms": self.cfg[4]}
            if not h_ok:
                frame = (header, False, None, False, stats)
            else:
                frame = (header, True, pay_bytes[p], bool(pay_ok[p]),
                         stats)
            self.frames.append(frame)
            if self.callback is not None:
                self.callback(*frame)
            res.append(frame)
        return res
