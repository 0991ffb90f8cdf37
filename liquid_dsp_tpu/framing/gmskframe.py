"""gmskframegen / gmskframesync: GMSK-modulated frames.

Reference analogs (studied, not copied): reference src/framing/src/
gmskframegen.c:40-360 (63-bit msequence(6,0x6d,1) preamble, 13-byte
header = 8 user + version/length/crc/fec control, CRC-32 +
Hamming(12,8), payload per runtime FEC; GMSK k samples/symbol) and
gmskframesync.c (detector_cccf time-domain correlator + MF timing).

Design: detect the GMSK-modulated preamble template with the same
batched FFT cross-correlator used by the linear framers; the GMSK
phase-derivative demodulator is CFO-tolerant by construction (a carrier
offset appears as a constant bias in the instantaneous frequency, which
is estimated from the preamble and subtracted).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..modem.cpm import gmsk_modulator, gmsk_demodulator
from ..utils.sequence import MSequence
from ..fec.packetizer import (packetizer_encode, packetizer_decode,
                              packetizer_compute_enc_msg_len)
from ..fec.block import unpack_bits, pack_bits
from ..utils.random import scramble_data, unscramble_data
from ..design.windows import hamming
from .wire import crc_to_wire, fec_to_wire, crc_from_wire, fec_from_wire
from .detector import qdetector_detect

__all__ = ["gmskframegen", "gmskframesync", "GMSKFrameResult",
           "GMSKFrameSync", "GMSKFRAME_H_USER",
           "gmskframe_rx_stream", "GMSKStreamBlock"]

GMSKFRAME_H_USER = 8
_H_CRC, _H_FEC = "crc32", "hamming128"
_VERSION = 3


def _preamble_bits(n: int = 63) -> np.ndarray:
    ms = MSequence(6, 0x6D, 1)
    return np.asarray([ms.advance() for _ in range(n)], np.uint8)


def gmskframegen(header, payload, k: int = 2, m: int = 3, bt: float = 0.5,
                 crc: str = "crc32", fec0: str = "none",
                 fec1: str = "none") -> np.ndarray:
    """Assemble a GMSK frame; returns complex samples (k per bit)."""
    header = np.asarray(header, np.uint8)
    payload = np.asarray(payload, np.uint8)
    if header.shape != (GMSKFRAME_H_USER,):
        raise ValueError(f"gmskframe header must be {GMSKFRAME_H_USER} "
                         f"bytes")
    n = len(payload)
    hdr = np.zeros(GMSKFRAME_H_USER + 5, np.uint8)
    hdr[:GMSKFRAME_H_USER] = header
    q = GMSKFRAME_H_USER
    # reference wire format (gmskframegen.c:317-345): version byte,
    # 16-bit length, crc(3b)<<5|fec0(5b), fec1(5b) — reference enum
    # values; header coded crc32+hamming128 then scrambled
    hdr[q + 0] = _VERSION
    hdr[q + 1] = (n >> 8) & 0xFF
    hdr[q + 2] = n & 0xFF
    hdr[q + 3] = ((crc_to_wire(crc) & 0x07) << 5) | \
        (fec_to_wire(fec0) & 0x1F)
    hdr[q + 4] = fec_to_wire(fec1) & 0x1F
    h_enc = scramble_data(packetizer_encode(hdr, _H_CRC, _H_FEC, "none"))
    p_enc = packetizer_encode(payload, crc, fec0, fec1)
    bits = np.concatenate([_preamble_bits(), unpack_bits(h_enc),
                           unpack_bits(p_enc),
                           np.zeros(2 * m, np.uint8)])  # tail flush
    mod = gmsk_modulator(k, m, bt)
    y, _ = mod(jnp.asarray(bits.astype(np.int32)), batch_shape=())
    y = np.asarray(y).astype(np.complex64)
    # amplitude ramp over the first/last m symbols (gmskframegen.c:360)
    w = hamming(2 * m * k).astype(np.float32)
    y[: m * k] *= w[: m * k]
    y[-m * k:] *= w[m * k:]
    return y


class GMSKFrameResult(NamedTuple):
    detected: bool
    header_ok: bool
    crc_ok: bool
    header: Optional[np.ndarray]
    payload: Optional[np.ndarray]
    payload_len: int


_TEMPLATES = {}


def _template(k, m, bt):
    key = (k, m, bt)
    if key not in _TEMPLATES:
        mod = gmsk_modulator(k, m, bt)
        bits = np.concatenate([_preamble_bits(),
                               np.zeros(2 * m, np.uint8)])
        y, _ = mod(jnp.asarray(bits.astype(np.int32)), batch_shape=())
        # read the planes back separately
        yr = np.asarray(jnp.real(y))
        yi = np.asarray(jnp.imag(y))
        _TEMPLATES[key] = (yr + 1j * yi).astype(np.complex64)
    return _TEMPLATES[key]


def gmskframesync(x, k: int = 2, m: int = 3, bt: float = 0.5,
                  threshold: float = 0.5) -> GMSKFrameResult:
    """Recover a GMSK frame from a capture buffer."""
    x = np.asarray(x, np.complex64)
    s = _template(k, m, bt)
    det = qdetector_detect(x, s, threshold=threshold, range_bins=2)
    nores = GMSKFrameResult(False, False, False, None, None, 0)
    if not det.detected:
        return nores
    n0 = det.sample_index
    # demodulate from the detected start; CFO folds into a frequency bias
    # the demodulator's matched filter ignores after mixing correction
    t = np.arange(len(x) - n0)
    xa = x[n0:] * np.exp(-1j * (det.dphi_hat * t + det.phi_hat))
    dem = gmsk_demodulator(k, m, bt)
    bits, _ = dem(jnp.asarray(xa), batch_shape=())
    bits = np.asarray(bits)
    # demodulator delay: 2m bits
    bits = bits[2 * m:]
    h_enc_len = packetizer_compute_enc_msg_len(GMSKFRAME_H_USER + 5,
                                               _H_CRC, _H_FEC, "none")
    h_bits = 8 * h_enc_len
    if len(bits) < 63 + h_bits:
        return nores
    h_enc = unscramble_data(pack_bits(bits[63: 63 + h_bits])[:h_enc_len])
    hdr, h_ok = packetizer_decode(h_enc, GMSKFRAME_H_USER + 5, _H_CRC,
                                  _H_FEC, "none")
    q = GMSKFRAME_H_USER
    if not h_ok or hdr[q] != _VERSION:
        return GMSKFrameResult(True, False, False, None, None, 0)
    n_payload = (int(hdr[q + 1]) << 8) | int(hdr[q + 2])
    try:
        crc = crc_from_wire((int(hdr[q + 3]) >> 5) & 0x07)
        fec0 = fec_from_wire(int(hdr[q + 3]) & 0x1F)
        fec1 = fec_from_wire(int(hdr[q + 4]) & 0x1F)
    except ValueError:
        return GMSKFrameResult(True, False, False, None, None, 0)
    p_enc_len = packetizer_compute_enc_msg_len(n_payload, crc, fec0, fec1)
    p_bits = 8 * p_enc_len
    if len(bits) < 63 + h_bits + p_bits:
        return GMSKFrameResult(True, True, False, hdr[:q], None, n_payload)
    p_enc = pack_bits(bits[63 + h_bits: 63 + h_bits + p_bits])[:p_enc_len]
    payload, ok = packetizer_decode(p_enc, n_payload, crc, fec0, fec1)
    return GMSKFrameResult(True, True, bool(ok), hdr[:q], payload,
                           n_payload)


# ---------------------------------------------------------------------------
# Streaming multi-frame receiver
# ---------------------------------------------------------------------------
#
# Two-stage design like FlexFrameSync (flexframe.py): stage 1 is the
# shared detect-everywhere detector Proc on device (detector_stream —
# the qdetector front half without a linear-MF back end, since GMSK
# demodulates by phase derivative, not matched filtering of symbols);
# stage 2 demodulates each candidate's bit span in a bucketed jit and
# decodes header/payload bytes on host, firing the reference's
# callback-per-frame contract (reference gmskframesync.c execute loop).

from functools import partial
import jax
from jax import lax
from typing import Callable
from .stream_rx import detector_stream, STREAM_HIST


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _gmsk_demod_span(n_bits: int, k: int, m: int, bt: float,
                     soft: bool, win, dphi, phi):
    """Mix a raw window starting at the frame start and demodulate
    n_bits GMSK bits (identical math to the one-shot path); soft=True
    returns the pre-slice matched-filter metrics (positive = bit 1)."""
    t = jnp.arange(win.shape[-1], dtype=jnp.float32)
    ph = dphi * t + phi
    xa = win * lax.complex(jnp.cos(ph), -jnp.sin(ph))
    dem = gmsk_demodulator(k, m, bt, soft=soft)
    bits, _ = dem.apply(dem.params, dem.init(batch_shape=()), xa)
    return bits[2 * m: 2 * m + n_bits]      # drop the demod delay


class GMSKFrameSync:
    """Streaming multi-frame GMSK receiver with the callback contract
    (the reference gmskframesync object: create/execute/callback,
    reference gmskframesync.c:72-113).  Feed arbitrary-length sample
    arrays via execute(); the callback fires once per decoded frame
    with (header, header_ok, payload, payload_ok, stats)."""

    _PAD = 64

    def __init__(self, callback: Optional[Callable] = None,
                 k: int = 2, m: int = 3, bt: float = 0.5,
                 block_len: int = 4096, threshold: float = 0.5,
                 max_frames: int = 4):
        self.callback = callback
        self._k, self._m, self._bt = int(k), int(m), float(bt)
        self.block_len = int(block_len)
        tpl = _template(k, m, bt)
        self._proc = detector_stream(self.block_len, tpl,
                                     threshold=threshold,
                                     max_frames=max_frames,
                                     suppress_span=len(tpl) - 8)
        self._carry = self._proc.init()
        self._jit = jax.jit(self._proc.apply)
        self._h_enc_len = packetizer_compute_enc_msg_len(
            GMSKFRAME_H_USER + 5, _H_CRC, _H_FEC, "none")
        self._h_bits = 8 * self._h_enc_len
        self._pending = np.zeros(0, np.complex64)
        self._ring = np.zeros(0, np.complex64)
        self._ring_base = 0
        self._abs_fed = 0
        self._cands: list = []
        self._armed_until = -(1 << 60)
        self.frames: list = []
        self.num_frames_detected = 0
        self._dev_fec_cache: dict = {}

    def _device_decoder(self, n_payload, crc, fec0, fec1):
        """Cached device soft decoder for a qualifying payload config
        (fec0 none + block outer code, fec/device.py); None otherwise.
        GMSK feeds raw matched-filter metrics, so this uses the
        LLR-input packetizer variant (no modem stage)."""
        key = (n_payload, crc, fec0, fec1)
        if key not in self._dev_fec_cache:
            try:
                from ..fec.device import (packetizer_soft_decoder,
                                          device_packet_finish)
                dfn, fin = packetizer_soft_decoder(n_payload, crc, fec0,
                                                   fec1)
                try:
                    dev_fin = device_packet_finish(n_payload, crc,
                                                   fec0, fec1)
                    jc = jax.jit(lambda x, d=dfn, f=dev_fin: f(d(x)))

                    def decode(x, _jc=jc):
                        b, ok = _jc(jnp.asarray(x))
                        return np.asarray(b).astype(np.uint8), \
                            bool(np.asarray(ok))
                except ValueError:
                    jd = jax.jit(dfn)

                    def decode(x, _jd=jd, _fin=fin):
                        b, ok = _fin(np.asarray(_jd(jnp.asarray(x))))
                        return b, bool(ok)
                self._dev_fec_cache[key] = decode
            except ValueError:
                self._dev_fec_cache[key] = None
        return self._dev_fec_cache[key]

    # -- sample ingestion ----------------------------------------------
    def execute(self, x):
        self._pending = np.concatenate(
            [self._pending, np.asarray(x, np.complex64)])
        results = []
        while len(self._pending) >= self.block_len:
            blk = self._pending[:self.block_len]
            self._pending = self._pending[self.block_len:]
            self._ring = np.concatenate([self._ring, blk])
            self._abs_fed += self.block_len
            out, self._carry = self._jit((), self._carry, jnp.asarray(blk))
            self._collect(out)
            results.extend(self._drain())
            self._trim()
        return results

    def flush(self):
        tail = int(np.ceil((STREAM_HIST + self.block_len) / self.block_len))
        pad = (-len(self._pending)) % self.block_len + tail * self.block_len
        out = self.execute(np.zeros(pad, np.complex64))
        out.extend(self._drain(final=True))
        return out

    # -- internals ------------------------------------------------------
    def _collect(self, out):
        o = jax.tree_util.tree_map(np.asarray, out)
        for p in range(len(o.valid)):
            if not o.valid[p]:
                continue
            self._cands.append({
                "n0": int(o.sample_index[p]), "rxy": float(o.rxy[p]),
                "gamma": float(o.gamma[p]), "dphi": float(o.dphi[p]),
                "phi": float(o.phi[p]), "hdr": None})
        self._cands.sort(key=lambda c: c["n0"])

    def _demod_bits(self, c, n_bits: int, soft: bool = False) -> np.ndarray:
        """Demodulate frame bits [0, n_bits) for a candidate from the
        raw ring (bucketed static shapes: one compile per bucket)."""
        k, m = self._k, self._m
        bucket = max(256, 1 << int(np.ceil(np.log2(n_bits))))
        n_win = k * (bucket + 2 * m) + self._PAD
        i0 = c["n0"] - self._ring_base
        win = np.zeros(n_win, np.complex64)
        s0, s1 = max(i0, 0), min(i0 + n_win, len(self._ring))
        if s1 > s0:
            win[s0 - i0: s1 - i0] = self._ring[s0:s1]
        bits = _gmsk_demod_span(bucket, k, m, self._bt, soft,
                                jnp.asarray(win),
                                jnp.float32(c["dphi"]),
                                jnp.float32(c["phi"]))
        return np.asarray(bits)[:n_bits]

    def _header_decode(self, c):
        bits = self._demod_bits(c, 63 + self._h_bits)
        h_enc = unscramble_data(
            pack_bits(bits[63: 63 + self._h_bits])[: self._h_enc_len])
        hdr, h_ok = packetizer_decode(h_enc, GMSKFRAME_H_USER + 5,
                                      _H_CRC, _H_FEC, "none")
        geom = None
        q = GMSKFRAME_H_USER
        if h_ok and hdr[q] == _VERSION:
            n_payload = (int(hdr[q + 1]) << 8) | int(hdr[q + 2])
            try:
                crc = crc_from_wire((int(hdr[q + 3]) >> 5) & 0x07)
                fec0 = fec_from_wire(int(hdr[q + 3]) & 0x1F)
                fec1 = fec_from_wire(int(hdr[q + 4]) & 0x1F)
                p_enc_len = packetizer_compute_enc_msg_len(
                    n_payload, crc, fec0, fec1)
                geom = (n_payload, crc, fec0, fec1, p_enc_len)
            except (ValueError, KeyError):
                h_ok = False
        else:
            h_ok = False
        c["hdr"] = (hdr if hdr is not None else None, h_ok, geom)

    def _drain(self, final: bool = False):
        k, m = self._k, self._m
        res = []
        while self._cands:
            c = self._cands[0]
            if c["n0"] < self._armed_until:
                self._cands.pop(0)
                continue
            hdr_end = c["n0"] + k * (63 + self._h_bits + 4 * m) + self._PAD
            if hdr_end > self._abs_fed and not final:
                break
            if c["hdr"] is None:
                self._header_decode(c)
            hdr, h_ok, geom = c["hdr"]
            if not h_ok:
                self._cands.pop(0)
                self.num_frames_detected += 1
                self._armed_until = c["n0"] + k * (63 + self._h_bits)
                frame = (None if hdr is None else hdr[:GMSKFRAME_H_USER],
                         False, None, False, self._stats(c, 0))
                self._emit(frame)
                res.append(frame)
                continue
            n_payload, crc, fec0, fec1, p_enc_len = geom
            p_bits = 8 * p_enc_len
            total_bits = 63 + self._h_bits + p_bits
            end_abs = c["n0"] + k * (total_bits + 4 * m) + self._PAD
            if end_abs > self._abs_fed and not final:
                break
            self._cands.pop(0)
            self.num_frames_detected += 1
            dev = self._device_decoder(n_payload, crc, fec0, fec1)
            if dev is not None:
                # soft path: the GMSK matched-filter metrics feed the
                # device block decoder directly (fec/device.py) — the
                # payload is not scrambled, so no LLR sign-flip needed
                soft = self._demod_bits(c, total_bits, soft=True)
                p_llr = soft[63 + self._h_bits: total_bits]
                payload_full, ok = dev(p_llr)
                payload, ok = payload_full[:n_payload], bool(ok)
            else:
                bits = self._demod_bits(c, total_bits)
                p_enc = pack_bits(
                    bits[63 + self._h_bits: total_bits])[:p_enc_len]
                payload, ok = packetizer_decode(p_enc, n_payload, crc,
                                                fec0, fec1)
            self._armed_until = c["n0"] + k * total_bits - 8
            frame = (hdr[:GMSKFRAME_H_USER].copy(), True, payload,
                     bool(ok), self._stats(c, n_payload))
            self._emit(frame)
            res.append(frame)
        return res

    def _stats(self, c, n_payload):
        return {"rxy": c["rxy"],
                "rssi_db": float(20 * np.log10(max(c["gamma"], 1e-12))),
                "cfo": c["dphi"], "sample_index": c["n0"],
                "payload_len": n_payload}

    def _emit(self, frame):
        self.frames.append(frame)
        if self.callback is not None:
            self.callback(*frame)

    def _trim(self):
        keep_from = self._abs_fed - STREAM_HIST - self.block_len
        if self._cands:
            keep_from = min(keep_from, self._cands[0]["n0"] - self._PAD)
        cut = keep_from - self._ring_base
        if cut > 0:
            self._ring = self._ring[cut:]
            self._ring_base += cut


class GMSKStreamBlock(NamedTuple):
    """Full-device fixed-config GMSK RX result per block; leading axis
    = candidate slot."""
    valid: jnp.ndarray        # [..., P] bool
    sample_index: jnp.ndarray # [..., P] int32
    rxy: jnp.ndarray          # [..., P] detection correlation
    hdr_bytes: jnp.ndarray    # [..., P, 13] int32 decoded header
    hdr_ok: jnp.ndarray       # [..., P] bool CRC + config field check
    pay_bytes: jnp.ndarray    # [..., P, payload_len] int32
    pay_ok: jnp.ndarray       # [..., P] bool payload CRC


def gmskframe_rx_stream(block_len: int, payload_len: int,
                        crc: str = "crc32", fec0: str = "none",
                        fec1: str = "golay2412",
                        k: int = 2, m: int = 3, bt: float = 0.5,
                        threshold: float = 0.5,
                        max_frames: int = 4) -> Proc:
    """FULL-device streaming GMSK receiver for one payload
    configuration: one jitted block step runs detect-everywhere +
    refine, per-candidate window extraction, batched GMSK
    phase-derivative demodulation (soft matched-filter metrics),
    descrambled header decode (hamming128 codebook matmul), payload
    soft decode, and byte pack + CRC — only the user callback is host
    work.  Arbitrary per-frame configs stay with the host-loop
    GMSKFrameSync.  Reference analog: gmskframesync.c:72-113 runs the
    same stages per-sample on the CPU.

    Detections lag the newest input by >= the frame span (the
    detector_stream hist override), so every emitted candidate's full
    frame window is already in the sample buffer — the same structural
    latency as the other streaming receivers."""
    from ..core import Proc
    from .stream_rx import (_detect_consts, _detect_refine,
                            _advance_watermark, _DET_HOP, STREAM_HIST,
                            batched_apply)
    from ..fec.device import packetizer_soft_decoder, \
        conv_packet_soft_decoder, device_packet_finish
    from ..utils.random import _MASKS
    from jax import lax

    T = int(block_len)
    P = int(max_frames)
    tpl = _template(k, m, bt)
    h_enc_len = packetizer_compute_enc_msg_len(
        GMSKFRAME_H_USER + 5, _H_CRC, _H_FEC, "none")
    h_bits = 8 * h_enc_len
    p_enc_len = packetizer_compute_enc_msg_len(payload_len, crc, fec0,
                                               fec1)
    p_bits = 8 * p_enc_len
    total_bits = 63 + h_bits + p_bits
    PAD = 64
    n_win = k * (total_bits + 2 * m) + PAD
    hist = -(-max(STREAM_HIST, n_win + 64) // _DET_HOP) * _DET_HOP
    if T % _DET_HOP != 0:
        raise ValueError(f"block_len must be a multiple of {_DET_HOP}")
    dc = _detect_consts(tpl)
    span = k * total_bits - 8
    starts = (np.arange(T // _DET_HOP + 1) * _DET_HOP).astype(np.int32)

    hdr_dfn, _ = packetizer_soft_decoder(GMSKFRAME_H_USER + 5, _H_CRC,
                                         "none", _H_FEC)
    hdr_fin = device_packet_finish(GMSKFRAME_H_USER + 5, _H_CRC,
                                   "none", _H_FEC)
    scr_sign = (1.0 - 2.0 * np.unpackbits(
        np.resize(_MASKS, h_enc_len))).astype(np.float32)
    try:
        pay_dfn, _ = packetizer_soft_decoder(payload_len, crc, fec0,
                                             fec1)
    except ValueError:
        pay_dfn, _ = conv_packet_soft_decoder(payload_len, crc, fec0,
                                              fec1)
    pay_fin = device_packet_finish(payload_len, crc, fec0, fec1)
    q = GMSKFRAME_H_USER
    _exp = {q + 0: _VERSION,
            q + 1: (payload_len >> 8) & 0xFF,
            q + 2: payload_len & 0xFF,
            q + 3: ((crc_to_wire(crc) & 0x07) << 5) |
                   (fec_to_wire(fec0) & 0x1F),
            q + 4: fec_to_wire(fec1) & 0x1F}
    exp_idx = np.asarray(sorted(_exp), np.int32)
    exp_val = np.asarray([_exp[i] for i in sorted(_exp)], np.int32)
    from ..design.firdes import firdes_gmskrx
    hr_np = firdes_gmskrx(k, m, bt).astype(np.float32)
    hr_np = hr_np / np.sum(np.abs(hr_np))     # gmsk_demodulator scaling
    pre_sign = (2.0 * _preamble_bits().astype(np.float32) - 1.0)

    def init(batch_shape=(), dtype=jnp.complex64):
        return {"buf": jnp.zeros(batch_shape + (hist,), jnp.complex64),
                "base": jnp.full(batch_shape, -hist, jnp.int32),
                "last_end": jnp.full(batch_shape, -(1 << 30), jnp.int32)}

    def _apply_1d(carry, x):
        buf = jnp.concatenate([carry["buf"], x.astype(jnp.complex64)],
                              axis=-1)
        det = _detect_refine(buf, carry["last_end"], dc, threshold, P,
                             T, starts, span, front_pad=0,
                             win_len=n_win)
        win = det["win"]                      # [P, 2, n_win] planes
        wc = lax.complex(win[:, 0], win[:, 1])
        # batched carrier mix + GMSK phase-derivative matched filter.
        # BOTH k=2 decimation phases come from the ONE filter run; the
        # detector's integer n0 can land a sample early at the tau ~
        # 0.5 boundary (half a bit at k=2), which garbles the fixed
        # phase — select per candidate by preamble correlation against
        # the known 63-bit sequence (costs one slice + a tiny reduce;
        # the host-loop receiver loses those frames outright)
        t = jnp.arange(n_win, dtype=jnp.float32)
        ph = det["dphi"][:, None] * t[None, :] + det["phi"][:, None]
        xa = wc * lax.complex(jnp.cos(ph), -jnp.sin(ph))
        prevs = jnp.concatenate([jnp.zeros_like(xa[..., :1]),
                                 xa[..., :-1]], axis=-1)
        phi_d = jnp.angle(jnp.conj(prevs) * xa + 1e-20)
        from ..ops.fir import fir_apply_auto
        d, _ = fir_apply_auto(jnp.asarray(hr_np),
                              jnp.zeros((P, len(hr_np) - 1),
                                        jnp.float32), phi_d)
        nb2 = n_win // k
        ph0 = d[..., 0::k][..., :nb2]
        ph1 = d[..., 1::k][..., :nb2]
        pre = jnp.asarray(pre_sign)
        s0 = jnp.einsum("pj,j->p", ph0[..., 2 * m: 2 * m + 63], pre)
        s1 = jnp.einsum("pj,j->p", ph1[..., 2 * m: 2 * m + 63], pre)
        soft = jnp.where((s1 > s0)[:, None], ph1, ph0)
        soft = soft[..., 2 * m: 2 * m + total_bits]
        llr_h = soft[..., 63: 63 + h_bits] * jnp.asarray(scr_sign)
        hdr_bytes, h_crc_ok = hdr_fin(hdr_dfn(llr_h))
        hdr_ok = h_crc_ok & jnp.all(
            hdr_bytes[..., jnp.asarray(exp_idx)] == jnp.asarray(exp_val),
            axis=-1)
        pay_bytes, pay_ok = pay_fin(
            pay_dfn(soft[..., 63 + h_bits: total_bits]))
        out = GMSKStreamBlock(
            valid=det["valid"],
            sample_index=carry["base"] + det["n0"].astype(jnp.int32),
            rxy=det["peak"], hdr_bytes=hdr_bytes, hdr_ok=hdr_ok,
            pay_bytes=pay_bytes, pay_ok=pay_ok)
        new_carry = {"buf": buf[..., T:], "base": carry["base"] + T,
                     "last_end": _advance_watermark(carry, det, span, T)}
        return out, new_carry

    apply = batched_apply(_apply_1d, T)

    return Proc(params=(), init=init, apply=apply, rate=(1, 1),
                name="gmskframe_rx_stream")
