"""framegen64 / framesync64: the fixed 8+64-byte frame PHY pair.

Reference analogs (studied, not copied):
  * framegen64  — src/framing/src/framegen64.c:38-172: 64-symbol BPSK-
    quadrature m-sequence preamble (msequence(7,0x0089,1)), qpacketmodem
    (72B -> 600 QPSK symbols via CRC-24 + Golay(24,12)), qpilotgen
    (600 -> 630 symbols, spacing 21), ARKAISER k=2 m=7 beta=0.3 pulse
    interpolation -> exactly LIQUID_FRAME64_LEN = 1440 samples.
  * framesync64 — src/framing/src/framesync64.c:66-430: qdetector ->
    mixer/matched-filter/decimate -> qpilotsync -> qpacketmodem decode.

Design (SURVEY.md §7): the receiver is a block pipeline — detect the
preamble anywhere in the capture with one batched FFT cross-correlation,
then mix/filter/sample the aligned window with gathers (no per-sample
state machine).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core import Proc
from ..design.firdes import firdes_arkaiser
from ..utils.sequence import MSequence
from .qpacket import (qpacketmodem_encode, qpacketmodem_decode,
                      qpilot_pilots, qpilotgen, qpilotsync)
from .detector import qdetector_detect

__all__ = ["FRAME64_LEN", "framegen64", "framesync64", "Frame64Result",
           "frame64_preamble", "framesync64_stream", "Framesync64"]

FRAME64_LEN = 1440
_K = 2          # samples/symbol
_M = 7          # filter semi-length (symbols)
_BETA = 0.3     # excess bandwidth
_NPFB = 32      # matched-filter bank resolution


def frame64_preamble() -> np.ndarray:
    """64-symbol p/n preamble (reference framegen64.c:60-66)."""
    ms = MSequence(7, 0x0089, 1)
    out = np.zeros(64, np.complex64)
    s2 = np.sqrt(0.5)
    for i in range(64):
        # NOTE: the reference's two msequence_advance() calls sit in one
        # expression (framegen64.c:62-63) whose evaluation order is
        # unspecified in C; the shipped builds evaluate the imaginary
        # operand first, so the first bit maps to Q, the second to I.
        im = s2 if ms.advance() else -s2
        re = s2 if ms.advance() else -s2
        out[i] = re + 1j * im
    return out


def _interp_taps() -> np.ndarray:
    return firdes_arkaiser(_K, _M, _BETA).astype(np.float32)


def np_interp2(stream: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """1:2 pulse-shape interpolation in pure numpy (identical to the
    firinterp Proc from zero state).  Frame construction/TX math stays
    host-side, so test and benchmark inputs are built without the
    device."""
    xz = np.zeros(len(stream) * 2, np.complex64)
    xz[::2] = stream
    return np.convolve(xz, taps)[: len(stream) * 2].astype(np.complex64)


def framegen64(header, payload) -> np.ndarray:
    """Generate one frame: 8-byte header + 64-byte payload ->
    1440 complex samples (reference framegen64_execute:130-172)."""
    header = np.asarray(header, np.uint8)
    payload = np.asarray(payload, np.uint8)
    if header.shape != (8,) or payload.shape != (64,):
        raise ValueError("framegen64 takes an 8-byte header and a "
                         "64-byte payload")
    msg = np.concatenate([header, payload])
    syms = np.asarray(qpacketmodem_encode(
        msg, "crc24", "none", "golay2412", "qpsk"))
    assert len(syms) == 600
    frame_syms = qpilotgen(syms, 21)
    assert len(frame_syms) == 630
    # pulse-shape: preamble + payload + settling zeros
    settle = 2 * _M + 2 + 10
    stream = np.concatenate([frame64_preamble(), frame_syms,
                             np.zeros(settle, np.complex64)])
    y = np_interp2(stream, _interp_taps())
    assert len(y) == FRAME64_LEN
    return y


def _detector_template() -> np.ndarray:
    """Interpolated preamble + filter tail (reference
    qdetector_cccf_create_linear: s_len = k*(64 + 2m))."""
    seq = np.concatenate([frame64_preamble(),
                          np.zeros(2 * _M, np.complex64)])
    return np_interp2(seq, _interp_taps())


def _mf_bank() -> np.ndarray:
    """Polyphase matched-filter bank [npfb, Lb] (reference
    framesync64.c:144: firpfb_crcf_create_rnyquist(ARKAISER, 32, 2, 7))."""
    h = firdes_arkaiser(_K * _NPFB, _M, _BETA).astype(np.float32)
    n = len(h) - 1  # 2*k*npfb*m
    Lb = n // _NPFB  # branch length = 2*k*m
    bank = np.stack([h[b + np.arange(Lb) * _NPFB] for b in range(_NPFB)])
    return bank  # [npfb, Lb]


class Frame64Result(NamedTuple):
    detected: bool
    crc_ok: bool
    header: Optional[np.ndarray]
    payload: Optional[np.ndarray]
    evm_db: float
    rssi_db: float
    cfo: float          # radians/sample
    sample_index: int


_TEMPLATE = None
_BANK = None


def framesync64(x, threshold: float = 0.5) -> Frame64Result:
    """Recover a frame64 from a capture buffer [T] (T >= 1440ish).

    Block pipeline: detect -> mix down -> polyphase matched filter at the
    estimated timing phase, decimated 2:1 -> pilot sync -> packet decode.
    """
    global _TEMPLATE, _BANK
    if _TEMPLATE is None:
        _TEMPLATE = _detector_template()
        _BANK = _mf_bank()
    x = np.asarray(x, np.complex64)
    det = qdetector_detect(x, _TEMPLATE, threshold=threshold, range_bins=2)
    if not det.detected:
        return Frame64Result(False, False, None, None, 0.0, 0.0, 0.0, -1)

    # timing: filterbank index + base offset (framesync64.c:299-306)
    tau = det.tau_hat
    if tau > 0:
        b = int(tau * _NPFB) % _NPFB
        off = 0
    else:
        b = int((1.0 + tau) * _NPFB) % _NPFB
        off = -1
    n0 = det.sample_index

    # number of matched-filter symbol outputs needed:
    # 64 preamble + 2m delay + 630 payload
    n_sym = 64 + 2 * _M + 630
    Lb = _BANK.shape[1]
    taps = _BANK[b][::-1].copy()  # newest-first ordering for the window dot

    # sample instants (2 samples/symbol) relative to template start
    base = n0 + off + 2 * np.arange(n_sym)
    idx = base[:, None] + np.arange(Lb)[None, :] - (Lb - 1)
    pad = Lb
    xp = np.concatenate([np.zeros(pad, np.complex64), x,
                         np.zeros(2 * n_sym + pad, np.complex64)])
    # mix down with detector estimates (phase referenced to template start)
    t_idx = idx + pad
    win = xp[t_idx]                                     # [n_sym, Lb]
    tt = (idx - n0).astype(np.float32)
    mix = np.exp(-1j * (det.dphi_hat * tt + det.phi_hat)).astype(np.complex64)
    win = win * mix
    sym = win @ taps.astype(np.complex64)
    sym = sym * (0.5 / max(det.gamma_hat, 1e-12))

    payload_rx = sym[64 + 2 * _M: 64 + 2 * _M + 630]
    payload_sym, dphi2, phi2, g2 = qpilotsync(payload_rx, 600, 21)
    payload_bytes, ok = qpacketmodem_decode(
        payload_sym, 72, "crc24", "none", "golay2412", "qpsk")

    # stats: EVM vs nearest QPSK point
    from ..modem import constellation, demodulate, modulate
    table = constellation("qpsk")
    s_hat = demodulate(table, jnp.asarray(payload_sym))
    ref = np.asarray(modulate(table, s_hat))
    evm = np.sqrt(np.mean(np.abs(payload_sym - ref) ** 2))
    evm_db = float(20 * np.log10(evm + 1e-12))
    rssi_db = float(20 * np.log10(max(det.gamma_hat, 1e-12)))
    # cfo is radians/SAMPLE: dphi_hat already is; qpilotsync's dphi2 is
    # radians per payload symbol at k=2 samples/symbol, so rescale
    return Frame64Result(True, bool(ok),
                         payload_bytes[:8].copy(), payload_bytes[8:].copy(),
                         evm_db, rssi_db, float(det.dphi_hat + dphi2 / _K),
                         n0)


# ---------------------------------------------------------------------------
# device-resident streaming multi-frame receiver
# ---------------------------------------------------------------------------
#
# Built on the generic detect-everywhere core in stream_rx.py (see its
# module docstring for the block-pipeline design); frame64 adds only the
# payload extraction, QPSK EVM, and the fixed 630-symbol geometry.
# Everything in `apply` is jittable; byte-domain FEC (Golay/CRC) runs in
# the host-side callback wrapper `Framesync64`, mirroring the reference's
# callback contract (reference src/framing/src/framesync64.c:241-269 —
# the reference also hands decoded bytes to user code; the wire bits
# never need to influence sample-domain control flow).

from .stream_rx import StreamRxConfig, preamble_stream, STREAM_HIST

_HIST = STREAM_HIST           # history samples carried between blocks
_PFFT = 64                    # pilot carrier-estimate FFT (qpilotsync nfft)


class Frame64Block(NamedTuple):
    """Per-block batched detection result: leading axis is the candidate
    slot (fixed max_frames); `valid` masks live slots."""
    valid: jnp.ndarray        # [..., P] bool
    sample_index: jnp.ndarray # [..., P] int32, absolute stream index
    rxy: jnp.ndarray          # [..., P] detection correlation
    cfo: jnp.ndarray          # [..., P] rad/sample (coarse + pilot residual)
    gamma: jnp.ndarray        # [..., P] channel gain
    evm_db: jnp.ndarray       # [..., P] pilot-referenced QPSK EVM (dB)
    symbols: jnp.ndarray      # [..., P, 600] corrected payload symbols


def _stream_cfg() -> StreamRxConfig:
    """The frame64 receiver geometry as a StreamRxConfig (shared with
    the time-sharded receiver, parallel/rx.py)."""
    return StreamRxConfig(
        template=_detector_template(),
        bank=_mf_bank(),
        region_start=64 + 2 * _M,
        region_len=630,
        pilots=qpilot_pilots(600, 21),
        pilot_spacing=21,
        pilot_nfft=_PFFT,
        # small slack for +-1 peak quantization
        suppress_span=FRAME64_LEN - 8,
        k=_K)


def framesync64_stream(block_len: int, threshold: float = 0.5,
                       max_frames: int | None = None,
                       name: str = "framesync64_stream") -> Proc:
    """Streaming multi-frame frame64 receiver as a jittable block Proc.

    apply(params, carry, x[..., block_len]) -> (Frame64Block, carry').
    Every frame whose first sample enters the stream is decoded exactly
    once (in arrival order within each block's slot axis); leading batch
    axes process independent channels via vmap.

    block_len must be a multiple of 256 (the detection segment hop, so
    that the absolute segment grid is block-invariant).
    """
    T = int(block_len)
    P = max_frames if max_frames is not None else T // FRAME64_LEN + 2
    cfg = _stream_cfg()
    core = preamble_stream(T, cfg, threshold=threshold, max_frames=P,
                           name=name)
    data_idx = np.nonzero(np.arange(630) % 21 != 0)[0].astype(np.int32)

    def apply(params, carry, x):
        out, carry = core.apply(params, carry, x)
        syms = jnp.take(out.region_syms, jnp.asarray(data_idx), axis=-1)
        # pilot-referenced stats: EVM vs nearest QPSK point
        s2 = np.float32(np.sqrt(0.5))
        near = lax.complex(jnp.sign(syms.real) * s2, jnp.sign(syms.imag) * s2)
        evm = jnp.sqrt(jnp.mean(jnp.abs(syms - near) ** 2, axis=-1))
        evm_db = 20.0 * jnp.log10(evm + 1e-12)
        return Frame64Block(
            valid=out.valid, sample_index=out.sample_index, rxy=out.rxy,
            cfo=out.dphi + out.dphi2 / _K, gamma=out.gamma, evm_db=evm_db,
            symbols=syms), carry

    return Proc(params=(), init=core.init, apply=apply, rate=(1, 1),
                name=name)


class Frame64FullBlock(NamedTuple):
    """framesync64_stream_full result: detection + IN-STREAM decode."""
    valid: jnp.ndarray        # [..., P] bool
    sample_index: jnp.ndarray # [..., P] int32
    rxy: jnp.ndarray          # [..., P]
    cfo: jnp.ndarray          # [..., P]
    gamma: jnp.ndarray        # [..., P]
    evm_db: jnp.ndarray       # [..., P]
    hdr_bytes: jnp.ndarray    # [..., P, 8] int32 decoded header
    pay_bytes: jnp.ndarray    # [..., P, 64] int32 decoded payload
    crc_ok: jnp.ndarray       # [..., P] bool


def framesync64_stream_full(block_len: int, threshold: float = 0.5,
                            max_frames: int | None = None,
                            name: str = "framesync64_full") -> Proc:
    """framesync64_stream with the payload FEC IN the jitted block step
    (soft Golay codebook decode + byte pack + CRC on device,
    fec/device.py) — the same full-pipeline semantics as the
    flexframe/gmsk/ofdmflex stream receivers; only the user callback
    remains host work.  Reference analog: framesync64.c:411+ decodes
    the payload inline in its state machine."""
    from ..fec.device import qpacket_soft_decoder, device_packet_finish
    core = framesync64_stream(block_len, threshold, max_frames, name)
    dev, _ = qpacket_soft_decoder(72, "crc24", "none", "golay2412",
                                  "qpsk")
    fin = device_packet_finish(72, "crc24", "none", "golay2412")

    def apply(params, carry, x):
        out, c2 = core.apply(params, carry, x)
        buf, ok = fin(dev(out.symbols))
        return Frame64FullBlock(
            valid=out.valid, sample_index=out.sample_index, rxy=out.rxy,
            cfo=out.cfo, gamma=out.gamma, evm_db=out.evm_db,
            hdr_bytes=buf[..., :8], pay_bytes=buf[..., 8:],
            crc_ok=ok), c2

    return Proc(params=(), init=core.init, apply=apply, rate=(1, 1),
                name=name)


class Framesync64:
    """Callback-contract wrapper over the streaming Proc: the analog of
    the reference framesync64 object (create/execute/callback-per-frame,
    reference framesync64.c:66-120).  Feed arbitrary-length sample
    arrays via execute(); the callback fires once per decoded frame with
    (header bytes, header_ok, payload bytes, payload_ok, stats dict).
    Byte-domain FEC (Golay+CRC) runs here on host — sample-domain work
    stays on device in the jitted Proc."""

    def __init__(self, callback: Optional[Callable] = None,
                 block_len: int = 4096, threshold: float = 0.5,
                 device_fec: bool = True):
        self.callback = callback
        self.block_len = int(block_len)
        self._proc = framesync64_stream(self.block_len, threshold)
        self._carry = self._proc.init()
        self._jit = jax.jit(self._proc.apply)
        self._pending = np.zeros(0, np.complex64)
        self.frames: list = []       # decoded results (also returned)
        self.num_frames_detected = 0
        # device_fec: soft Golay decode as a batched matmul over all
        # candidate slots (fec/device.py) — the reference's soft
        # criterion, strictly stronger than hard decode under noise.
        # False falls back to per-frame host hard decode.
        self._device_fec = device_fec
        if device_fec:
            from ..fec.device import (qpacket_soft_decoder,
                                      device_packet_finish)
            dev, _ = qpacket_soft_decoder(
                72, "crc24", "none", "golay2412", "qpsk")
            fin = device_packet_finish(72, "crc24", "none", "golay2412")
            # symbols -> msgs -> bytes + CRC in ONE jitted program: the
            # whole decode (pack + CRC parity matmuls included) on device
            self._fec_jit = jax.jit(lambda s: fin(dev(s)))

    def execute(self, x):
        """Consume samples; fire the callback per decoded frame.  Any
        remainder shorter than block_len is buffered for the next call."""
        self._pending = np.concatenate(
            [self._pending, np.asarray(x, np.complex64)])
        results = []
        while len(self._pending) >= self.block_len:
            blk = self._pending[:self.block_len]
            self._pending = self._pending[self.block_len:]
            out, self._carry = self._jit((), self._carry, jnp.asarray(blk))
            results.extend(self._drain(out))
        return results

    def flush(self):
        """Process buffered samples (zero-padded) plus enough zero blocks
        to flush frames still inside the history window."""
        tail = int(np.ceil((_HIST + self.block_len) / self.block_len))
        pad = (-len(self._pending)) % self.block_len + tail * self.block_len
        return self.execute(np.zeros(pad, np.complex64))

    def _drain(self, out: Frame64Block):
        o = jax.tree_util.tree_map(np.asarray, out)
        res = []
        if self._device_fec and o.valid.any():
            # ONE batched device decode over every candidate slot (the
            # invalid ones are garbage-in, masked out below)
            dec_all, ok_all = self._fec_jit(jnp.asarray(o.symbols))
            dec_all = np.asarray(dec_all).astype(np.uint8)
            ok_all = np.asarray(ok_all)
        for p in range(len(o.valid)):
            if not o.valid[p]:
                continue
            self.num_frames_detected += 1
            if self._device_fec:
                payload_bytes, ok = dec_all[p], ok_all[p]
            else:
                payload_bytes, ok = qpacketmodem_decode(
                    o.symbols[p], 72, "crc24", "none", "golay2412", "qpsk")
            stats = {"rxy": float(o.rxy[p]),
                     "evm_db": float(o.evm_db[p]),
                     "rssi_db": float(20 * np.log10(max(o.gamma[p], 1e-12))),
                     "cfo": float(o.cfo[p]),
                     "sample_index": int(o.sample_index[p])}
            frame = (payload_bytes[:8].copy(), bool(ok),
                     payload_bytes[8:].copy(), bool(ok), stats)
            self.frames.append(frame)
            if self.callback is not None:
                self.callback(*frame)
            res.append(frame)
        return res
