"""flexframegen / flexframesync: variable-length single-carrier frames
with runtime-configurable payload modulation and FEC.

Reference analogs (studied, not copied): reference src/framing/src/
flexframegen.c:43-400 and flexframesync.c — 64-symbol p/n preamble
(msequence(7,0x0089,1), same as frame64), 20-byte header (14 user +
protocol/length/mod/fec control bytes, flexframegen.c:300-323) coded
with CRC-32 + SEC-DED(72,64) + Hamming(8,4) on QPSK with pilots every
16 symbols (liquid.internal.h:1127-1133), payload coded per runtime
properties, ARKAISER k=2 m=7 beta=0.25 pulse shaping.

Design: same block receiver as frame64 — detect anywhere, gather
matched-filter outputs; the header is decoded first to learn the payload
length/scheme, then the payload symbols are sliced from the same symbol
stream (two-stage block pipeline instead of a per-sample state machine).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..design.firdes import firdes_arkaiser
from .qpacket import (qpacketmodem_encode, qpacketmodem_decode,
                      qpacketmodem_frame_len, qpilotgen, qpilotsync,
                      qpilot_frame_len, qpilot_pilots)
from .frame64 import frame64_preamble, np_interp2
from .detector import qdetector_detect

__all__ = ["flexframegen", "flexframesync", "FlexFrameResult",
           "FLEXFRAME_H_USER", "flexframesync_stream", "FlexFrameSync",
           "flexframe_rx_stream", "FlexStreamBlock"]

_K = 2
_M = 7
_BETA = 0.25
_NPFB = 32
FLEXFRAME_H_USER = 14
_H_CRC, _H_FEC0, _H_FEC1, _H_MOD = "crc32", "secded7264", "hamming84", "qpsk"
_PROTOCOL = 101

from .wire import (crc_to_wire, fec_to_wire, modem_to_wire,
                   crc_from_wire, fec_from_wire, modem_from_wire)


def _header_syms_len():
    n_mod = qpacketmodem_frame_len(FLEXFRAME_H_USER + 6, _H_CRC, _H_FEC0,
                                   _H_FEC1, _H_MOD)
    return qpilot_frame_len(n_mod, 16), n_mod


def _interp_taps():
    return firdes_arkaiser(_K, _M, _BETA).astype(np.float32)


def flexframegen(header, payload, crc: str = "crc32", fec0: str = "none",
                 fec1: str = "golay2412", ms: str = "qpsk") -> np.ndarray:
    """Assemble a frame; returns complex samples at 2 samples/symbol."""
    header = np.asarray(header, np.uint8)
    payload = np.asarray(payload, np.uint8)
    if header.shape != (FLEXFRAME_H_USER,):
        raise ValueError(f"flexframe header must be {FLEXFRAME_H_USER} "
                         f"bytes")
    n = len(payload)
    hdr = np.zeros(FLEXFRAME_H_USER + 6, np.uint8)
    hdr[:FLEXFRAME_H_USER] = header
    # reference wire format (flexframegen.c:300-323): protocol byte,
    # 16-bit payload length, then the reference enum values — mod scheme
    # in one byte, CRC(3 bits)<<5|fec0(5 bits), fec1(5 bits)
    hdr[FLEXFRAME_H_USER + 0] = _PROTOCOL
    hdr[FLEXFRAME_H_USER + 1] = (n >> 8) & 0xFF
    hdr[FLEXFRAME_H_USER + 2] = n & 0xFF
    hdr[FLEXFRAME_H_USER + 3] = modem_to_wire(ms)
    hdr[FLEXFRAME_H_USER + 4] = ((crc_to_wire(crc) & 0x07) << 5) | \
        (fec_to_wire(fec0) & 0x1F)
    hdr[FLEXFRAME_H_USER + 5] = fec_to_wire(fec1) & 0x1F

    h_mod = np.asarray(qpacketmodem_encode(hdr, _H_CRC, _H_FEC0, _H_FEC1,
                                           _H_MOD))
    h_sym = qpilotgen(h_mod, 16)
    p_sym = np.asarray(qpacketmodem_encode(payload, crc, fec0, fec1, ms))

    settle = 2 * _M  # reference tail: 2m zero symbols (flexframegen.c:457)
    stream = np.concatenate([frame64_preamble(), h_sym, p_sym,
                             np.zeros(settle, np.complex64)])
    return np_interp2(stream.astype(np.complex64), _interp_taps())


class FlexFrameResult(NamedTuple):
    detected: bool
    header_ok: bool
    crc_ok: bool
    header: Optional[np.ndarray]
    payload: Optional[np.ndarray]
    ms: str
    payload_len: int
    evm_db: float


_TEMPLATE = None
_BANK = None


def _detector_template():
    seq = np.concatenate([frame64_preamble(),
                          np.zeros(2 * _M, np.complex64)])
    return np_interp2(seq, _interp_taps())


def _mf_bank():
    h = firdes_arkaiser(_K * _NPFB, _M, _BETA).astype(np.float32)
    n = len(h) - 1
    Lb = n // _NPFB
    return np.stack([h[b + np.arange(Lb) * _NPFB] for b in range(_NPFB)])


def _mf_symbols(x, det, n_sym):
    """Matched-filter symbol stream from the aligned capture (same gather
    pipeline as framesync64)."""
    global _BANK
    if _BANK is None:
        _BANK = _mf_bank()
    tau = det.tau_hat
    if tau > 0:
        b = int(tau * _NPFB) % _NPFB
        off = 0
    else:
        b = int((1.0 + tau) * _NPFB) % _NPFB
        off = -1
    n0 = det.sample_index
    Lb = _BANK.shape[1]
    taps = _BANK[b][::-1].astype(np.complex64)
    base = n0 + off + 2 * np.arange(n_sym)
    idx = base[:, None] + np.arange(Lb)[None, :] - (Lb - 1)
    pad = Lb
    xp = np.concatenate([np.zeros(pad, np.complex64), x,
                         np.zeros(2 * n_sym + pad, np.complex64)])
    win = xp[idx + pad]
    tt = (idx - n0).astype(np.float32)
    win = win * np.exp(-1j * (det.dphi_hat * tt + det.phi_hat)
                       ).astype(np.complex64)
    sym = win @ taps
    return sym * (0.5 / max(det.gamma_hat, 1e-12))


def flexframesync(x, threshold: float = 0.5) -> FlexFrameResult:
    """Recover a flexframe from a capture buffer."""
    global _TEMPLATE
    if _TEMPLATE is None:
        _TEMPLATE = _detector_template()
    x = np.asarray(x, np.complex64)
    det = qdetector_detect(x, _TEMPLATE, threshold=threshold, range_bins=2)
    nores = FlexFrameResult(False, False, False, None, None, "", 0, 0.0)
    if not det.detected:
        return nores

    h_sym_len, h_mod_len = _header_syms_len()
    n_lead = 64 + 2 * _M
    # first decode the header
    n_first = n_lead + h_sym_len
    sym = _mf_symbols(x, det, n_first)
    h_rx = sym[n_lead: n_lead + h_sym_len]
    h_mod, dphi2, phi2, g2 = qpilotsync(h_rx, h_mod_len, 16)
    hdr, h_ok = qpacketmodem_decode(h_mod, FLEXFRAME_H_USER + 6, _H_CRC,
                                    _H_FEC0, _H_FEC1, _H_MOD)
    if not h_ok or hdr[FLEXFRAME_H_USER] != _PROTOCOL:
        return FlexFrameResult(True, False, False, None, None, "", 0, 0.0)
    n_payload = (int(hdr[FLEXFRAME_H_USER + 1]) << 8) | \
        int(hdr[FLEXFRAME_H_USER + 2])
    try:
        ms = modem_from_wire(int(hdr[FLEXFRAME_H_USER + 3]))
        crc = crc_from_wire((int(hdr[FLEXFRAME_H_USER + 4]) >> 5) & 0x07)
        fec0 = fec_from_wire(int(hdr[FLEXFRAME_H_USER + 4]) & 0x1F)
        fec1 = fec_from_wire(int(hdr[FLEXFRAME_H_USER + 5]) & 0x1F)
        # frame-length computation raises for wire-valid but unimplemented
        # schemes (e.g. user-defined 'arb' constellations) — report a
        # failed header instead of crashing the receiver
        p_sym_len = qpacketmodem_frame_len(n_payload, crc, fec0, fec1, ms)
    except (ValueError, KeyError):
        return FlexFrameResult(True, False, False, None, None, "", 0, 0.0)
    n_total = n_first + p_sym_len
    sym = _mf_symbols(x, det, n_total)
    # residual carrier from header pilots extends over payload
    i_all = np.arange(p_sym_len) + h_sym_len
    p_rx = sym[n_first: n_total] * np.exp(
        -1j * (dphi2 * i_all + phi2)) / max(g2, 1e-12)
    payload, ok = qpacketmodem_decode(p_rx, n_payload, crc, fec0, fec1, ms)
    from ..modem import constellation, demodulate, modulate
    table = constellation(ms)
    ref = np.asarray(modulate(table, demodulate(table, jnp.asarray(p_rx))))
    evm_db = float(20 * np.log10(np.sqrt(np.mean(np.abs(p_rx - ref) ** 2))
                                 + 1e-12))
    return FlexFrameResult(True, True, bool(ok), hdr[:FLEXFRAME_H_USER],
                           payload, ms, n_payload, evm_db)


# ---------------------------------------------------------------------------
# device-resident streaming multi-frame receiver
# ---------------------------------------------------------------------------
#
# Same detect-everywhere streaming core as framesync64 (stream_rx.py),
# but the payload length is only known after the header decodes
# (reference src/framing/src/flexframesync.c: the rxheader state
# computes payload geometry at runtime).  Two-stage design:
#
#   stage 1 (device, one jit per block): detect + refine + matched-filter
#     the FIXED-length header region, pilot-sync it, emit corrected
#     header symbols + per-candidate channel estimates.
#   stage 2 (host decodes the ~26 header bytes; device gathers the
#     payload): payload symbol count is bucketed to the next power of
#     two so each bucket compiles exactly once; the gather/mix/MF/
#     carrier-correction runs as one batched jit over the raw-sample
#     window the host wrapper retains.
#
# The host wrapper (FlexFrameSync) owns the callback contract and the
# re-arm semantics over the VARIABLE frame span (device-side suppression
# only covers the header span, which is the minimum preamble spacing).

import jax
from jax import lax
from functools import partial

from ..core import Proc
from .stream_rx import (StreamRxConfig, StreamRxBlock, preamble_stream,
                        mf_symbol_gather, STREAM_HIST)


def _n_lead():
    return 64 + 2 * _M


def _pilot_nfft(npil: int) -> int:
    """qpilotsync FFT sizing (reference qpilotsync.c:127)."""
    return 1 << int(np.ceil(np.log2(npil + (npil >> 1))))


def flexframesync_stream(block_len: int, threshold: float = 0.5,
                         max_frames: int = 6,
                         name: str = "flexframesync_stream") -> Proc:
    """Streaming flexframe HEADER-stage receiver as a jittable block Proc.

    apply(params, carry, x[..., block_len]) -> (StreamRxBlock, carry').
    region_syms holds the pilot-corrected header region (pilots still
    in place); feed the non-pilot symbols to qpacketmodem_decode to
    recover the header, then gather the payload with
    flexframe_payload_gather.  block_len must be a multiple of 256.
    """
    h_sym_len, h_mod_len = _header_syms_len()
    pilots = np.asarray(qpilot_pilots(h_mod_len, 16))
    cfg = StreamRxConfig(
        template=_detector_template(),
        bank=_mf_bank(),
        region_start=_n_lead(),
        region_len=h_sym_len,
        pilots=pilots,
        pilot_spacing=16,
        pilot_nfft=_pilot_nfft(len(pilots)),
        # minimum preamble spacing: preamble + header (payload >= 1 sym)
        suppress_span=_K * (64 + h_sym_len) - 8,
        k=_K)
    return preamble_stream(int(block_len), cfg, threshold=threshold,
                           max_frames=max_frames, name=name)


def _flex_stream_common(region: int, suppress_region_syms: int):
    """Shared full-device receiver geometry: detector StreamRxConfig,
    header non-pilot index map, two-stage header decoder, header
    constellation (single source of truth for flexframe_rx_stream AND
    the multi-config variant)."""
    from ..modem.linear import constellation
    from ..fec.device import packetizer2_soft_decoder

    h_sym_len, h_mod_len = _header_syms_len()
    pilots = np.asarray(qpilot_pilots(h_mod_len, 16))
    cfg = StreamRxConfig(
        template=_detector_template(), bank=_mf_bank(),
        region_start=_n_lead(), region_len=region,
        pilots=pilots, pilot_spacing=16,
        pilot_nfft=_pilot_nfft(len(pilots)),
        suppress_span=_K * (64 + suppress_region_syms) - 8, k=_K)
    pil_mask = np.zeros(h_sym_len, bool)
    pil_pos = np.nonzero(np.arange(h_sym_len) % 16 == 0)[0][:len(pilots)]
    pil_mask[pil_pos] = True
    nonpil_idx = np.nonzero(~pil_mask)[0].astype(np.int32)
    assert len(nonpil_idx) == h_mod_len, (len(nonpil_idx), h_mod_len)
    hdr_dec = packetizer2_soft_decoder(FLEXFRAME_H_USER + 6, _H_CRC,
                                       _H_FEC0, _H_FEC1)
    hdr_tab = np.asarray(constellation(_H_MOD), np.complex64)
    return h_sym_len, cfg, nonpil_idx, hdr_dec, hdr_tab


def _exp_header_fields(pl: int, crc: str, fec0: str, fec1: str, ms: str):
    """Expected wire header bytes for one payload config (the static
    compare the device receivers apply after the header CRC)."""
    ku = FLEXFRAME_H_USER
    _exp = {ku + 0: _PROTOCOL,
            ku + 1: (pl >> 8) & 0xFF,
            ku + 2: pl & 0xFF,
            ku + 3: modem_to_wire(ms),
            ku + 4: ((crc_to_wire(crc) & 0x07) << 5) |
                    (fec_to_wire(fec0) & 0x1F),
            ku + 5: fec_to_wire(fec1) & 0x1F}
    exp_idx = np.asarray(sorted(_exp), np.int32)
    exp_val = np.asarray([_exp[i] for i in sorted(_exp)], np.int32)
    return exp_idx, exp_val


class FlexStreamBlock(NamedTuple):
    """Full-device fixed-config flexframe RX result per block; leading
    axis = candidate slot."""
    valid: jnp.ndarray        # [..., P] bool
    sample_index: jnp.ndarray # [..., P] int32
    rxy: jnp.ndarray          # [..., P] detection correlation
    evm_db: jnp.ndarray       # [..., P] pilot-referenced gain proxy
    hdr_bytes: jnp.ndarray    # [..., P, 20] int32 decoded header
    hdr_ok: jnp.ndarray       # [..., P] bool CRC + config field check
    pay_bytes: jnp.ndarray    # [..., P, payload_len] int32
    pay_ok: jnp.ndarray       # [..., P] bool payload CRC


def flexframe_rx_stream(block_len: int, payload_len: int,
                        crc: str = "crc32", fec0: str = "none",
                        fec1: str = "golay2412", ms: str = "qpsk",
                        threshold: float = 0.5,
                        max_frames: int = 4) -> Proc:
    """FULL-device streaming flexframe receiver for one payload
    configuration (the deployed-link case; arbitrary per-frame configs
    stay with the host-loop FlexFrameSync).  One jitted block step runs
    detect-everywhere, refine, mix + polyphase MF, pilot sync, the
    TWO-stage header decode (hamming84 codebook matmul + SECDED
    syndrome-matmul correction, fec/device.packetizer2_soft_decoder),
    payload soft decode, AND byte pack + CRC — only the user callback
    is host work.  Reference analog: flexframesync.c runs the same
    stages per-sample on the CPU.

    The sync REGION covers header + payload (the header-pilot carrier
    correction extends across the payload as a linear phase ramp, the
    same extension the host path's _payload_gather_jit applies)."""
    from ..modem.linear import bits_per_symbol
    from ..fec.packetizer import packetizer_compute_enc_msg_len
    from ..fec.device import (qpacket_soft_decoder,
                              qpacket_conv_soft_decoder,
                              device_packet_finish)
    from .stream_rx import STREAM_HIST

    p_enc = packetizer_compute_enc_msg_len(payload_len, crc, fec0, fec1)
    bps = bits_per_symbol(ms)
    p_syms = -(-8 * p_enc // bps)
    h_sym_len, _hm = _header_syms_len()
    region = h_sym_len + p_syms
    need_hist = _K * (_n_lead() + region) + 2
    h_sym_len, cfg, nonpil_idx, hdr_dec, hdr_tab = _flex_stream_common(
        region, region)
    base = preamble_stream(int(block_len), cfg, threshold=threshold,
                           max_frames=max_frames, name="flexframe_rx",
                           hist=max(STREAM_HIST, need_hist))
    try:
        pay_dfn, _ = qpacket_soft_decoder(payload_len, crc, fec0, fec1,
                                          ms)
    except ValueError:
        pay_dfn, _ = qpacket_conv_soft_decoder(payload_len, crc, fec0,
                                               fec1, ms)
    pay_fin = device_packet_finish(payload_len, crc, fec0, fec1)
    exp_idx, exp_val = _exp_header_fields(payload_len, crc, fec0, fec1,
                                          ms)

    def apply(params, carry, x):
        from ..modem.linear import demodulate_soft
        out, c2 = base.apply(params, carry, x)
        rsy = out.region_syms                     # [..., P, region]
        hdr_syms = rsy[..., :h_sym_len][..., jnp.asarray(nonpil_idx)]
        llr_h = demodulate_soft(jnp.asarray(hdr_tab), hdr_syms)
        llr_h = llr_h.reshape(llr_h.shape[:-2] + (-1,))
        hdr_bytes, h_crc_ok = hdr_dec(llr_h)
        hdr_ok = h_crc_ok & jnp.all(
            hdr_bytes[..., jnp.asarray(exp_idx)] == jnp.asarray(exp_val),
            axis=-1)
        pay_bytes, pay_ok = pay_fin(pay_dfn(rsy[..., h_sym_len:]))
        evm_db = 20.0 * jnp.log10(jnp.maximum(out.g2, 1e-12))
        return FlexStreamBlock(
            valid=out.valid, sample_index=out.sample_index,
            rxy=out.rxy, evm_db=evm_db,
            hdr_bytes=hdr_bytes[..., :FLEXFRAME_H_USER + 6],
            hdr_ok=hdr_ok, pay_bytes=pay_bytes, pay_ok=pay_ok), c2

    return Proc(params=(), init=base.init, apply=apply, rate=(1, 1),
                name="flexframe_rx_stream")


class FlexMultiStreamBlock(NamedTuple):
    """Header-adaptive full-device RX result (registered config set);
    leading axis = candidate slot.  pay_bytes is padded to the LONGEST
    registered payload; cfg_idx selects the matched config (-1 = header
    valid but unregistered, or header CRC failed)."""
    valid: jnp.ndarray        # [..., P] bool
    sample_index: jnp.ndarray # [..., P] int32
    rxy: jnp.ndarray          # [..., P] detection correlation
    evm_db: jnp.ndarray       # [..., P]
    hdr_bytes: jnp.ndarray    # [..., P, 20] int32 decoded header
    hdr_ok: jnp.ndarray       # [..., P] bool CRC + registered config
    cfg_idx: jnp.ndarray      # [..., P] int32 matched config index
    pay_bytes: jnp.ndarray    # [..., P, max_payload_len] int32
    pay_ok: jnp.ndarray       # [..., P] bool payload CRC


def flexframe_rx_stream_multi(block_len: int, configs,
                              threshold: float = 0.5,
                              max_frames: int = 4) -> Proc:
    """HEADER-ADAPTIVE full-device streaming flexframe receiver
    decodes a REGISTERED SET of payload
    configurations in one stream at the full-device rate.  The header
    decodes on device as in flexframe_rx_stream; the payload stage then
    runs EVERY registered config's decoder over the shared synced
    region and one-hot selects the result by the header-announced
    config — compiler-friendly dispatch with static shapes (a traced
    branch per frame cannot live under jit; the decoders are cheap
    codebook matmuls).  Frames announcing an
    unregistered config report hdr_ok=False (cfg_idx=-1), the same
    contract the fixed-config receiver applies to every foreign frame.

    configs: sequence of (payload_len, crc, fec0, fec1, ms) tuples.
    Reference analog: flexframesync.c reconfigures its payload
    demod/FEC from each header at runtime on the host CPU.
    """
    from ..modem.linear import bits_per_symbol
    from ..fec.packetizer import packetizer_compute_enc_msg_len
    from ..fec.device import (qpacket_soft_decoder,
                              qpacket_conv_soft_decoder,
                              device_packet_finish)
    from .stream_rx import STREAM_HIST

    configs = [tuple(c) for c in configs]
    if not configs:
        raise ValueError("need at least one registered config")
    p_syms_list = []
    for (pl, crc, fec0, fec1, ms) in configs:
        p_enc = packetizer_compute_enc_msg_len(pl, crc, fec0, fec1)
        p_syms_list.append(-(-8 * p_enc // bits_per_symbol(ms)))
    p_syms_max = max(p_syms_list)
    max_pl = max(c[0] for c in configs)
    h_sym_len, _hm = _header_syms_len()
    region = h_sym_len + p_syms_max
    need_hist = _K * (_n_lead() + region) + 2
    # re-arm after the SHORTEST registered frame: a longer frame's
    # interior may then admit spurious candidates, which fail the
    # header CRC and only occupy a slot (the reference's re-arm is
    # per-frame exact because it consumes serially)
    h_sym_len, cfg, nonpil_idx, hdr_dec, hdr_tab = _flex_stream_common(
        region, h_sym_len + min(p_syms_list))
    base = preamble_stream(int(block_len), cfg, threshold=threshold,
                           max_frames=max_frames,
                           name="flexframe_rx_multi",
                           hist=max(STREAM_HIST, need_hist))
    # per-config payload decoders + expected header fields
    pay_stages = []
    for j, (pl, crc, fec0, fec1, ms) in enumerate(configs):
        try:
            dfn, _ = qpacket_soft_decoder(pl, crc, fec0, fec1, ms)
        except ValueError:
            dfn, _ = qpacket_conv_soft_decoder(pl, crc, fec0, fec1, ms)
        fin = device_packet_finish(pl, crc, fec0, fec1)
        exp_idx, exp_val = _exp_header_fields(pl, crc, fec0, fec1, ms)
        pay_stages.append((dfn, fin, p_syms_list[j], pl,
                           exp_idx, exp_val))

    def apply(params, carry, x):
        out, c2 = base.apply(params, carry, x)
        rsy = out.region_syms                     # [..., P, region]
        hdr_syms = rsy[..., :h_sym_len][..., jnp.asarray(nonpil_idx)]
        from ..modem.linear import demodulate_soft
        llr_h = demodulate_soft(jnp.asarray(hdr_tab), hdr_syms)
        llr_h = llr_h.reshape(llr_h.shape[:-2] + (-1,))
        hdr_bytes, h_crc_ok = hdr_dec(llr_h)
        lead = hdr_bytes.shape[:-1]
        pay_all = jnp.zeros(lead + (max_pl,), jnp.int32)
        ok_all = jnp.zeros(lead, bool)
        cfg_idx = jnp.full(lead, -1, jnp.int32)
        for j, (dfn, fin, psy, pl, eidx, evval) in enumerate(pay_stages):
            match = h_crc_ok & jnp.all(
                hdr_bytes[..., jnp.asarray(eidx)] == jnp.asarray(evval),
                axis=-1)
            pj, okj = fin(dfn(rsy[..., h_sym_len:h_sym_len + psy]))
            if pl < max_pl:
                pj = jnp.pad(pj, [(0, 0)] * (pj.ndim - 1)
                             + [(0, max_pl - pl)])
            m = match[..., None]
            pay_all = jnp.where(m, pj, pay_all)
            ok_all = jnp.where(match, okj, ok_all)
            cfg_idx = jnp.where(match, j, cfg_idx)
        evm_db = 20.0 * jnp.log10(jnp.maximum(out.g2, 1e-12))
        return FlexMultiStreamBlock(
            valid=out.valid, sample_index=out.sample_index,
            rxy=out.rxy, evm_db=evm_db,
            hdr_bytes=hdr_bytes[..., :FLEXFRAME_H_USER + 6],
            hdr_ok=cfg_idx >= 0, cfg_idx=cfg_idx,
            pay_bytes=pay_all, pay_ok=ok_all), c2

    return Proc(params=(), init=base.init, apply=apply, rate=(1, 1),
                name="flexframe_rx_stream_multi")


@partial(jax.jit, static_argnums=(0, 1))
def _payload_gather_jit(n_sym: int, start_sym: int, x_win, bank,
                        n0, off_s, dphi, phi, gamma, b_idx,
                        dphi2, phi2, g2, h_sym_len):
    """Bucketed payload gather: mix/MF/sample `n_sym` symbols starting at
    frame symbol `start_sym` from a raw-sample window, then extend the
    header-pilot carrier correction across them (one-shot analog:
    flexframesync lines 186-191 above)."""
    sym = mf_symbol_gather(x_win[None, :][0], n0[None], off_s[None],
                           dphi[None], phi[None], gamma[None], bank,
                           b_idx[None], n_sym, start_sym=start_sym)[0]
    i_all = jnp.arange(n_sym, dtype=jnp.float32) + h_sym_len
    ph2 = dphi2 * i_all + phi2
    corr = lax.complex(jnp.cos(ph2), -jnp.sin(ph2)) / jnp.maximum(g2, 1e-12)
    return sym * corr


class FlexFrameSync:
    """Callback-contract wrapper over the streaming Proc: the analog of
    the reference flexframesync object (create/execute/callback-per-
    frame, reference flexframesync.c).  Feed arbitrary-length sample
    arrays via execute(); the callback fires once per frame with
    (header bytes, header_ok, payload bytes, payload_ok, stats dict).
    Sample-domain work runs in two jits (header stage per block; payload
    gather per power-of-two symbol bucket); byte-domain FEC runs here on
    host."""

    _PAD = 64   # raw-window margin around the MF gather (>= Lb)

    def __init__(self, callback=None, block_len: int = 4096,
                 threshold: float = 0.5, max_frames: int = 6):
        self.callback = callback
        self.block_len = int(block_len)
        self._proc = flexframesync_stream(self.block_len, threshold,
                                          max_frames)
        self._carry = self._proc.init()
        self._jit = jax.jit(self._proc.apply)
        self._pending = np.zeros(0, np.complex64)
        self._h_sym_len, self._h_mod_len = _header_syms_len()
        self._n_first = _n_lead() + self._h_sym_len
        self._bank = jnp.asarray(_mf_bank()[:, ::-1].astype(np.float32))
        # raw-sample retention for stage 2: ring with absolute base index
        self._ring = np.zeros(0, np.complex64)
        self._ring_base = 0
        self._abs_fed = 0
        self._cands: list = []     # undecoded candidates (dict of meta)
        self._armed_until = -(1 << 60)
        self.frames: list = []
        self.num_frames_detected = 0
        self._dev_fec_cache: dict = {}

    def _device_decoder(self, n_payload, crc, fec0, fec1, ms):
        """Cached device soft decoder for a qualifying payload config:
        block outer code (codebook matmul) or single conv stage (batched
        soft Viterbi scan) — fec/device.py; None otherwise."""
        key = (n_payload, crc, fec0, fec1, ms)
        if key not in self._dev_fec_cache:
            from ..fec.device import (qpacket_soft_decoder,
                                      qpacket_conv_soft_decoder,
                                      device_packet_finish)
            self._dev_fec_cache[key] = None
            for builder in (qpacket_soft_decoder,
                            qpacket_conv_soft_decoder):
                try:
                    dfn, fin = builder(n_payload, crc, fec0, fec1, ms)
                except ValueError:
                    continue
                try:
                    # byte pack + CRC on device too: one jitted program
                    # symbols -> payload bytes + validity
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
                break
        return self._dev_fec_cache[key]

    def execute(self, x):
        """Consume samples; fire the callback per decoded frame.  Any
        remainder shorter than block_len is buffered for the next call."""
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
        """Process buffered samples (zero-padded) plus enough zero blocks
        to flush frames still inside the history window."""
        tail = int(np.ceil((STREAM_HIST + self.block_len) / self.block_len))
        pad = (-len(self._pending)) % self.block_len + tail * self.block_len
        out = self.execute(np.zeros(pad, np.complex64))
        # stream over: finish any pending candidate with zero-padding
        out.extend(self._drain(final=True))
        return out

    # ---- internals ----

    def _collect(self, out: StreamRxBlock):
        o = jax.tree_util.tree_map(np.asarray, out)
        for p in range(len(o.valid)):
            if not o.valid[p]:
                continue
            self._cands.append({
                "n0": int(o.sample_index[p]), "rxy": float(o.rxy[p]),
                "gamma": float(o.gamma[p]), "dphi": float(o.dphi[p]),
                "phi": float(o.phi[p]), "tau": float(o.tau[p]),
                "b_idx": int(o.b_idx[p]), "off_s": int(o.off_s[p]),
                "dphi2": float(o.dphi2[p]), "phi2": float(o.phi2[p]),
                "g2": float(o.g2[p]), "region": o.region_syms[p],
                "hdr": None})
        self._cands.sort(key=lambda c: c["n0"])

    def _header_decode(self, c):
        region = c["region"]
        mask = np.arange(self._h_sym_len) % 16 == 0
        h_mod = region[~mask][: self._h_mod_len]
        hdr, h_ok = qpacketmodem_decode(h_mod, FLEXFRAME_H_USER + 6,
                                        _H_CRC, _H_FEC0, _H_FEC1, _H_MOD)
        geom = None
        if h_ok and hdr[FLEXFRAME_H_USER] == _PROTOCOL:
            n_payload = (int(hdr[FLEXFRAME_H_USER + 1]) << 8) | \
                int(hdr[FLEXFRAME_H_USER + 2])
            try:
                ms = modem_from_wire(int(hdr[FLEXFRAME_H_USER + 3]))
                crc = crc_from_wire(
                    (int(hdr[FLEXFRAME_H_USER + 4]) >> 5) & 0x07)
                fec0 = fec_from_wire(int(hdr[FLEXFRAME_H_USER + 4]) & 0x1F)
                fec1 = fec_from_wire(int(hdr[FLEXFRAME_H_USER + 5]) & 0x1F)
                p_sym_len = qpacketmodem_frame_len(n_payload, crc, fec0,
                                                   fec1, ms)
                geom = (n_payload, ms, crc, fec0, fec1, p_sym_len)
            except (ValueError, KeyError):
                h_ok = False
        else:
            h_ok = False
        c["hdr"] = (hdr if hdr is not None else None, h_ok, geom)

    def _drain(self, final: bool = False):
        res = []
        while self._cands:
            c = self._cands[0]
            if c["n0"] < self._armed_until:       # inside a decoded frame
                self._cands.pop(0)
                continue
            if c["hdr"] is None:
                self._header_decode(c)
            hdr, h_ok, geom = c["hdr"]
            if not h_ok:
                self._cands.pop(0)
                self.num_frames_detected += 1
                self._armed_until = c["n0"] + _K * (64 + self._h_sym_len)
                frame = (None if hdr is None else hdr[:FLEXFRAME_H_USER],
                         False, None, False, self._stats(c, 0, ""))
                self._emit(frame)
                res.append(frame)
                continue
            n_payload, ms, crc, fec0, fec1, p_sym_len = geom
            end_abs = c["n0"] + _K * (self._n_first + p_sym_len) + self._PAD
            if end_abs > self._abs_fed and not final:
                break                              # wait for more samples
            self._cands.pop(0)
            self.num_frames_detected += 1
            p_rx = self._gather_payload(c, p_sym_len, end_abs)
            dev = self._device_decoder(n_payload, crc, fec0, fec1, ms)
            if dev is not None:
                # soft decode fully ON DEVICE (fec/device.py): LLR +
                # deinterleave-gather + codebook/Viterbi + byte pack +
                # CRC parity matmul.  Strictly stronger than hard
                # decode under noise (the reference's soft criterion).
                payload_full, ok = dev(p_rx)
                payload, ok = payload_full[:n_payload], bool(ok)
            else:
                payload, ok = qpacketmodem_decode(p_rx, n_payload, crc,
                                                  fec0, fec1, ms)
            self._armed_until = c["n0"] + _K * (self._n_first + p_sym_len) - 8
            frame = (hdr[:FLEXFRAME_H_USER].copy(), True, payload, bool(ok),
                     self._stats(c, n_payload, ms, p_rx))
            self._emit(frame)
            res.append(frame)
        return res

    def _gather_payload(self, c, p_sym_len, end_abs):
        bucket = max(64, 1 << int(np.ceil(np.log2(p_sym_len))))
        a0 = c["n0"] - self._PAD
        a1 = c["n0"] + _K * (self._n_first + bucket) + self._PAD
        i0, i1 = a0 - self._ring_base, a1 - self._ring_base
        win = np.zeros(i1 - i0, np.complex64)
        s0, s1 = max(i0, 0), min(i1, len(self._ring))
        if s1 > s0:
            win[s0 - i0: s1 - i0] = self._ring[s0:s1]
        syms = _payload_gather_jit(
            bucket, self._n_first, jnp.asarray(win), self._bank,
            jnp.int32(c["n0"] - a0), jnp.int32(c["off_s"]),
            jnp.float32(c["dphi"]), jnp.float32(c["phi"]),
            jnp.float32(c["gamma"]), jnp.int32(c["b_idx"]),
            jnp.float32(c["dphi2"]), jnp.float32(c["phi2"]),
            jnp.float32(c["g2"]), jnp.float32(self._h_sym_len))
        return np.asarray(syms)[:p_sym_len]

    def _stats(self, c, n_payload, ms, p_rx=None):
        st = {"rxy": c["rxy"],
              "rssi_db": float(20 * np.log10(max(c["gamma"], 1e-12))),
              "cfo": c["dphi"] + c["dphi2"] / _K,
              "sample_index": c["n0"], "payload_len": n_payload, "ms": ms,
              "evm_db": 0.0}
        if p_rx is not None and len(p_rx) and ms:
            from ..modem import constellation, demodulate, modulate
            table = constellation(ms)
            ref = np.asarray(modulate(table, demodulate(
                table, jnp.asarray(p_rx))))
            st["evm_db"] = float(20 * np.log10(
                np.sqrt(np.mean(np.abs(p_rx - ref) ** 2)) + 1e-12))
        return st

    def _emit(self, frame):
        self.frames.append(frame)
        if self.callback is not None:
            self.callback(*frame)

    def _trim(self):
        """Drop ring samples no candidate can still reference."""
        keep_from = self._abs_fed - STREAM_HIST - self.block_len
        if self._cands:
            keep_from = min(keep_from, self._cands[0]["n0"] - self._PAD)
        cut = keep_from - self._ring_base
        if cut > 0:
            self._ring = self._ring[cut:]
            self._ring_base += cut
