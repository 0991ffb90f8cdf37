#!/usr/bin/env python
"""Conformance replay on the live backend: a representative golden
subset through the device with tolerance checks, so accuracy contracts
are verified on the card — the CPU suite cannot see the card's matmul
precision (an unpinned float32 product may run in TF32 on a GPU).

13 families: firfilt, channelizer, modem, frame64, FFT, iir_block,
crc_finish, ldpc, the flexframe / GMSK / OFDM-flexframe full receivers,
symsync_hoist and symtrack_fused.  Each states its tolerance and the
precision it runs at (FAMILIES below).  Frames are generated in this
process on the host.

    python tools/check_onchip_goldens.py

prints ONE JSON line per family: {"family", "status": "PASS"|"FAIL",
"worst", "tol", "precision"}; exit 0 iff all PASS.  chip_smoke.py runs
the same replay through run_all().
"""
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
GOLDEN = REPO / "tests" / "golden"


def _split(x):
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return (x.real.astype(np.float32).copy(),
                x.imag.astype(np.float32).copy())
    return x.astype(np.float32).copy(), None


def _load(stem):
    d = np.load(GOLDEN / f"{stem}.npz")
    out = {}
    for k in d.files:
        out[k[len(stem) + 1:] if k.startswith(stem + "_") else k] = d[k]
    return out


def check_firfilt(jax, jnp):
    from liquid_dsp_tpu.ops.fir import firfilt
    worst = 0.0
    for stem in ("firfilt_crcf_data_h13x32", "firfilt_rrrf_data_h23x64"):
        d = _load(stem)
        for backend in ("xla", "matmul"):
            q = firfilt(d["h"], backend=backend)
            xr, xi = _split(d["x"])

            @jax.jit
            def run(p, r, i):
                x = jax.lax.complex(r, i) if i is not None else r
                y, _ = q.apply(p, q.init(
                    dtype=jnp.complex64 if i is not None else jnp.float32),
                    x)
                return (jnp.real(y), jnp.imag(y)) if i is not None \
                    else (y, y * 0)

            yr, yi = run(q.params, jnp.asarray(xr),
                         None if xi is None else jnp.asarray(xi))
            got = np.asarray(yr) + 1j * np.asarray(yi)
            worst = max(worst, float(np.abs(got - d["y"]).max()))
    return worst, 1e-3


def check_iir_block(jax, jnp):
    """Block state-space IIR (the GPU policy) vs the reference golden:
    its Toeplitz/Obs/K matmuls are pinned HIGHEST — verify the contract
    holds on the card."""
    from liquid_dsp_tpu.ops.iir import iirfilt
    worst = 0.0
    for stem in ("iirfilt_crcf_data_h5x64", "iirfilt_rrrf_data_h7x64"):
        d = _load(stem)
        q = iirfilt(d["b"], d["a"], backend="block")
        xr, xi = _split(d["x"])

        @jax.jit
        def run(p, r, i):
            cplx = i is not None
            x = jax.lax.complex(r, i) if cplx else r
            y, _ = q.apply(p, q.init(
                dtype=jnp.complex64 if cplx else jnp.float32), x)
            return (jnp.real(y), jnp.imag(y)) if cplx else (y, y * 0)

        yr, yi = run(q.params, jnp.asarray(xr),
                     None if xi is None else jnp.asarray(xi))
        got = np.asarray(yr) + 1j * np.asarray(yi)
        worst = max(worst, float(np.abs(got - d["y"]).max()))
    return worst, 1e-3


def check_crc_finish(jax, jnp):
    """Device byte pack + GF(2) CRC parity matmul vs the host CRC on
    real encoded packets: verdicts must agree bit-for-bit on the card
    (the parity sums are exact small integers only at HIGHEST)."""
    from liquid_dsp_tpu.fec.device import (packetizer_soft_decoder,
                                           device_packet_finish)
    from liquid_dsp_tpu.fec.packetizer import packetizer_encode
    rng = np.random.default_rng(7)
    pl, crc, fec1 = 29, "crc32", "golay2412"
    dfn, fin = packetizer_soft_decoder(pl, crc, "none", fec1)
    dev_fin = device_packet_finish(pl, crc, "none", fec1)
    payloads = rng.integers(0, 256, (4, pl), dtype=np.uint8)
    llr = np.stack([
        2.0 * np.unpackbits(packetizer_encode(row, crc, "none", fec1))
        .astype(np.float32) - 1.0 for row in payloads])
    llr = np.concatenate([llr, -llr], axis=0)     # 4 clean + 4 corrupt
    run = jax.jit(lambda v: dev_fin(dfn(v)))
    pay_d, ok_d = run(jnp.asarray(llr))
    msgs = np.asarray(jax.jit(dfn)(jnp.asarray(llr)))
    pay_h, ok_h = fin(msgs)
    same = (np.asarray(pay_d) == pay_h).all() and \
        (np.asarray(ok_d) == ok_h).all() and ok_h[:4].all()
    return (0.0 if same else 1.0), 0.5


def check_ldpc(jax, jnp):
    """Device BP decoder on the card: compile + decode of 8 noisy
    codewords must recover every codeword."""
    from liquid_dsp_tpu.fec.ldpc import (make_regular_ldpc,
                                         ldpc_encode_systematic,
                                         ldpc_decoder_device)
    rng = np.random.default_rng(5)
    H = make_regular_ldpc(96, 48, col_weight=3, seed=1)  # has w-1 rows
    dec = jax.jit(ldpc_decoder_device(H, max_iters=25, min_sum=True))
    cws, llrs = [], []
    for _ in range(8):
        msg = rng.integers(0, 2, 48).astype(np.uint8)
        cw, _ = ldpc_encode_systematic(H, msg)
        cws.append(cw)
        y = 1.0 - 2.0 * cw + 0.5 * rng.standard_normal(96)
        llrs.append((2 * y / 0.25).astype(np.float32))
    hard, ok = dec(jnp.asarray(np.stack(llrs)))
    good = (np.asarray(hard) == np.stack(cws)).all() and \
        np.asarray(ok).all()
    return (0.0 if good else 1.0), 0.5


def check_channelizer(jax, jnp):
    from liquid_dsp_tpu.multichannel.channelizer import firpfbch2_analyzer
    cg = _load("channelizer_golden")
    worst = 0.0
    for M, m in ((16, 5), (64, 3)):
        x = cg[f"x_{M}_{m}"]
        Yref = cg[f"Y2_{M}_{m}"].reshape(-1, M)
        q = firpfbch2_analyzer(M, m, 60.0)
        xr, xi = _split(x)

        @jax.jit
        def run(p, r, i):
            Y, _ = q.apply(p, q.init(), jax.lax.complex(r, i))
            return jnp.real(Y), jnp.imag(Y)

        yr, yi = run(q.params, jnp.asarray(xr), jnp.asarray(xi))
        got = (np.asarray(yr) + 1j * np.asarray(yi)).T
        worst = max(worst, float(np.abs(got - Yref).max()))
    return worst, 2e-4


def check_modem(jax, jnp):
    from liquid_dsp_tpu.modem.linear import (constellation, modulate,
                                             demodulate, demodulate_soft,
                                             bits_per_symbol)
    rng = np.random.default_rng(3)
    worst = 0.0
    for ms in ("qpsk", "qam16", "qam64", "apsk32", "psk8"):
        table = np.asarray(constellation(ms), np.complex64)
        m = bits_per_symbol(ms)
        syms = rng.integers(0, 1 << m, 4096).astype(np.int32)

        @jax.jit
        def round_trip(s):
            pts = modulate(jnp.asarray(table), s)
            hard = demodulate(jnp.asarray(table), pts)
            llr = demodulate_soft(jnp.asarray(table), pts)
            # soft LLR signs must reproduce the transmitted bits
            soft_bits = (llr > 0).astype(jnp.int32)
            weights = jnp.asarray(
                (1 << np.arange(m - 1, -1, -1)).astype(np.int32))
            soft_syms = jnp.sum(soft_bits * weights, axis=-1)
            return (jnp.sum((hard != s).astype(jnp.int32)),
                    jnp.sum((soft_syms != s).astype(jnp.int32)))

        e_hard, e_soft = round_trip(jnp.asarray(syms))
        worst = max(worst, float(np.asarray(e_hard)),
                    float(np.asarray(e_soft)))
    return worst, 0.5   # zero symbol errors allowed


def check_frame64(jax, jnp):
    from liquid_dsp_tpu.framing.frame64 import framesync64_stream
    from liquid_dsp_tpu.fec.device import qpacket_soft_decoder
    g = _load("frame64_golden")
    frame, header, payload = g["frame"], g["header"], g["payload"]
    T = 4096
    cap = np.zeros(2 * T, np.complex64)
    cap[600:600 + len(frame)] = frame
    rx = framesync64_stream(T, max_frames=2)
    dev, fin = qpacket_soft_decoder(72, "crc24", "none", "golay2412",
                                    "qpsk")
    xr, xi = _split(cap)

    @jax.jit
    def run(r, i):
        c = rx.init()
        out0, c = rx.apply((), c, jax.lax.complex(r[:T], i[:T]))
        out1, c = rx.apply((), c, jax.lax.complex(r[T:], i[T:]))
        msgs0 = dev(out0.symbols)
        msgs1 = dev(out1.symbols)
        return (out0.valid, out1.valid, msgs0, msgs1)

    v0, v1, m0, m1 = run(jnp.asarray(xr), jnp.asarray(xi))
    v = np.concatenate([np.asarray(v0), np.asarray(v1)])
    msgs = np.concatenate([np.asarray(m0), np.asarray(m1)])
    n_dec = int(v.sum())
    if n_dec != 1:
        return float(abs(n_dec - 1)), 0.5
    slot = int(np.nonzero(v)[0][0])
    buf, ok = fin(msgs[slot])
    if not bool(ok):
        return 1.0, 0.5
    got_hdr, got_pay = buf[:8], buf[8:72]
    bad = int((got_hdr != header).sum() + (got_pay != payload).sum())
    return float(bad), 0.5


def _gen_frames(gen, n_hdr, n_pay, n_frames, T, gap=700, **kw):
    """Frames from generator `gen(header, payload, **kw)`, one per row
    of x [n_frames, T] complex64 at offset `gap`, plus noise; returns
    (x, hdrs, pls)."""
    rng = np.random.default_rng(17)
    x = np.zeros((n_frames, T), np.complex64)
    hdrs, pls = [], []
    for i in range(n_frames):
        h = rng.integers(0, 256, n_hdr).astype(np.uint8)
        p = rng.integers(0, 256, n_pay).astype(np.uint8)
        f = np.asarray(gen(h, p, **kw))
        x[i, gap:gap + len(f)] += f
        hdrs.append(h)
        pls.append(p)
    x += (0.004 * (rng.standard_normal(x.shape) +
                   1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return x, np.stack(hdrs), np.stack(pls)


def _check_stream_rx(jax, jnp, proc, x, hdrs, pls, n_hdr, flush=1):
    """Replay frames through a full-device stream RX on the live
    backend; returns #frames whose decoded bytes mismatch (0 = PASS)."""
    T = x.shape[-1]
    c = jax.jit(lambda: proc.init())()
    step = jax.jit(lambda c, r, i: proc.apply(
        (), c, jax.lax.complex(r, i)))
    got = set()
    zr = jnp.zeros(T, jnp.float32)
    for k in range(x.shape[0] + flush):
        if k < x.shape[0]:
            r = jnp.asarray(x[k].real.copy())
            i = jnp.asarray(x[k].imag.copy())
        else:
            r = i = zr
        out, c = step(c, r, i)
        v = np.asarray(out.valid)
        hok = np.asarray(out.hdr_ok)
        pok = np.asarray(out.pay_ok)
        hb = np.asarray(out.hdr_bytes).astype(np.uint8)
        pb = np.asarray(out.pay_bytes).astype(np.uint8)
        for s in np.nonzero(v)[0]:
            if hok[s] and pok[s]:
                got.add((bytes(hb[s, :n_hdr]), bytes(pb[s])))
    bad = sum(1 for i in range(len(hdrs))
              if (bytes(hdrs[i]), bytes(pls[i])) not in got)
    return float(bad)


def check_flexframe_rx(jax, jnp):
    """Full-device flexframe RX decode replay: two-stage header FEC +
    payload decode + device CRC must reproduce the exact sent bytes."""
    from liquid_dsp_tpu.framing.flexframe import (flexframe_rx_stream,
                                                  flexframegen)
    x, hdrs, pls = _gen_frames(flexframegen, 14, 48, 3, 4096)
    proc = flexframe_rx_stream(4096, 48)
    return _check_stream_rx(jax, jnp, proc, x, hdrs, pls, 14), 0.5


def check_gmskframe_rx(jax, jnp):
    """Full-device GMSK RX decode replay."""
    from liquid_dsp_tpu.framing.gmskframe import (gmskframe_rx_stream,
                                                  gmskframegen)
    x, hdrs, pls = _gen_frames(gmskframegen, 8, 40, 3, 4096,
                               fec1="golay2412")
    proc = gmskframe_rx_stream(4096, 40)
    return _check_stream_rx(jax, jnp, proc, x, hdrs, pls, 8), 0.5


def check_ofdmflex_rx(jax, jnp):
    """Full-device OFDM flexframe RX decode replay — covers the
    two-stage S1-search/body-demod extraction path."""
    from liquid_dsp_tpu.framing.ofdmflex_stream import ofdmflex_rx_stream
    from liquid_dsp_tpu.framing.ofdmflexframe import ofdmflexframegen
    x, hdrs, pls = _gen_frames(ofdmflexframegen, 8, 64, 3, 4096)
    proc = ofdmflex_rx_stream(4096, 64)
    return _check_stream_rx(jax, jnp, proc, x, hdrs, pls, 8, flush=2), 0.5


def check_symsync_hoist(jax, jnp):
    """Hoisted-MF symsync (the GPU policy) vs the scan-body
    formulation on the card: same valid pattern, outputs within the
    reassociation tolerance — the hoist moves the MF dots into a HIGHEST
    conv whose GPU lowering the CPU suite cannot see."""
    from liquid_dsp_tpu.ops.symsync import (symsync_banks, symsync_run,
                                            symsync)
    import numpy as np
    rng = np.random.default_rng(31)
    mf, dmf = symsync_banks("arkaiser", 2, 5, 0.3, 32)
    p = symsync("arkaiser", 2, 5, 0.3, bw=0.02)
    B, T = 4, 2048
    xr = rng.standard_normal((B, T)).astype(np.float32)
    xi = rng.standard_normal((B, T)).astype(np.float32)

    import functools

    @functools.partial(jax.jit, static_argnames=("hoist",))
    def run(r, i, hoist):
        x = jax.lax.complex(r, i)
        c0 = p.init((B,))
        y, v, c = symsync_run(mf, dmf, c0, x, 2, bw=0.02, hoist=hoist)
        return jnp.real(y), jnp.imag(y), v

    y1r, y1i, v1 = run(jnp.asarray(xr), jnp.asarray(xi), hoist=False)
    y2r, y2i, v2 = run(jnp.asarray(xr), jnp.asarray(xi), hoist=True)
    if not (np.asarray(v1) == np.asarray(v2)).all():
        return 1.0, 1e-4
    d = np.abs((np.asarray(y1r) - np.asarray(y2r)) +
               1j * (np.asarray(y1i) - np.asarray(y2i))).max()
    return float(d), 1e-4


def check_symtrack_fused(jax, jnp):
    """Fused symtrack (PLL+LMS inside the hoisted symsync scan, the GPU
    policy) vs the sequential two-scan path on the card: same valid
    slots and decisions, symbols within reassociation tolerance."""
    from liquid_dsp_tpu.framing.symtrack import symtrack_stream
    rng = np.random.default_rng(33)
    B, T = 4, 2048
    xr = rng.standard_normal((B, T)).astype(np.float32)
    xi = rng.standard_normal((B, T)).astype(np.float32)
    outs = {}
    for fused in ("0", "1"):
        p = symtrack_stream(fused=fused == "1")

        @jax.jit
        def run(r, i, p=p):
            (y, d, v), c = p.apply((), p.init((B,)),
                                   jax.lax.complex(r, i))
            return jnp.real(y), jnp.imag(y), d, v

        outs[fused] = [np.asarray(a) for a in
                       run(jnp.asarray(xr), jnp.asarray(xi))]
    (ar, ai, ad, av), (br, bi, bd, bv) = outs["0"], outs["1"]
    if not (av == bv).all():
        return 1.0, 1e-3
    m = av
    if (ad[m] != bd[m]).any():
        return 1.0, 1e-3
    d = np.abs((ar - br) + 1j * (ai - bi))[m].max()
    return float(d), 1e-3


def check_fft(jax, jnp):
    from liquid_dsp_tpu.ops.fft import fft
    rng = np.random.default_rng(11)
    worst = 0.0
    for n in (1024, 96, 509):   # radix-2 / 4-step CT / matmul DFT
        batch = max(1, (1 << 16) // n)
        xr = rng.standard_normal((batch, n)).astype(np.float32)
        xi = rng.standard_normal((batch, n)).astype(np.float32)
        y64 = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))

        @jax.jit
        def run(r, i):
            y = fft(jax.lax.complex(r, i))
            return jnp.real(y), jnp.imag(y)

        yr, yi = run(jnp.asarray(xr), jnp.asarray(xi))
        got = np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)
        worst = max(worst, float(np.abs(got - y64).max() /
                                 np.abs(y64).max()))
    return worst, 1e-4


# family: (check, precision the family runs at; its tolerance is the
# check's second return value — an absolute error, or 0.5 on a count of
# wrong symbols / frames / verdicts, i.e. exact)
FAMILIES = {
    "firfilt": (check_firfilt, "XLA conv and banded matmul at HIGHEST; "
                "abs err vs reference golden"),
    "channelizer": (check_channelizer, "fused DFT matmul at HIGHEST; abs "
                    "err vs reference golden"),
    "modem": (check_modem, "one-hot modulate + soft demod; wrong symbols"),
    "frame64": (check_frame64, "stream RX + soft Golay decode; wrong bytes"),
    "fft": (check_fft, "FFT plans; max err / max |X| vs float64"),
    "iir_block": (check_iir_block, "block state-space IIR at HIGHEST; abs "
                  "err vs reference golden"),
    "crc_finish": (check_crc_finish, "device pack + CRC parity matmul at "
                   "HIGHEST; verdicts differing"),
    "ldpc": (check_ldpc, "device min-sum BP; codewords wrong"),
    "flexframe_rx": (check_flexframe_rx, "full device RX; frames wrong"),
    "gmskframe_rx": (check_gmskframe_rx, "full device RX; frames wrong"),
    "ofdmflex_rx": (check_ofdmflex_rx, "full device RX; frames wrong"),
    "symsync_hoist": (check_symsync_hoist, "hoisted vs scan body; abs "
                      "output difference"),
    "symtrack_fused": (check_symtrack_fused, "fused vs two-scan; abs "
                       "symbol difference"),
}


def run_all():
    """Run every family on the live backend; one dict per family."""
    import jax
    import jax.numpy as jnp
    results = []
    for name, (fn, precision) in FAMILIES.items():
        try:
            worst, tol = fn(jax, jnp)
            ok = worst < tol
        except Exception as e:                      # noqa: BLE001
            # one family's exception must not hide the others' results;
            # it is reported as FAIL with its message
            worst, tol, ok = float("nan"), 0.0, False
            precision = f"{precision}; {type(e).__name__}: {str(e)[:300]}"
        results.append({"family": name, "status": "PASS" if ok else "FAIL",
                        "worst": None if worst != worst else worst,
                        "tol": tol, "precision": precision})
    return results


def main():
    import jax
    from liquid_dsp_tpu.platform import enable_compile_cache
    enable_compile_cache()
    print(f"# backend={jax.default_backend()} "
          f"{jax.devices()[0].device_kind}", file=sys.stderr)
    results = run_all()
    for r in results:
        print(json.dumps(r))
    return 0 if all(r["status"] == "PASS" for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
