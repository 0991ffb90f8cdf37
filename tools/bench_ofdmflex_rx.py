#!/usr/bin/env python
"""Throughput of the FULL OFDM flexframe RX chain on device — S0
detect-everywhere, S1 sync + channel EQ, per-symbol pilot tracking,
header Golay decode AND payload block-FEC decode all inside one jitted
step (framing/ofdmflex_stream.py); only byte pack + CRC stay host.

Methodology matches bench.py / bench_frame64_rx.py: real frames in the
stream, K blocks chained in-jit with the streaming carry flowing, a
checksum of the decoded MESSAGE INDICES folded through every trial,
host value readback in the timed region, two-point dt(2n)-dt(n)
calibration.  A correctness pass first verifies every embedded frame
decodes (header + payload CRC on host).

Prints one JSON line:
  {"metric": "ofdmflex_stream_full_rx", "msps": ..., "batch": B,
   "block": T, "k_blocks": K, "frames": N, "decoded": N}
"""
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

PAYLOAD_LEN = 64


def main():
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.framing.ofdmflex_stream import ofdmflex_rx_stream
    from liquid_dsp_tpu.fec.device import (packetizer_soft_decoder,
                                           qpacket_soft_decoder)

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
    K = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    proc = ofdmflex_rx_stream(T, PAYLOAD_LEN)
    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)

    def _generate():
        """The capture, built on the host in this process."""
        from liquid_dsp_tpu.framing.ofdmflexframe import ofdmflexframegen
        n = PAYLOAD_LEN
        rng = np.random.default_rng(0)
        x = np.zeros((K, batch, T), np.complex64)
        hdrs, pls, cnt = [], [], 0
        for k in range(K):
            for b in range(batch):
                h = rng.integers(0, 256, 8).astype(np.uint8)
                p = rng.integers(0, 256, n).astype(np.uint8)
                f = ofdmflexframegen(h, p)
                s0 = int(rng.integers(64, T - len(f) - 64))
                x[k, b, s0:s0 + len(f)] += f
                hdrs.append(h); pls.append(p); cnt += 1
        x += (0.01 * (rng.standard_normal(x.shape) +
                      1j * rng.standard_normal(x.shape))).astype(np.complex64)
        return x, np.stack(hdrs), np.stack(pls)

    x, hdrs, pls = _generate()

    xr = jnp.asarray(x.real.copy())          # [K, B, T] planar host I/O
    xi = jnp.asarray(x.imag.copy())
    carry0 = jax.jit(lambda: proc.init(batch_shape=(batch,)))()

    # ---- correctness pass: every embedded frame must decode ----
    step1 = jax.jit(lambda c, r, i: proc.apply((), c, jax.lax.complex(r, i)))
    _, hfin = packetizer_soft_decoder(14, "crc32", "none", "golay2412")
    _, pfin = qpacket_soft_decoder(PAYLOAD_LEN, "crc32", "none",
                                   "golay2412", "qpsk")
    c = carry0
    got = {}
    zr = jnp.zeros_like(xr[0])
    # one zero flush block after the capture: the streaming receiver
    # emits a frame one block AFTER its samples arrive (the emit window
    # is the history region), so frames near the end of the last block
    # need it — structural latency, not a decode failure
    for k in range(K + 1):
        out, c = (step1(c, xr[k], xi[k]) if k < K else step1(c, zr, zr))
        v = np.asarray(out.valid)
        hm = np.asarray(out.hdr_msgs)
        pm = np.asarray(out.pay_msgs)
        for b in range(batch):
            for s in np.nonzero(v[b])[0]:
                hdr, hok = hfin(hm[b, s])
                pl, pok = pfin(pm[b, s])
                if hok and pok:
                    got[(bytes(hdr[:8]), bytes(pl))] = True
    sent = {(bytes(hdrs[i]), bytes(pls[i])): True for i in range(len(hdrs))}
    decoded = sum(1 for key in sent if key in got)
    print(f"decoded {decoded}/{len(sent)} embedded frames",
          file=sys.stderr)

    # ---- timed path: K blocks chained in ONE jit via lax.scan ----
    @jax.jit
    def step(c, r, i):
        def body(cc, ri):
            out, c2 = proc.apply((), cc, jax.lax.complex(ri[0], ri[1]))
            s = (jnp.sum(out.hdr_msgs.astype(jnp.float32)) +
                 jnp.sum(out.pay_msgs.astype(jnp.float32)) +
                 jnp.sum(out.rxy))
            return c2, s
        c2, ss = jax.lax.scan(body, c, (r, i))
        return c2, jnp.sum(ss)

    c, chk = step(carry0, xr, xi)
    float(np.asarray(chk))  # value readback (warmup/compile)

    def run_trials(n):
        t0 = time.perf_counter()
        c, chk = carry0, None
        for _ in range(n):
            c, chk = step(c, xr, xi)
        float(np.asarray(chk))  # value readback: proves completion
        return time.perf_counter() - t0

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod",
        pathlib.Path(__file__).resolve().parent.parent / "bench.py")
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)
    msps = bm.timed_throughput(run_trials, K * batch * T) / 1e6

    print(json.dumps({"metric": "ofdmflex_stream_full_rx",
                      "msps": round(msps, 2), "batch": batch, "block": T,
                      "k_blocks": K, "frames": len(sent),
                      "decoded": decoded}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
