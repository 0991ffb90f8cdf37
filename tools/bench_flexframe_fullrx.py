#!/usr/bin/env python
"""Throughput of the FULL fixed-config flexframe RX chain on device —
detect-everywhere, refine, mix + polyphase MF, pilot sync, TWO-stage
header decode (hamming84 codebook + SECDED syndrome matmuls), payload
decode AND byte pack + CRC, all inside one jitted block step
(framing/flexframe.flexframe_rx_stream); only the callback is host.

Methodology matches bench_ofdmflex_rx.py: real frames in the stream,
K blocks chained in-jit with the streaming carry flowing, checksum of
decoded bytes folded through every trial, host value readback, two-
point calibration.  A correctness pass verifies every embedded frame
decodes (header fields + both CRCs, computed on device).

Prints one JSON line:
  {"metric": "flexframe_full_rx", "msps": ..., ...}
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
    from liquid_dsp_tpu.framing.flexframe import flexframe_rx_stream

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
    K = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    proc = flexframe_rx_stream(T, PAYLOAD_LEN)
    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)
    def _generate():
        """The capture, built on the host in this process."""
        from liquid_dsp_tpu.framing.flexframe import flexframegen
        n = PAYLOAD_LEN
        rng = np.random.default_rng(0)
        x = np.zeros((K, batch, T), np.complex64)
        hdrs, pls = [], []
        for k in range(K):
            for b in range(batch):
                h = rng.integers(0, 256, 14).astype(np.uint8)
                p = rng.integers(0, 256, n).astype(np.uint8)
                f = flexframegen(h, p)
                s0 = int(rng.integers(64, T - len(f) - 64))
                x[k, b, s0:s0 + len(f)] += f
                hdrs.append(h); pls.append(p)
        x += (0.005 * (rng.standard_normal(x.shape) +
                       1j * rng.standard_normal(x.shape))).astype(np.complex64)
        return x, np.stack(hdrs), np.stack(pls)

    x, hdrs, pls = _generate()

    xr = jnp.asarray(x.real.copy())
    xi = jnp.asarray(x.imag.copy())
    carry0 = jax.jit(lambda: proc.init(batch_shape=(batch,)))()

    # ---- correctness pass: every embedded frame must decode ----
    step1 = jax.jit(lambda c, r, i: proc.apply((), c, jax.lax.complex(r, i)))
    c = carry0
    got = {}
    zr = jnp.zeros_like(xr[0])
    for k in range(K + 1):      # +1 zero flush block (emit latency)
        out, c = (step1(c, xr[k], xi[k]) if k < K else step1(c, zr, zr))
        v = np.asarray(out.valid)
        hok = np.asarray(out.hdr_ok)
        pok = np.asarray(out.pay_ok)
        hb = np.asarray(out.hdr_bytes).astype(np.uint8)
        pb = np.asarray(out.pay_bytes).astype(np.uint8)
        for b in range(batch):
            for s in np.nonzero(v[b])[0]:
                if hok[b, s] and pok[b, s]:
                    got[(bytes(hb[b, s, :14]), bytes(pb[b, s]))] = True
    sent = {(bytes(hdrs[i]), bytes(pls[i])): True for i in range(len(hdrs))}
    decoded = sum(1 for key in sent if key in got)
    print(f"decoded {decoded}/{len(sent)} embedded frames",
          file=sys.stderr)

    # ---- timed path: K blocks chained in ONE jit via lax.scan ----
    @jax.jit
    def step(c, r, i):
        def body(cc, ri):
            out, c2 = proc.apply((), cc, jax.lax.complex(ri[0], ri[1]))
            s = (jnp.sum(out.hdr_bytes.astype(jnp.float32)) +
                 jnp.sum(out.pay_bytes.astype(jnp.float32)) +
                 jnp.sum(out.rxy))
            return c2, s
        c2, ss = jax.lax.scan(body, c, (r, i))
        return c2, jnp.sum(ss)

    c, chk = step(carry0, xr, xi)
    float(np.asarray(chk))

    def run_trials(n):
        t0 = time.perf_counter()
        c, chk = carry0, None
        for _ in range(n):
            c, chk = step(c, xr, xi)
        float(np.asarray(chk))
        return time.perf_counter() - t0

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod",
        pathlib.Path(__file__).resolve().parent.parent / "bench.py")
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)
    msps = bm.timed_throughput(run_trials, K * batch * T) / 1e6

    print(json.dumps({"metric": "flexframe_full_rx",
                      "msps": round(msps, 2), "batch": batch, "block": T,
                      "k_blocks": K, "frames": len(sent),
                      "decoded": decoded}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
