#!/usr/bin/env python
"""Throughput of the HEADER-ADAPTIVE full-device flexframe RX
(flexframe_rx_stream_multi) on a MIXED-config
stream: frames of every registered payload configuration interleaved in
every channel.  Methodology matches bench_flexframe_fullrx.py (K blocks
chained in-jit, checksum readback, two-point calibration) plus a
host-loop comparison: the same mixed stream through FlexFrameSync
(the per-frame-reconfiguring host path the reference contract implies).

Prints one JSON line:
  {"metric": "flexframe_multi_rx", "msps": ..., "host_loop_msps": ...}
"""
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

CONFIGS = [(48, "crc32", "none", "golay2412", "qpsk"),
           (96, "crc16", "none", "hamming128", "qam16"),
           (32, "crc32", "v27", "none", "qpsk")]


def main():
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.framing.flexframe import flexframe_rx_stream_multi

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
    K = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    proc = flexframe_rx_stream_multi(T, CONFIGS)
    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)
    def _generate():
        """The capture, built on the host in this process."""
        from liquid_dsp_tpu.framing.flexframe import flexframegen
        rng = np.random.default_rng(0)
        x = np.zeros((K, batch, T), np.complex64)
        hdrs, pls, cfgs = [], [], []
        for k in range(K):
            for b in range(batch):
                j = int(rng.integers(0, len(CONFIGS)))
                pl, crc, fec0, fec1, ms = CONFIGS[j]
                h = rng.integers(0, 256, 14).astype(np.uint8)
                p = rng.integers(0, 256, pl).astype(np.uint8)
                f = flexframegen(h, p, crc=crc, fec0=fec0, fec1=fec1, ms=ms)
                s0 = int(rng.integers(64, T - len(f) - 64))
                x[k, b, s0:s0 + len(f)] += f
                hdrs.append(h); pls.append(np.pad(p, (0, 96 - pl)))
                cfgs.append(j)
        x += (0.005 * (rng.standard_normal(x.shape) +
                       1j * rng.standard_normal(x.shape))).astype(np.complex64)
        return x, np.stack(hdrs), np.stack(pls), np.asarray(cfgs)

    x, hdrs, pls, cfgs = _generate()

    xr = jnp.asarray(x.real.copy())
    xi = jnp.asarray(x.imag.copy())
    carry0 = jax.jit(lambda: proc.init(batch_shape=(batch,)))()

    # ---- correctness: every frame decodes with its matched config ----
    step1 = jax.jit(lambda c, r, i: proc.apply((), c, jax.lax.complex(r, i)))
    c = carry0
    got = {}
    zr = jnp.zeros_like(xr[0])
    for k in range(K + 1):
        out, c = (step1(c, xr[k], xi[k]) if k < K else step1(c, zr, zr))
        v = np.asarray(out.valid)
        hok = np.asarray(out.hdr_ok)
        pok = np.asarray(out.pay_ok)
        ci = np.asarray(out.cfg_idx)
        hb = np.asarray(out.hdr_bytes).astype(np.uint8)
        pb = np.asarray(out.pay_bytes).astype(np.uint8)
        for b in range(batch):
            for s in np.nonzero(v[b])[0]:
                if hok[b, s] and pok[b, s]:
                    pl = CONFIGS[ci[b, s]][0]
                    got[(bytes(hb[b, s, :14]),
                         bytes(pb[b, s, :pl]))] = True
    sent = {(bytes(hdrs[i]), bytes(pls[i][:CONFIGS[cfgs[i]][0]])): True
            for i in range(len(hdrs))}
    decoded = sum(1 for key in sent if key in got)
    print(f"decoded {decoded}/{len(sent)} mixed-config frames",
          file=sys.stderr)

    # ---- timed path ----
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

    # ---- host-loop comparison on ONE channel's stream ----
    host_msps = None
    try:
        from liquid_dsp_tpu.framing.flexframe import FlexFrameSync
        xs = x[0, 0]
        fs = FlexFrameSync(block_len=4096)
        fs.execute(xs)  # warm compile
        t0 = time.perf_counter()
        reps = 0
        while time.perf_counter() - t0 < 2.0:
            fs.execute(xs)
            reps += 1
        host_msps = reps * len(xs) / (time.perf_counter() - t0) / 1e6
    except Exception as e:                                # noqa: BLE001
        print(f"host-loop comparison failed: {e}", file=sys.stderr)

    print(json.dumps({"metric": "flexframe_multi_rx",
                      "msps": round(msps, 2), "batch": batch, "block": T,
                      "k_blocks": K, "frames": len(sent),
                      "decoded": decoded,
                      "host_loop_msps": (None if host_msps is None
                                         else round(host_msps, 2))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
