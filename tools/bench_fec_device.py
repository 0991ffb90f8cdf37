#!/usr/bin/env python
"""On-chip isolated device block-FEC soft-decode throughput (Mbit/s of
decoded payload), the apples-to-apples rows for the reference's
fec_decode_soft (fecsoft_* rows in tests/baseline_perop.json; reference
src/fec/bench/fecsoft_decode_benchmark.c).

The measured op is packetizer_soft_decoder's device_fn — soft-bit
deinterleave + codebook matmul + argmax — which is MORE work than the
C fec_decode_soft (that one gets pre-deinterleaved bits), so the
comparison favors the reference.

Usage: python tools/bench_fec_device.py [payload_len]
"""
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SCHEMES = ("golay2412", "hamming74", "hamming128", "hamming1511")
BATCHES = (256, 1024, 4096)


def main():
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.fec.device import packetizer_soft_decoder
    from liquid_dsp_tpu.fec.packetizer import packetizer_encode

    pl = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    dev = jax.devices()[0]
    print(f"backend: {dev.platform} {dev}", file=sys.stderr)
    rng = np.random.default_rng(3)

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod",
        pathlib.Path(__file__).resolve().parent.parent / "bench.py")
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)

    results = {}
    for scheme in SCHEMES:
        dfn, fin = packetizer_soft_decoder(pl, "none", "none", scheme)
        enc = packetizer_encode(
            rng.integers(0, 256, pl, dtype=np.uint8), "none", "none",
            scheme)
        bits = np.unpackbits(enc).astype(np.float32)
        for B in BATCHES:
            llr_np = np.tile(2.0 * bits - 1.0, (B, 1)) \
                + 0.3 * rng.standard_normal((B, bits.size)).astype(
                    np.float32)

            @jax.jit
            def step_chk(llr, chk):
                msgs = dfn(llr)
                # fold checksum AND feed it back into the input so trials
                # serialize (value-verified)
                s = jnp.sum(msgs[:8, 0]).astype(jnp.float32)
                return llr + 0.0 * s, chk + s

            llr = jnp.asarray(llr_np)
            llr, chk = step_chk(llr, jnp.float32(0))
            float(np.asarray(chk))

            def run_trials(n, llr0=llr):
                t0 = time.perf_counter()
                cur, chk = llr0, jnp.float32(0)
                for _ in range(n):
                    cur, chk = step_chk(cur, chk)
                float(np.asarray(chk))
                return time.perf_counter() - t0

            bits_per_call = B * 8 * pl
            mbps = bm.timed_throughput(run_trials, bits_per_call) / 1e6
            results[f"{scheme}_B{B}"] = mbps
            print(f"{scheme:12s} B={B:5d} {mbps:10.1f} Mbit/s decoded",
                  file=sys.stderr)

    print(json.dumps({"payload_len": pl, "mbit_s": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
