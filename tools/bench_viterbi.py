#!/usr/bin/env python
"""On-device soft-Viterbi throughput (fec/device.py conv_soft_decoder):
v27 (64 states) and v29 (256 states), batched over channels — the
channel-batch lever is the documented mitigation for sequential scans
(CLAUDE.md).

Reports kbit/s of DECODED payload per configuration, value-verified
(decoded-bit checksum read back inside the timed region, two-point
calibration).  v615 is host-only by design: its 16384-state ACS per
bit is 64x v29's work at the same sequential depth (API_PARITY.md).

Usage: python tools/bench_viterbi.py [dec_len_bytes]
Prints one JSON line per (scheme, batch).
"""
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.fec.device import conv_soft_decoder
    from liquid_dsp_tpu.fec.conv import conv_encode
    from liquid_dsp_tpu.fec.block import unpack_bits

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod",
        pathlib.Path(__file__).resolve().parent.parent / "bench.py")
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)

    dec_len = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)
    rng = np.random.default_rng(0)

    for scheme in ("v27", "v29"):
        dev_fn, enc_len = conv_soft_decoder(scheme, dec_len)
        # one real codeword (noisy), tiled across the batch as float
        # planes — complex/int transfers are the fragile ones, plain
        # f32 LLR arrays device_put fine
        msg = rng.integers(0, 256, dec_len, dtype=np.uint8)
        bits = unpack_bits(conv_encode(scheme, msg)).astype(np.float32)
        llr1 = (2 * bits - 1) * 4 + 0.5 * rng.standard_normal(
            len(bits)).astype(np.float32)
        for batch in (16, 64, 256):
            llr = np.tile(llr1, (batch, 1))
            llr += 0.1 * rng.standard_normal(llr.shape).astype(np.float32)

            @jax.jit
            def step(llr_in, salt):
                bits_out = dev_fn(llr_in + salt * 1e-6)
                return jnp.sum(bits_out).astype(jnp.float32)

            x = jnp.asarray(llr)
            chk = step(x, jnp.float32(0))
            float(np.asarray(chk))        # warmup + readback

            def run_trials(n):
                t0 = time.perf_counter()
                s = jnp.float32(0)
                for _ in range(n):
                    s = s + step(x, s * 0)  # chain: no overlap elision
                float(np.asarray(s))
                return time.perf_counter() - t0

            bits_per_call = batch * 8 * dec_len
            kbps = bm.timed_throughput(run_trials, bits_per_call) / 1e3
            print(json.dumps({
                "metric": f"viterbi_{scheme}_soft",
                "kbits_per_s": round(kbps, 1), "batch": batch,
                "dec_len": dec_len,
                "states": 64 if scheme == "v27" else 256}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
