#!/usr/bin/env python
"""On-device channelizer throughput: the four fused banded-matmul
channelizers (multichannel/channelizer.py; reference analog
src/multichannel/src/firpfbch.c:37-405 / firpfbch2.c:36-337).

A repeatable timing of the channelizers at one shape.
Methodology = bench_suite: single dispatch per block, carry chained
trial to trial, checksum read back inside the timed region, two-point
calibration.  Throughput is WIDEBAND samples/s (analyzers: input rate;
synthesizers: output rate).

Usage: python tools/bench_channelizer.py [M] [B] [T]
       (defaults 64 16 65536)
"""
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from liquid_dsp_tpu.multichannel import (
        firpfbch_analyzer, firpfbch_synthesizer,
        firpfbch2_analyzer, firpfbch2_synthesizer)
    from bench_suite import bench

    M = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    T = int(sys.argv[3]) if len(sys.argv) > 3 else 65536
    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)
    rng = np.random.default_rng(0)

    def cplx(shape):
        re = rng.standard_normal(shape).astype(np.float32)
        im = rng.standard_normal(shape).astype(np.float32)
        if jax.default_backend() == "cpu":
            return jnp.asarray(re + 1j * im)
        return jax.jit(jax.lax.complex)(jnp.asarray(re), jnp.asarray(im))

    # channel-domain input for the synthesizers: [B, M, nf]
    nf1 = T // M              # firpfbch synth: nf hops of M -> T out
    nf2 = 2 * T // M          # firpfbch2 synth: nf hops of M/2 -> T out
    cases = [
        ("firpfbch_64_analyzer", firpfbch_analyzer(M), (B, T), T),
        ("firpfbch2_64_analyzer", firpfbch2_analyzer(M), (B, T), T),
        ("firpfbch_64_synth", firpfbch_synthesizer(M), (B, M, nf1), T),
        ("firpfbch2_64_synth", firpfbch2_synthesizer(M), (B, M, nf2), T),
    ]
    out = {}
    for name, proc, shape, wideband in cases:
        try:
            x = cplx(shape)
            carry = jax.jit(lambda p=proc, s=shape[:1]:
                            p.init(batch_shape=s))()
            params = jax.jit(lambda p=proc: p.params)()
            step = jax.jit(proc.apply)
            msps = bench(step, params, carry, x) * (wideband * B) / x.size
            out[name] = round(msps, 1)
            print(f"{name:24s} {msps:10.1f} Msps wideband", file=sys.stderr)
        except Exception as e:
            out[name] = None
            print(f"{name:24s} FAILED ({type(e).__name__}: "
                  f"{str(e)[:120]})", file=sys.stderr)
    print(json.dumps({"metric": "channelizer_fused", "M": M, "batch": B,
                      "block": T, "msps": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
