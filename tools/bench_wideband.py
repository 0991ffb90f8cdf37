"""Full-system wideband scanner throughput: 64-channel oversampled
polyphase analyzer feeding ONE batched streaming frame64 receiver over
every channel — the whole scanner is a single jitted step (the
examples/wideband_scanner_example.py pipeline, timed).

Value-verified (decoded-frame count + checksum read back inside the
timed region).  Usage: python tools/bench_wideband.py [B] [T_wideband]
Prints one JSON line with WIDEBAND Msamples/s (channel-domain rate is
2x that: the analyzer is 2x oversampled).
"""
import json
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    import jax
    import jax.numpy as jnp
    import bench as bm
    from liquid_dsp_tpu.multichannel import firpfbch2_analyzer
    from liquid_dsp_tpu.framing.frame64 import framesync64_stream

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    Tw = int(sys.argv[2]) if len(sys.argv) > 2 else 65536
    M = 64
    Tc = 2 * Tw // M                  # per-channel samples per block

    # --- the wideband capture: frames on a few channels, synthesized
    # into one wideband stream, built in this process ---
    from liquid_dsp_tpu.multichannel import firpfbch2_synthesizer
    from liquid_dsp_tpu.framing.frame64 import FRAME64_LEN, framegen64
    rng = np.random.default_rng(0)
    chans = (0.002 * (rng.standard_normal((B, M, Tc)) +
                      1j * rng.standard_normal((B, M, Tc)))
             ).astype(np.complex64)
    n_frames = 0
    for b in range(B):
        for ch in rng.choice(M, 6, replace=False):
            pos = int(rng.integers(100, Tc - FRAME64_LEN - 100))
            fr = framegen64(rng.integers(0, 256, 8).astype(np.uint8),
                            rng.integers(0, 256, 64).astype(np.uint8))
            chans[b, ch, pos:pos + FRAME64_LEN] += fr
            n_frames += 1
    wide, _ = firpfbch2_synthesizer(M)(jnp.asarray(chans),
                                       batch_shape=(B,))
    wide_np = np.asarray(wide)        # [B, Tw]

    # HIGH matmul precision: a detection front-end tolerates the
    # reduced precision (channelizer.py docstring; its error on the
    # card is not measured)
    import jax.lax as _lax
    ana = firpfbch2_analyzer(M, precision=_lax.Precision.HIGH)
    rx = framesync64_stream(Tc)

    # K blocks chained inside one jit (carries flow block to block,
    # StreamRunner's execution shape) to amortize per-dispatch overhead
    K = 8 if jax.default_backend() != "cpu" else 1

    @jax.jit
    def step(ca, cr, xr, xi):
        def body(cc, _):
            ca_in, cr_in, acc = cc
            x = jax.lax.complex(xr, xi)
            streams, ca2 = ana.apply(ana.params, ca_in, x)   # [B, M, Tc]
            out, cr2 = rx.apply((), cr_in, streams)
            acc = acc + (jnp.sum(out.valid) +
                         jnp.sum(jnp.where(out.valid, out.rxy, 0.0)))
            return (ca2, cr2, acc), None
        (ca2, cr2, chk), _ = jax.lax.scan(
            body, (ca, cr, jnp.float32(0)), None, length=K)
        return ca2, cr2, chk

    carry_a = jax.jit(lambda: ana.init(batch_shape=(B,)))()
    carry_r = jax.jit(lambda: rx.init(batch_shape=(B, M)))()
    xr = jnp.asarray(wide_np.real.copy())
    xi = jnp.asarray(wide_np.imag.copy())

    ca, cr, chk = step(carry_a, carry_r, xr, xi)
    n_dec = float(np.asarray(jnp.sum(
        step(carry_a, carry_r, xr, xi)[2])))  # warm + sanity
    print(f"# frames in capture: {n_frames}, first-pass chk {n_dec:.1f}",
          file=sys.stderr)

    def run(n):
        t0 = time.perf_counter()
        ca, cr, chk = carry_a, carry_r, None
        for _ in range(n):
            ca, cr, chk = step(ca, cr, xr, xi)
        float(np.asarray(chk))
        return time.perf_counter() - t0

    msps = bm.timed_throughput(run, K * B * Tw) / 1e6
    print(json.dumps({"metric": "wideband_scanner_64ch",
                      "wideband_msps": round(msps, 1),
                      "channel_msps": round(2 * msps, 1),
                      "batch": B, "wideband_block": Tw,
                      "frames": n_frames}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
