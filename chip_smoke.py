#!/usr/bin/env python
"""On-card smoke test: the system's main path on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh phases only

Phases (one process, one card; any failed check raises and the script
exits nonzero without printing a result):

  1. device: JAX's first device is a GPU; the card's name and power limit.
  2. headline chain: mix -> FIR64 -> FIR57 -> msresamp(0.5), fused, planar,
     on the fused mix+FIR+decim kernel and on XLA, 64 channels x 262,144
     samples per block, blocks chained through the carry.  The first two
     blocks are compared with the unfused complex chain run by XLA on the
     host CPU backend of this process (worst error <= 1e-3 at unit-variance
     input).
  3. frame64 full receiver: 128 channels x 65,536 samples per block,
     frames at random offsets and straddling block boundaries; every
     frame decodes exactly once with its bytes and CRC.
  4. each kernel against its plain version at main-path widths (the chain
     kernel against its plain-JAX reference; the codebook kernel's indices
     against the HIGHEST einsum+argmax on >= 10^6 codewords and ties).
  5. precision: whether an unpinned float32 matmul runs in TF32, and the
     13-family conformance replay (tools/check_onchip_goldens.py).

The last line of standard output is one JSON object naming the device.
A longer record goes to chiprun_out/chip_smoke[_four].json.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

TOL_CHAIN = 1e-3          # tests/conftest.py TOL: reference autotest 1e-3
CHAIN_B, CHAIN_T = 64, 1 << 18
RX_B, RX_T = 128, 1 << 16
N_BLOCKS = 4
CB_N = 1 << 20            # codewords per codebook comparison


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    """`nvidia-smi` name and power limit of the card(s)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.replace("\n", " | ")


# ---------------------------------------------------------------- helpers
# (pure numpy / host; tests/test_chip_smoke.py runs them at small sizes)

def worst_error(got, want) -> float:
    """Largest per-sample absolute difference of two equal-shape arrays."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise SmokeFailure(f"shape {got.shape} != {want.shape}")
    return float(np.abs(got - want).max()) if got.size else 0.0


def frame_starts(rng, n_ch: int, T: int, n_blocks: int, per_block: int):
    """Per channel, sorted frame start indices in a stream of n_blocks
    blocks of T: `per_block` frames inside each block and one frame
    straddling every inner block boundary."""
    from liquid_dsp_tpu.framing.frame64 import FRAME64_LEN as F
    lo, hi = 1500, T - F - 1500
    w = (hi - lo) // per_block
    if w < F + 100:
        raise ValueError(f"block {T} too short for {per_block} frames")
    starts = []
    for _ in range(n_ch):
        s = []
        for b in range(n_blocks):
            for k in range(per_block):
                s.append(b * T + lo + k * w +
                         int(rng.integers(0, w - F - 100)))
            if b + 1 < n_blocks:
                s.append((b + 1) * T - int(rng.integers(200, F - 200)))
        starts.append(sorted(s))
    return starts


def frame64_stream(rng, starts, total: int, noise: float = 0.01):
    """Host-built capture [n_ch, total] complex64 with a frame64 at every
    start; returns (x, {(ch, start): (header, payload)})."""
    from liquid_dsp_tpu.framing.frame64 import FRAME64_LEN, framegen64
    x = np.zeros((len(starts), total), np.complex64)
    sent = {}
    for ch, ss in enumerate(starts):
        for s0 in ss:
            h = rng.integers(0, 256, 8).astype(np.uint8)
            p = rng.integers(0, 256, 64).astype(np.uint8)
            x[ch, s0:s0 + FRAME64_LEN] = framegen64(h, p)
            sent[(ch, s0)] = (h, p)
    x += (noise * (rng.standard_normal(x.shape) +
                   1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return x, sent


def match_frames(sent: dict, reports, slack: int = 2) -> dict:
    """Hold decoded reports [(ch, sample_index, hdr, pay, crc_ok)] to the
    sent frames: each sent frame must be reported exactly once, within
    `slack` samples, with crc_ok and exact bytes; no other report."""
    by_ch = {}
    for (ch, s0), hp in sent.items():
        by_ch.setdefault(ch, []).append((s0, hp))
    hits = {k: 0 for k in sent}
    bad_bytes = spurious = 0
    for ch, si, hdr, pay, ok in reports:
        near = [(s0, hp) for s0, hp in by_ch.get(ch, [])
                if abs(si - s0) <= slack]
        if not near:
            spurious += 1
            continue
        s0, (h, p) = near[0]
        hits[(ch, s0)] += 1
        if not (ok and np.array_equal(hdr, h) and np.array_equal(pay, p)):
            bad_bytes += 1
    return {"sent": len(sent), "reported": len(reports),
            "missing": sum(1 for v in hits.values() if v == 0),
            "duplicate": sum(1 for v in hits.values() if v > 1),
            "bad_bytes": bad_bytes, "spurious": spurious}


def exactly_once(m: dict) -> bool:
    return (m["missing"] == 0 and m["duplicate"] == 0 and
            m["bad_bytes"] == 0 and m["spurious"] == 0 and
            m["reported"] == m["sent"])


def codebook_mismatches(cw, bip, got):
    """Indices where `got` differs from the float64 argmax, and whether
    every difference is an f32 near-tie (scores within 1e-5 of the max
    score's magnitude)."""
    s = np.asarray(cw, np.float64) @ np.asarray(bip, np.float64)
    want = np.argmax(s, axis=-1)
    bad = np.nonzero(np.asarray(got) != want)[0]
    if not len(bad):
        return 0, True
    d = np.abs(s[bad, want[bad]] - s[bad, np.asarray(got)[bad]])
    return len(bad), bool((d <= 1e-5 * np.abs(s[bad]).max(axis=-1)).all())


def time_steps(fn, n: int) -> float:
    """Seconds for n calls of fn() (each returns arrays), after one
    warm call; the last result is waited on inside the window."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return time.perf_counter() - t0


# ----------------------------------------------------------------- phases

def reference_chain():
    """The headline chain unfused and on XLA's convolution: the plain
    reference the GPU chain is held to."""
    from liquid_dsp_tpu import chain
    from liquid_dsp_tpu.design.firdes import firdes_kaiser
    from liquid_dsp_tpu.ops.fir import firfilt
    from liquid_dsp_tpu.ops.nco import nco
    from liquid_dsp_tpu.ops.resample import msresamp
    return chain(nco(dphi=0.125, direction="down"),
                 firfilt(firdes_kaiser(64, 0.2, 60.0), backend="xla"),
                 firfilt(firdes_kaiser(57, 0.3, 60.0), backend="xla"),
                 msresamp(0.5, 60.0))


def phase_chain(rec):
    """Headline chain at 64 x 262,144 on the kernel and on XLA, carried
    over N_BLOCKS blocks; the first two blocks against the CPU chain."""
    import jax
    import jax.numpy as jnp
    from bench import build_chain
    from liquid_dsp_tpu import kernel_fuse, planar
    from liquid_dsp_tpu.ops.kernels.pallas_chain import mix_fir_decim

    B, T = CHAIN_B, CHAIN_T
    key = jax.random.PRNGKey(0)
    s = np.float32(np.sqrt(0.5))      # unit-variance complex input
    xr = jax.random.normal(key, (N_BLOCKS, B, T), jnp.float32) * s
    xi = jax.random.normal(jax.random.fold_in(key, 1),
                           (N_BLOCKS, B, T), jnp.float32) * s
    blocks = [(xr[k], xi[k]) for k in range(N_BLOCKS)]

    fused = build_chain()
    kproc = kernel_fuse(fused)
    check(kproc is not fused, "kernel_fuse did not take the GPU kernel")
    out = {}
    for name, proc in (("kernel", planar(kproc)), ("xla", planar(fused))):
        step = jax.jit(lambda c, r, i, p=proc: p.apply(p.params, c, (r, i)))
        c = jax.jit(lambda p=proc: p.init(batch_shape=(B,)))()
        t0 = time.perf_counter()
        ys = []
        for k in range(N_BLOCKS):
            y, c = step(c, *blocks[k])
            if k < 2:
                ys.append(y)
        jax.block_until_ready((ys, c))
        first = time.perf_counter() - t0
        state = {"c": c, "k": 0}

        def one():
            k = state["k"] % N_BLOCKS
            state["k"] += 1
            y, state["c"] = step(state["c"], *blocks[k])
            return y

        n = 8
        dt = time_steps(one, n)
        msps = n * B * T / dt / 1e6
        out[name] = {"y": [np.asarray(a) + 1j * np.asarray(b)
                           for a, b in ys],
                     "msps": msps, "first_blocks_s": first}
        print(f"chain[{name}]: {msps:.1f} Msps "
              f"({B} ch x {T} per block, {N_BLOCKS}+{n} blocks)",
              flush=True)

    # reference: the UNfused complex chain, XLA on the host CPU backend
    cpu = jax.devices("cpu")[0]
    xr2 = np.asarray(xr[:2])
    xi2 = np.asarray(xi[:2])
    with jax.default_device(cpu):
        ref = reference_chain()
        step = jax.jit(ref.apply)
        c = ref.init(batch_shape=(B,))
        y_ref = []
        for k in range(2):
            x = jax.device_put((xr2[k] + 1j * xi2[k]).astype(np.complex64),
                               cpu)
            y, c = step(ref.params, c, x)
            y_ref.append(np.asarray(y))
    worst = {name: max(worst_error(o["y"][k], y_ref[k]) for k in range(2))
             for name, o in out.items()}
    for name, w in worst.items():
        print(f"chain[{name}] vs CPU unfused chain, blocks 0-1: worst "
              f"|err| = {w:.3e} (limit {TOL_CHAIN:.0e})", flush=True)
        check(w <= TOL_CHAIN, f"chain[{name}] worst error {w} > {TOL_CHAIN}")

    # phase 4 for this kernel: kernel vs its plain-JAX reference on the
    # first block, and the kernel alone vs the plain reference in time
    from liquid_dsp_tpu.fuse import _kernel_plan
    from liquid_dsp_tpu.ops.kernels.pallas_chain import \
        mix_fir_decim_reference
    h, down, step_, sgn, _ = _kernel_plan(fused)
    z = jnp.zeros((B, len(h) - 1), jnp.float32)
    kw = dict(down=down, sgn=sgn, step=step_)
    fk = jax.jit(lambda r, i: mix_fir_decim(r, i, z, z, jnp.float32(0.3),
                                            h, **kw))
    fr = jax.jit(lambda r, i: mix_fir_decim_reference(
        r, i, z, z, jnp.float32(0.3), h, **kw))
    x0r, x0i = blocks[0]
    yk, yr_ = fk(x0r, x0i), fr(x0r, x0i)
    wk = max(worst_error(a, b) for a, b in zip(yk, yr_))
    tk = time_steps(lambda: fk(x0r, x0i), 8) / 8
    tr = time_steps(lambda: fr(x0r, x0i), 8) / 8
    print(f"chain kernel vs plain reference: worst |err| {wk:.3e}; "
          f"{B * T / tk / 1e6:.1f} vs {B * T / tr / 1e6:.1f} Msps",
          flush=True)
    check(wk <= 1e-4, f"chain kernel vs reference error {wk}")
    rec["chain"] = {"kernel_msps": out["kernel"]["msps"],
                    "xla_msps": out["xla"]["msps"],
                    "worst_err_vs_cpu": worst,
                    "kernel_vs_ref_err": wk,
                    "kernel_alone_msps": B * T / tk / 1e6,
                    "reference_alone_msps": B * T / tr / 1e6}


def _rx_run(proc, x_blocks, B):
    """Run a frame64 full receiver over host blocks; returns reports and
    the receiver's jitted step."""
    import jax
    import jax.numpy as jnp
    step = jax.jit(lambda c, r, i: proc.apply((), c, jax.lax.complex(r, i)))
    c = jax.jit(lambda: proc.init(batch_shape=(B,)))()
    reports = []
    for xb in x_blocks:
        out, c = step(c, jnp.asarray(xb.real.copy()),
                      jnp.asarray(xb.imag.copy()))
        o = jax.tree_util.tree_map(np.asarray, out)
        for ch, slot in zip(*np.nonzero(o.valid)):
            reports.append((int(ch), int(o.sample_index[ch, slot]),
                            o.hdr_bytes[ch, slot].astype(np.uint8),
                            o.pay_bytes[ch, slot].astype(np.uint8),
                            bool(o.crc_ok[ch, slot])))
    return reports, step, c


def phase_frame64(rec):
    """frame64 full receiver at 128 x 65,536: exactly-once decode, then
    throughput with the codebook kernel and with the einsum decode."""
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.framing.frame64 import framesync64_stream_full
    from liquid_dsp_tpu.platform import POLICY

    B, T = RX_B, RX_T
    rng = np.random.default_rng(64)
    starts = frame_starts(rng, B, T, N_BLOCKS, per_block=2)
    t0 = time.perf_counter()
    x, sent = frame64_stream(rng, starts, (N_BLOCKS + 1) * T)
    gen_s = time.perf_counter() - t0
    blocks = [x[:, k * T:(k + 1) * T] for k in range(N_BLOCKS + 1)]
    res = {}
    saved = POLICY["codebook_kernel_min_k"]["gpu"]
    try:
        for name, min_k in (("kernel", saved), ("einsum", None)):
            POLICY["codebook_kernel_min_k"]["gpu"] = min_k
            proc = framesync64_stream_full(T)
            reports, step, c = _rx_run(proc, blocks, B)
            m = match_frames(sent, reports)
            print(f"frame64[{name}]: {m}", flush=True)
            check(exactly_once(m), f"frame64[{name}] not exactly once: {m}")
            xr = jnp.asarray(blocks[0].real.copy())
            xi = jnp.asarray(blocks[0].imag.copy())
            n = 6
            dt = time_steps(lambda: step(c, xr, xi)[0].valid, n)
            res[name] = {"msps": n * B * T / dt / 1e6, **m}
            print(f"frame64[{name}]: {res[name]['msps']:.1f} Msps "
                  f"({B} ch x {T} per block)", flush=True)
    finally:
        POLICY["codebook_kernel_min_k"]["gpu"] = saved
    rec["frame64"] = {"host_generation_s": gen_s, **res}


def phase_codebook(rec):
    """Codebook kernel vs the HIGHEST einsum+argmax on the card."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from liquid_dsp_tpu.fec.device import block_codebook
    from liquid_dsp_tpu.ops.kernels.pallas_codebook import codebook_argmax

    bip, n, k = block_codebook("golay2412")
    N = CB_N
    rng = np.random.default_rng(12)

    @jax.jit
    def einsum_argmax(cw):
        s = jnp.einsum("cn,nm->cm", cw, jnp.asarray(bip),
                       precision=lax.Precision.HIGHEST)
        return jnp.argmax(s, axis=-1).astype(jnp.int32)

    kern = jax.jit(lambda cw: codebook_argmax(cw, bip))
    # soft bits on a 2^-6 grid: every score is exact in f32, so the
    # indices must agree bit for bit, ties included
    q = (np.round(rng.standard_normal((N, n)) * 64) / 64).astype(np.float32)
    ties = np.zeros((4096, n), np.float32)          # all-equal scores
    ties[1::2] = bip[:, rng.integers(0, 4096, 2048)].T * 0.5
    cwq = jnp.asarray(np.concatenate([q, ties]))
    gk, ge = np.asarray(kern(cwq)), np.asarray(einsum_argmax(cwq))
    n_diff = int((gk != ge).sum())
    print(f"codebook kernel vs HIGHEST einsum: {cwq.shape[0]} quantized "
          f"codewords + ties, {n_diff} differ", flush=True)
    check(n_diff == 0, f"codebook kernel differs on {n_diff} codewords")
    # continuous soft bits: differences may only be f32 near-ties
    c = rng.standard_normal((N, n)).astype(np.float32)
    gkc = np.asarray(kern(jnp.asarray(c)))
    gec = np.asarray(einsum_argmax(jnp.asarray(c)))
    nk, near_k = codebook_mismatches(c, bip, gkc)
    ne, near_e = codebook_mismatches(c, bip, gec)
    print(f"continuous codewords vs float64: kernel {nk} differ "
          f"(near-ties: {near_k}), einsum {ne} differ (near-ties: "
          f"{near_e})", flush=True)
    check(near_k and near_e, "a codebook decision differs beyond a tie")
    cw = jnp.asarray(c)
    tk = time_steps(lambda: kern(cw), 10) / 10
    te = time_steps(lambda: einsum_argmax(cw), 10) / 10
    print(f"codebook decode alone, {N} codewords: kernel {tk * 1e3:.3f} ms"
          f", einsum+argmax {te * 1e3:.3f} ms", flush=True)
    rec["codebook"] = {"quantized_differ": n_diff,
                       "continuous_differ_kernel": nk,
                       "continuous_differ_einsum": ne,
                       "kernel_ms": tk * 1e3, "einsum_ms": te * 1e3}


def phase_precision(rec):
    """TF32 probe and the 13-family conformance replay."""
    import importlib.util
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    a = rng.standard_normal((1024, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 1024)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    got = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b)))
    rel = float(np.abs(got - exact).max() / np.abs(exact).max())
    tf32 = rel > 1e-5
    print(f"unpinned f32 matmul: max rel err {rel:.2e} vs float64 -> "
          f"{'TF32' if tf32 else 'full f32'}", flush=True)
    spec = importlib.util.spec_from_file_location(
        "check_onchip_goldens", REPO / "tools" / "check_onchip_goldens.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    results = mod.run_all()
    for r in results:
        print(f"conformance {r['family']}: {r['status']} worst "
              f"{r['worst']} tol {r['tol']} ({r['precision']})", flush=True)
    rec["precision"] = {"unpinned_matmul_rel_err": rel, "tf32": tf32,
                        "conformance": results}
    failed = [r["family"] for r in results if r["status"] != "PASS"]
    check(not failed, f"conformance failed: {failed}")


def phase_four(rec):
    """Mesh phases on four cards: the headline chain through StreamRunner
    on a (ch=4) and a (t=4) mesh, and the time-sharded frame64 receiver
    on t=4, each against its one-card run."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from bench import build_chain
    from liquid_dsp_tpu.runtime import StreamRunner
    from liquid_dsp_tpu.parallel.mesh import stream_mesh
    from liquid_dsp_tpu.parallel.rx import framesync64_time_sharded
    from liquid_dsp_tpu.framing.frame64 import framesync64_stream

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    B, T = CHAIN_B, CHAIN_T
    rng = np.random.default_rng(4)
    s = np.sqrt(0.5)
    xs = [((rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
           * s).astype(np.complex64) for _ in range(N_BLOCKS)]
    fused = build_chain()
    one = StreamRunner(fused, batch_shape=(B,))
    y1 = [np.asarray(one(x)) for x in xs]
    res = {}
    for name, mesh in (("ch4", stream_mesh(1, 4, devs)),
                       ("t4", stream_mesh(4, 1, devs))):
        run = StreamRunner(fused, batch_shape=(B,), mesh=mesh)
        ys = [np.asarray(run(x)) for x in xs]
        w = max(worst_error(a, b) for a, b in zip(ys, y1))
        dt = time_steps(lambda: run(xs[0]), 4) / 4
        res[name] = {"worst_vs_one_card": w, "msps": B * T / dt / 1e6}
        print(f"StreamRunner[{name}] vs one card over {N_BLOCKS} blocks: "
              f"worst |err| {w:.3e}; {res[name]['msps']:.1f} Msps",
              flush=True)
        check(w <= 1e-4, f"StreamRunner[{name}] differs from one card: {w}")

    # time-sharded receiver: one stream, frames across every shard and
    # block boundary
    Tb = 4 * 16384
    n_blk = 3
    starts = []
    for b in range(n_blk):
        for q in range(4):
            edge = b * Tb + (q + 1) * 16384
            if edge < n_blk * Tb:
                starts.append(edge - int(rng.integers(200, 1200)))
            starts.append(b * Tb + q * 16384 + int(rng.integers(3000, 9000)))
    starts = [sorted(starts)]
    x, sent = frame64_stream(rng, starts, (n_blk + 1) * Tb)
    x = x[0]
    t_mesh = Mesh(np.array(devs), ("t",))
    init_ts, step_ts = framesync64_time_sharded(Tb, t_mesh)
    step_ts = jax.jit(step_ts)
    rx1 = framesync64_stream(Tb, max_frames=16)
    step1 = jax.jit(lambda c, v: rx1.apply((), c, v))
    c_ts, c1 = init_ts(), rx1.init()
    got_ts, got_1 = {}, {}
    for k in range(n_blk + 1):
        xb = jnp.asarray(x[k * Tb:(k + 1) * Tb])
        o_ts, c_ts = step_ts(c_ts, xb)
        o_1, c1 = step1(c1, xb)
        for o, got in ((o_ts, got_ts), (o_1, got_1)):
            o = jax.tree_util.tree_map(np.asarray, o)
            for sl in np.nonzero(o.valid)[0]:
                got[int(o.sample_index[sl])] = o.symbols[sl]
    check(sorted(got_ts) == sorted(got_1),
          f"time-sharded frames {sorted(got_ts)} != one card "
          f"{sorted(got_1)}")
    check(len(got_1) == len(sent), f"one-card receiver found {len(got_1)} "
          f"of {len(sent)} frames")
    wsym = max(worst_error(got_ts[k], got_1[k]) for k in got_1)
    print(f"time-sharded frame64 (t=4) vs one card: {len(got_1)} frames at "
          f"the same sample indices, worst symbol |err| {wsym:.3e}",
          flush=True)
    check(wsym <= 1e-3, f"time-sharded symbols differ by {wsym}")
    res["rx_t4"] = {"frames": len(got_1), "worst_symbol_err": wsym}
    rec["four"] = res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phases")
    args = ap.parse_args(argv)

    import jax
    from liquid_dsp_tpu.platform import enable_compile_cache
    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform}); "
              "nothing to check", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)
    rec = {"card": card, "device_kind": devs[0].device_kind}
    t0 = time.perf_counter()
    phases = ([phase_four] if args.four else
              [phase_chain, phase_frame64, phase_codebook, phase_precision])
    for ph in phases:
        t = time.perf_counter()
        ph(rec)
        print(f"[{ph.__name__} done in {time.perf_counter() - t:.1f} s]",
              flush=True)
    rec["seconds"] = time.perf_counter() - t0
    outdir = REPO / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    name = "chip_smoke_four.json" if args.four else "chip_smoke.json"
    (outdir / name).write_text(json.dumps(rec, indent=1, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
