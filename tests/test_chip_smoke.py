"""chip_smoke.py's host-side helpers at small sizes on the CPU: the
frame placement, the exactly-once matcher (against the real frame64
receiver), the error and near-tie checks, and that the script refuses
to run without a GPU."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

import chip_smoke as cs

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_frame_starts_straddle_every_boundary():
    from liquid_dsp_tpu.framing.frame64 import FRAME64_LEN as F
    rng = np.random.default_rng(0)
    T, nb = 8192, 3
    starts = cs.frame_starts(rng, 2, T, nb, per_block=1)
    for s in starts:
        assert len(s) == nb + (nb - 1)
        assert all(b - a >= F + 100 for a, b in zip(s, s[1:]))
        for edge in range(T, nb * T, T):
            assert any(a < edge < a + F for a in s)
        assert s[-1] + F <= nb * T


def test_frame64_exactly_once_on_cpu():
    from liquid_dsp_tpu.framing.frame64 import framesync64_stream_full
    rng = np.random.default_rng(1)
    B, T, nb = 2, 8192, 3
    starts = cs.frame_starts(rng, B, T, nb, per_block=1)
    x, sent = cs.frame64_stream(rng, starts, (nb + 1) * T)
    blocks = [x[:, k * T:(k + 1) * T] for k in range(nb + 1)]
    reports, _, _ = cs._rx_run(framesync64_stream_full(T), blocks, B)
    m = cs.match_frames(sent, reports)
    assert cs.exactly_once(m), m
    assert m["sent"] == B * (2 * nb - 1)


def test_match_frames_flags_each_failure():
    h, p = np.arange(8, dtype=np.uint8), np.arange(64, dtype=np.uint8)
    sent = {(0, 100): (h, p), (0, 5000): (h, p), (1, 100): (h, p)}
    ok = [(0, 101, h, p, True), (0, 5000, h, p, True), (1, 99, h, p, True)]
    assert cs.exactly_once(cs.match_frames(sent, ok))
    m = cs.match_frames(sent, ok[:2])
    assert m["missing"] == 1 and not cs.exactly_once(m)
    m = cs.match_frames(sent, ok + [(0, 100, h, p, True)])
    assert m["duplicate"] == 1 and not cs.exactly_once(m)
    bad = p.copy()
    bad[3] ^= 1
    m = cs.match_frames(sent, ok[:2] + [(1, 100, h, bad, True)])
    assert m["bad_bytes"] == 1
    m = cs.match_frames(sent, ok[:2] + [(1, 100, h, p, False)])
    assert m["bad_bytes"] == 1
    m = cs.match_frames(sent, ok + [(1, 3000, h, p, False)])
    assert m["spurious"] == 1 and not cs.exactly_once(m)


def test_worst_error_and_codebook_near_ties():
    assert cs.worst_error(np.ones(4), np.ones(4) + 1e-4) == pytest.approx(
        1e-4)
    with pytest.raises(cs.SmokeFailure):
        cs.worst_error(np.ones(4), np.ones(5))
    bip = np.array([[1.0, -1.0, 1.0], [1.0, 1.0, -1.0]], np.float32)
    # row 1 scores columns 0 and 2 at 1 +- 1e-7: a near-tie
    cw = np.array([[1.0, 0.3], [1.0, 1e-7], [0.0, 1.0]], np.float32)
    want = np.argmax(cw.astype(np.float64) @ bip, axis=-1)
    assert cs.codebook_mismatches(cw, bip, want) == (0, True)
    got = want.copy()
    got[1] = 2                                 # a near-tie flip
    n, near = cs.codebook_mismatches(cw, bip, got)
    assert n == 1 and near
    got = want.copy()
    got[0] = 1                                 # a real error
    n, near = cs.codebook_mismatches(cw, bip, got)
    assert n == 1 and not near


def test_reference_chain_matches_fused_chain_on_cpu():
    # the plain reference the GPU chain is held to agrees with the fused
    # planar chain at a small size (the on-card check is the same
    # comparison at 64 x 262,144)
    from bench import build_chain
    from liquid_dsp_tpu import planar
    rng = np.random.default_rng(2)
    B, T = 4, 4096
    x = ((rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
         * np.sqrt(0.5)).astype(np.complex64)
    ref = cs.reference_chain()
    y_ref, _ = ref.apply(ref.params, ref.init(batch_shape=(B,)),
                         jnp.asarray(x))
    p = planar(build_chain())
    (yr, yi), _ = p.apply(p.params, p.init(batch_shape=(B,)),
                          (jnp.asarray(x.real), jnp.asarray(x.imag)))
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert cs.worst_error(got, y_ref) <= cs.TOL_CHAIN


def test_refuses_to_run_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
