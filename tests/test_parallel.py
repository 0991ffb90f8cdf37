"""Multi-device equivalence: N-device sharded run ≡ 1-device run ≡ golden.

This is the test class the reference cannot have (single-threaded C);
SURVEY.md §4 prescribes it.  Runs on the 8-device virtual CPU mesh.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from conftest import assert_close
from liquid_dsp_tpu import chain
from liquid_dsp_tpu.ops.fir import firfilt, firdecim
from liquid_dsp_tpu.ops.fftfilt import fftfilt
from liquid_dsp_tpu.ops.nco import nco
from liquid_dsp_tpu.parallel.mesh import stream_mesh
from liquid_dsp_tpu.parallel.stream import run_time_sharded


def _rand_cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_firfilt_time_sharded(n_dev):
    rng = np.random.default_rng(11)
    h = rng.standard_normal(17).astype(np.float32)
    x = _rand_cplx(rng, 1024)
    proc = firfilt(h)
    y_ref, c_ref = proc(jnp.asarray(x))
    mesh = stream_mesh(n_time=n_dev, devices=jax.devices()[:n_dev])
    y, c = run_time_sharded(proc, mesh, jnp.asarray(x))
    assert_close(y, np.asarray(y_ref), tol=1e-5, msg=f"{n_dev}-dev firfilt")
    assert_close(c, np.asarray(c_ref), tol=1e-6, msg="carry")


def test_firfilt_sharded_golden(golden):
    """Sharded output matches the extracted reference golden vector
    EXACTLY the way the single-device path does."""
    d = golden("firfilt_crcf_data_h13x32")
    proc = firfilt(d["h"])
    mesh = stream_mesh(n_time=2, devices=jax.devices()[:2])
    y, _ = run_time_sharded(proc, mesh, jnp.asarray(d["x"]))
    assert_close(y, d["y"], msg="sharded vs golden")


def test_fftfilt_time_sharded():
    rng = np.random.default_rng(13)
    h = rng.standard_normal(23).astype(np.float32)
    x = _rand_cplx(rng, 2048)
    proc = fftfilt(h)
    y_ref, _ = proc(jnp.asarray(x), carry=proc.init())
    mesh = stream_mesh(n_time=4, devices=jax.devices()[:4])
    y, _ = run_time_sharded(proc, mesh, jnp.asarray(x))
    assert_close(y, np.asarray(y_ref), tol=1e-4, msg="4-dev fftfilt")


def test_chain_time_sharded():
    """mixer -> FIR -> decim chain sharded over 4 devices: the mixer uses
    closed-form phase advance, the filters exchange halos."""
    rng = np.random.default_rng(17)
    h = rng.standard_normal(31).astype(np.float32)
    h2 = rng.standard_normal(15).astype(np.float32)
    x = _rand_cplx(rng, 2048)
    proc = chain(nco(dphi=0.1, direction="down"), firfilt(h), firdecim(2, h2))
    y_ref, _ = proc(jnp.asarray(x))
    mesh = stream_mesh(n_time=4, devices=jax.devices()[:4])
    y, _ = run_time_sharded(proc, mesh, jnp.asarray(x))
    assert_close(y, np.asarray(y_ref), tol=1e-3, msg="sharded chain")


def test_multiblock_carry_continuity():
    """Two successive sharded block steps ≡ one long single-device run."""
    rng = np.random.default_rng(19)
    h = rng.standard_normal(9).astype(np.float32)
    x = _rand_cplx(rng, 1024)
    proc = firfilt(h)
    y_ref, _ = proc(jnp.asarray(x))
    mesh = stream_mesh(n_time=4, devices=jax.devices()[:4])
    carry = proc.init()
    y1, carry = run_time_sharded(proc, mesh, jnp.asarray(x[:512]), carry=carry)
    y2, carry = run_time_sharded(proc, mesh, jnp.asarray(x[512:]), carry=carry)
    assert_close(np.concatenate([np.asarray(y1), np.asarray(y2)]),
                 np.asarray(y_ref), tol=1e-5, msg="block continuity")


def test_channel_and_time_sharded():
    """2-channel x 4-time mesh: both axes at once."""
    rng = np.random.default_rng(23)
    h = rng.standard_normal(13).astype(np.float32)
    x = _rand_cplx(rng, 2, 1024)
    proc = firfilt(h)
    y_ref, _ = proc(jnp.asarray(x), carry=proc.init(batch_shape=(2,)))
    mesh = stream_mesh(n_time=4, n_channel=2)
    y, _ = run_time_sharded(proc, mesh, jnp.asarray(x),
                            carry=proc.init(batch_shape=(2,)))
    assert_close(y, np.asarray(y_ref), tol=1e-5, msg="ch+time sharded")


# ---------------------------------------------------------------------------
def test_hierarchical_dcn_ici_mesh():
    """3-axis (dcn, ch, t) mesh — SURVEY §5's (host/dcn, chip/ici,
    channel) layout: channels data-parallel over hosts x chips, time
    halo-exchanged over its own axis.  Output must equal 1-device."""
    import jax
    from jax.sharding import Mesh
    from liquid_dsp_tpu.parallel.stream import time_shard_apply
    from liquid_dsp_tpu.design.firdes import firdes_kaiser
    from liquid_dsp_tpu.ops.fir import firfilt

    devs = np.array(jax.devices()[:8]).reshape(2, 2, 2)
    mesh = Mesh(devs, ("dcn", "ch", "t"))
    proc = firfilt(firdes_kaiser(33, 0.2, 60.0))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 1024)) +
         1j * rng.standard_normal((4, 1024))).astype(np.complex64)
    carry = proc.init(batch_shape=(4,))
    fn = jax.jit(time_shard_apply(proc, mesh,
                                  channel_axis=("dcn", "ch")))
    y_sh, _ = fn(carry, jnp.asarray(x))
    y_1, _ = proc.apply(proc.params, carry, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y_sh), np.asarray(y_1),
                               atol=1e-5)


# channel-axis data parallelism (SURVEY.md §2.12: channelizer DP axis)

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _dp_equiv(proc, x, batch_axes=1, tol=1e-4, dtype=jnp.complex64):
    """Batch-sharded run over 8 devices == single-device run."""
    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices, ("ch",))
    carry = proc.init(batch_shape=x.shape[:batch_axes], dtype=dtype)
    y_ref, c_ref = jax.jit(proc.apply)(proc.params, carry, x)

    xspec = P("ch", *([None] * (x.ndim - 1)))
    xs = jax.device_put(x, NamedSharding(mesh, xspec))

    def cspec(leaf):
        if jnp.ndim(leaf) >= batch_axes and jnp.shape(leaf)[:1] == x.shape[:1]:
            return NamedSharding(mesh, P("ch", *([None] * (jnp.ndim(leaf) - 1))))
        return NamedSharding(mesh, P())
    cs = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, cspec(l)), carry)
    y, c = jax.jit(proc.apply)(proc.params, cs, xs)
    assert_close(np.asarray(y), np.asarray(y_ref), tol=tol)


def test_channelizer_channel_dp():
    from liquid_dsp_tpu.multichannel import firpfbch2_analyzer
    rng = np.random.default_rng(0)
    x = _rand_cplx(rng, 8, 16 * 16)
    _dp_equiv(firpfbch2_analyzer(16, 3), jnp.asarray(x))


def test_resamp_channel_dp():
    from liquid_dsp_tpu.ops.resample import resamp
    rng = np.random.default_rng(1)
    x = _rand_cplx(rng, 8, 256)
    _dp_equiv(resamp((3, 2), m=5), jnp.asarray(x))


def test_agc_channel_dp():
    from liquid_dsp_tpu.ops.agc import agc
    rng = np.random.default_rng(2)
    x = 0.1 * _rand_cplx(rng, 8, 512)
    _dp_equiv(agc(), jnp.asarray(x))


def test_modem_demod_channel_dp():
    from liquid_dsp_tpu.modem import modem_demodulator
    rng = np.random.default_rng(3)
    x = _rand_cplx(rng, 8, 512)
    _dp_equiv(modem_demodulator("qam16"), jnp.asarray(x))


def test_firdecim_time_sharded():
    rng = np.random.default_rng(4)
    from liquid_dsp_tpu.design.firdes import firdes_kaiser
    h = firdes_kaiser(33, 0.1, 60.0)
    q = firdecim(4, h)
    x = _rand_cplx(rng, 2, 8 * 64)
    mesh = stream_mesh(n_time=4, n_channel=2,
                       devices=jax.devices()[:8])
    y_ref, _ = q(jnp.asarray(x), batch_shape=(2,))
    from liquid_dsp_tpu.parallel.stream import time_shard_apply
    step = jax.jit(time_shard_apply(q, mesh))
    y, _ = step(q.init(batch_shape=(2,)), jnp.asarray(x))
    assert_close(np.asarray(y), np.asarray(y_ref), tol=1e-4)


class TestNCOGolden:
    """nco mixing vs the compiled reference, both oscillator types (nco
    cases in tools/gen_flexframe_golden.py)."""

    @pytest.fixture(scope="class")
    def fg(self):
        import pathlib
        path = pathlib.Path(__file__).parent / "golden/flexframe_golden.npz"
        if not path.exists():
            pytest.skip("flexframe_golden.npz not generated")
        return dict(np.load(path))

    def test_vco_mode(self, fg):
        from liquid_dsp_tpu.ops.nco import nco
        p = nco(dphi=0.123, direction="up")
        y, _ = p(jnp.asarray(fg["nco_x"]), batch_shape=())
        assert np.abs(np.asarray(y) - fg["nco_vco_y"]).max() < 1e-4

    def test_lut_mode(self, fg):
        from liquid_dsp_tpu.ops.nco import nco
        p = nco(dphi=0.123, direction="up", table=True)
        y, _ = p(jnp.asarray(fg["nco_x"]), batch_shape=())
        assert np.abs(np.asarray(y) - fg["nco_lut_y"]).max() < 1e-5


class TestStagePipeline:
    """Stage pipelining across device groups (SURVEY.md §2.12, new design):
    each chain stage's params+carry live on their own device; equivalence
    contract is pipelined == single-device chain."""

    def test_two_stage_fir_equivalence(self):
        from liquid_dsp_tpu.parallel.pipeline import StagePipeline
        rng = np.random.default_rng(21)
        h1 = rng.standard_normal(17).astype(np.float32)
        h2 = rng.standard_normal(9).astype(np.float32)
        f1, f2 = firfilt(h1), firfilt(h2)
        x = _rand_cplx(rng, 4, 256)
        pipe = StagePipeline([f1, f2], devices=jax.devices()[:2])
        y = pipe.run(x)
        ch = chain(f1, f2)
        c = ch.init()
        ref = []
        for b in x:
            yb, c = ch.apply(ch.params, c, jnp.asarray(b))
            ref.append(np.asarray(yb))
        assert_close(y, np.stack(ref), tol=1e-5, msg="2-stage pipeline")
        # stages actually placed on distinct devices
        assert pipe._devs[0] != pipe._devs[1]

    def test_rate_changing_stage_and_reset(self):
        from liquid_dsp_tpu.parallel.pipeline import StagePipeline
        rng = np.random.default_rng(22)
        h1 = rng.standard_normal(17).astype(np.float32)
        h2 = rng.standard_normal(12).astype(np.float32)
        f1, dec = firfilt(h1), firdecim(4, h2)
        x = _rand_cplx(rng, 3, 512)
        pipe = StagePipeline([f1, dec], devices=jax.devices()[:2])
        y1 = pipe.run(x)
        assert y1.shape == (3, 128)
        pipe.reset()
        y2 = pipe.run(x)
        assert_close(y2, y1, tol=0, msg="reset reproducibility")
        ch = chain(f1, dec)
        c = ch.init()
        ref = []
        for b in x:
            yb, c = ch.apply(ch.params, c, jnp.asarray(b))
            ref.append(np.asarray(yb))
        assert_close(y1, np.stack(ref), tol=1e-5, msg="pipelined decim chain")


# ---------------------------------------------------------------------------
# Streaming RECEIVERS under the device mesh: the
# north-star RX chain sharded over channels, frames straddling block
# AND shard boundaries decoding exactly once, sharded == single-device.

def _frame64_stream_capture(rng, n_ch, n_blocks, T):
    """[n_ch, n_blocks*T] capture, one frame per channel; odd channels
    place the frame straddling the first block boundary."""
    from liquid_dsp_tpu.framing.frame64 import FRAME64_LEN, framegen64
    x = (0.01 * _rand_cplx(rng, n_ch, n_blocks * T))
    sent = []
    for c in range(n_ch):
        h = rng.integers(0, 256, 8).astype(np.uint8)
        p = rng.integers(0, 256, 64).astype(np.uint8)
        f = framegen64(h, p)
        s0 = (T - FRAME64_LEN // 2 if c % 2            # straddles block 0/1
              else int(rng.integers(64, T - FRAME64_LEN - 64)))
        x[c, s0:s0 + FRAME64_LEN] += f
        sent.append((s0, h, p))
    return x, sent


def _run_stream_blocks(proc, carry, x, T, step=None):
    import jax
    step = step or jax.jit(proc.apply)
    outs = []
    for b in range(x.shape[-1] // T):
        out, carry = step((), carry, x[..., b * T:(b + 1) * T])
        outs.append(jax.tree_util.tree_map(np.asarray, out))
    return outs


def _assert_block_trees_equal(a, b, tol):
    for oa, ob in zip(a, b):
        va, vb = np.asarray(oa.valid), np.asarray(ob.valid)
        np.testing.assert_array_equal(va, vb)
        for la, lb in zip(jax.tree_util.tree_leaves(oa),
                          jax.tree_util.tree_leaves(ob)):
            la, lb = np.asarray(la), np.asarray(lb)
            if la.dtype == bool or la.dtype.kind in "iu":
                # integer estimates (sample_index) must agree on valid
                # slots; invalid slots hold unspecified fill
                m = va if la.shape == va.shape else None
                if m is not None:
                    np.testing.assert_array_equal(la[m], lb[m])
                continue
            mask = va
            while mask.ndim < la.ndim:
                mask = mask[..., None]
            d = np.abs(np.where(mask, la, 0) - np.where(mask, lb, 0))
            assert float(d.max()) < tol, f"leaf mismatch {d.max()}"


def test_framesync64_stream_channel_dp():
    """The flagship streaming receiver sharded over 8 channel devices:
    identical detections + symbols vs single-device, every frame decoded
    exactly once (incl. frames straddling the block boundary)."""
    from liquid_dsp_tpu.framing.frame64 import framesync64_stream
    rng = np.random.default_rng(31)
    T, n_ch = 4096, 8
    x, sent = _frame64_stream_capture(rng, n_ch, 2, T)
    proc = framesync64_stream(T)
    carry0 = proc.init(batch_shape=(n_ch,))
    ref = _run_stream_blocks(proc, carry0, jnp.asarray(x), T)

    mesh = Mesh(np.array(jax.devices()[:8]), ("ch",))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("ch", None)))
    cs = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, NamedSharding(
            mesh, P("ch", *([None] * (np.ndim(l) - 1))))), carry0)
    got = _run_stream_blocks(proc, cs, xs, T)
    _assert_block_trees_equal(ref, got, tol=1e-3)
    # exactly one decode per channel across all blocks
    valids = np.stack([o.valid for o in got])        # [blocks, ch, P]
    assert (valids.sum(axis=(0, 2)) == 1).all()
    evm = np.stack([o.evm_db for o in got])
    assert (evm[valids] < -20).all()


def test_framesync64_stream_hierarchical_mesh():
    """(dcn, ch) 2x4 hierarchical mesh: receiver channels data-parallel
    over the host x chip product (SURVEY §5 layout)."""
    from liquid_dsp_tpu.framing.frame64 import framesync64_stream
    rng = np.random.default_rng(32)
    T, n_ch = 4096, 8
    x, _ = _frame64_stream_capture(rng, n_ch, 2, T)
    proc = framesync64_stream(T)
    carry0 = proc.init(batch_shape=(n_ch,))
    ref = _run_stream_blocks(proc, carry0, jnp.asarray(x), T)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dcn", "ch"))
    spec = P(("dcn", "ch"), None)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    cs = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, NamedSharding(
            mesh, P(("dcn", "ch"), *([None] * (np.ndim(l) - 1))))), carry0)
    got = _run_stream_blocks(proc, cs, xs, T)
    _assert_block_trees_equal(ref, got, tol=1e-3)


def test_wideband_scanner_channel_dp():
    """Full-system config sharded: polyphase analyzer + batched streaming
    receiver in ONE jitted step, batch rows on separate devices."""
    from liquid_dsp_tpu.multichannel import (firpfbch2_analyzer,
                                             firpfbch2_synthesizer)
    from liquid_dsp_tpu.framing.frame64 import FRAME64_LEN, framegen64, \
        framesync64_stream
    rng = np.random.default_rng(33)
    B, M, Tc = 8, 16, 2048
    # two blocks: the emit window trails the stream by the history
    # length, so bursts late in block 1 decode during block 2
    chans = 0.002 * _rand_cplx(rng, B, M, 2 * Tc)
    n_in = 0
    for b in range(B):
        ch = int(rng.integers(0, M))
        pos = int(rng.integers(100, Tc - FRAME64_LEN - 100))
        chans[b, ch, pos:pos + FRAME64_LEN] += framegen64(
            rng.integers(0, 256, 8).astype(np.uint8),
            rng.integers(0, 256, 64).astype(np.uint8))
        n_in += 1
    wide, _ = firpfbch2_synthesizer(M)(jnp.asarray(chans), batch_shape=(B,))
    wide = np.asarray(wide)
    Tw = M * Tc // 2

    ana = firpfbch2_analyzer(M)
    rx = framesync64_stream(Tc)

    def step(ca, cr, x):
        streams, ca2 = ana.apply(ana.params, ca, x)
        out, cr2 = rx.apply((), cr, streams)
        return out, ca2, cr2

    def run2(ca, cr, w0, w1):
        o0, ca, cr = jax.jit(step)(ca, cr, w0)
        o1, ca, cr = jax.jit(step)(ca, cr, w1)
        return [jax.tree_util.tree_map(np.asarray, o) for o in (o0, o1)]

    ca0 = ana.init(batch_shape=(B,))
    cr0 = rx.init(batch_shape=(B, M))
    w0, w1 = jnp.asarray(wide[:, :Tw]), jnp.asarray(wide[:, Tw:])
    refs = run2(ca0, cr0, w0, w1)

    mesh = Mesh(np.array(jax.devices()[:8]), ("ch",))

    def shard(l):
        return jax.device_put(l, NamedSharding(
            mesh, P("ch", *([None] * (np.ndim(l) - 1)))))
    shs = run2(jax.tree_util.tree_map(shard, ca0),
               jax.tree_util.tree_map(shard, cr0), shard(w0), shard(w1))
    total = 0
    for out_ref, out_sh in zip(refs, shs):
        v_ref, v_sh = out_ref.valid, out_sh.valid
        np.testing.assert_array_equal(v_ref, v_sh)
        total += int(v_sh.sum())
        np.testing.assert_allclose(
            np.where(v_sh[..., None], out_sh.symbols, 0),
            np.where(v_ref[..., None], out_ref.symbols, 0), atol=2e-3)
    assert total == n_in                    # every embedded burst found


def test_ofdmflex_stream_channel_dp():
    """Full-device OFDM flexframe RX sharded over channels: decoded
    message indices identical to the single-device run."""
    from liquid_dsp_tpu.framing.ofdmflexframe import ofdmflexframegen
    from liquid_dsp_tpu.framing.ofdmflex_stream import ofdmflex_rx_stream
    rng = np.random.default_rng(34)
    n_ch, T, n = 8, 4096, 64
    x = 0.01 * _rand_cplx(rng, n_ch, 2 * T)
    for c in range(n_ch):
        h = rng.integers(0, 256, 8).astype(np.uint8)
        p = rng.integers(0, 256, n).astype(np.uint8)
        f = ofdmflexframegen(h, p)
        s0 = (T - len(f) // 2 if c % 2
              else int(rng.integers(64, T - len(f) - 64)))
        x[c, s0:s0 + len(f)] += f
    proc = ofdmflex_rx_stream(T, n)
    carry0 = proc.init(batch_shape=(n_ch,))
    ref = _run_stream_blocks(proc, carry0, jnp.asarray(x), T)

    mesh = Mesh(np.array(jax.devices()[:8]), ("ch",))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("ch", None)))
    cs = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, NamedSharding(
            mesh, P("ch", *([None] * (np.ndim(l) - 1))))), carry0)
    got = _run_stream_blocks(proc, cs, xs, T)
    for oa, ob in zip(ref, got):
        va, vb = np.asarray(oa.valid), np.asarray(ob.valid)
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(
            np.asarray(oa.hdr_msgs)[va], np.asarray(ob.hdr_msgs)[vb])
        np.testing.assert_array_equal(
            np.asarray(oa.pay_msgs)[va], np.asarray(ob.pay_msgs)[vb])
    valids = np.stack([np.asarray(o.valid) for o in got])
    assert (valids.sum(axis=(0, 2)) == 1).all()


def test_flexframe_full_rx_channel_dp():
    """The full-device fixed-config flexframe receiver sharded over 8
    channel devices: identical decode products (bytes + CRC verdicts)
    vs single-device."""
    from liquid_dsp_tpu.framing.flexframe import (flexframegen,
                                                  flexframe_rx_stream)
    rng = np.random.default_rng(41)
    T, n_ch, PL = 2048, 8, 40
    proc = flexframe_rx_stream(T, PL)
    x = np.zeros((n_ch, 6 * T), np.complex64)
    sent = []
    for c in range(n_ch):
        h = rng.integers(0, 256, 14).astype(np.uint8)
        p = rng.integers(0, 256, PL).astype(np.uint8)
        f = flexframegen(h, p)
        s0 = int(rng.integers(200, 3 * T))
        x[c, s0:s0 + len(f)] += f
        sent.append((h, p))
    x += (0.003 * (rng.standard_normal(x.shape) +
                   1j * rng.standard_normal(x.shape))).astype(np.complex64)
    carry0 = proc.init(batch_shape=(n_ch,))
    ref = _run_stream_blocks(proc, carry0, jnp.asarray(x), T)

    mesh = Mesh(np.array(jax.devices()[:8]), ("ch",))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("ch", None)))
    cs = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, NamedSharding(
            mesh, P("ch", *([None] * (np.ndim(l) - 1))))), carry0)
    got = _run_stream_blocks(proc, cs, xs, T)
    _assert_block_trees_equal(ref, got, tol=1e-3)
    valids = np.stack([np.asarray(o.valid) for o in got])
    assert (valids.sum(axis=(0, 2)) == 1).all()
    # every channel's frame decoded with device CRC verdicts
    for c in range(n_ch):
        for o in got:
            v = np.asarray(o.valid)[c]
            for s in np.nonzero(v)[0]:
                assert bool(np.asarray(o.hdr_ok)[c, s])
                assert bool(np.asarray(o.pay_ok)[c, s])
                assert (np.asarray(o.pay_bytes)[c, s].astype(np.uint8)
                        == sent[c][1]).all()


def test_gmsk_full_rx_channel_dp():
    """The full-device GMSK receiver sharded over 8 channel devices."""
    from liquid_dsp_tpu.framing.gmskframe import (gmskframegen,
                                                  gmskframe_rx_stream)
    rng = np.random.default_rng(42)
    T, n_ch, PL = 2048, 8, 40
    proc = gmskframe_rx_stream(T, PL, fec1="golay2412")
    x = np.zeros((n_ch, 8 * T), np.complex64)
    sent = []
    for c in range(n_ch):
        h = rng.integers(0, 256, 8).astype(np.uint8)
        p = rng.integers(0, 256, PL).astype(np.uint8)
        f = gmskframegen(h, p, fec1="golay2412")
        s0 = int(rng.integers(200, 3 * T))
        x[c, s0:s0 + len(f)] += f
        sent.append((h, p))
    x += (0.003 * (rng.standard_normal(x.shape) +
                   1j * rng.standard_normal(x.shape))).astype(np.complex64)
    carry0 = proc.init(batch_shape=(n_ch,))
    ref = _run_stream_blocks(proc, carry0, jnp.asarray(x), T)

    mesh = Mesh(np.array(jax.devices()[:8]), ("ch",))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("ch", None)))
    cs = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, NamedSharding(
            mesh, P("ch", *([None] * (np.ndim(l) - 1))))), carry0)
    got = _run_stream_blocks(proc, cs, xs, T)
    _assert_block_trees_equal(ref, got, tol=1e-3)
    valids = np.stack([np.asarray(o.valid) for o in got])
    assert (valids.sum(axis=(0, 2)) == 1).all()


def test_flexframe_multi_rx_channel_dp():
    """The HEADER-ADAPTIVE multi-config receiver sharded over 8 channel
    devices: each channel carries a frame of a DIFFERENT registered
    config; decodes must match single-device exactly (r5)."""
    from liquid_dsp_tpu.framing.flexframe import (flexframegen,
                                                  flexframe_rx_stream_multi)
    configs = [(40, "crc32", "none", "golay2412", "qpsk"),
               (64, "crc16", "none", "hamming128", "qam16")]
    rng = np.random.default_rng(43)
    T, n_ch = 2048, 8
    proc = flexframe_rx_stream_multi(T, configs)
    x = np.zeros((n_ch, 6 * T), np.complex64)
    sent = []
    for c in range(n_ch):
        j = c % len(configs)
        pl, crc, fec0, fec1, ms = configs[j]
        h = rng.integers(0, 256, 14).astype(np.uint8)
        p = rng.integers(0, 256, pl).astype(np.uint8)
        f = flexframegen(h, p, crc=crc, fec0=fec0, fec1=fec1, ms=ms)
        s0 = int(rng.integers(200, 3 * T))
        x[c, s0:s0 + len(f)] += f
        sent.append((j, h, p))
    x += (0.003 * (rng.standard_normal(x.shape) +
                   1j * rng.standard_normal(x.shape))).astype(np.complex64)
    carry0 = proc.init(batch_shape=(n_ch,))
    ref = _run_stream_blocks(proc, carry0, jnp.asarray(x), T)

    mesh = Mesh(np.array(jax.devices()[:8]), ("ch",))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("ch", None)))
    cs = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, NamedSharding(
            mesh, P("ch", *([None] * (np.ndim(l) - 1))))), carry0)
    got = _run_stream_blocks(proc, cs, xs, T)
    _assert_block_trees_equal(ref, got, tol=1e-3)
    decoded = [False] * n_ch
    for c in range(n_ch):
        for o in got:
            v = np.asarray(o.valid)[c]
            for s in np.nonzero(v)[0]:
                j, h, p = sent[c]
                assert int(np.asarray(o.cfg_idx)[c, s]) == j
                assert bool(np.asarray(o.pay_ok)[c, s])
                assert (np.asarray(o.pay_bytes)[c, s, :len(p)]
                        .astype(np.uint8) == p).all()
                decoded[c] = True
    assert all(decoded)
