"""Planar (structure-of-arrays) execution (liquid_dsp_tpu/planar.py):
planar(proc) on (re, im) plane pairs == proc on complex arrays.
"""
import numpy as np
import jax.numpy as jnp

from liquid_dsp_tpu import chain, fuse, planar
from liquid_dsp_tpu.design.firdes import firdes_kaiser
from liquid_dsp_tpu.ops.fir import firfilt
from liquid_dsp_tpu.ops.nco import nco
from liquid_dsp_tpu.ops.resample import msresamp


def _run_complex(proc, blocks, batch):
    carry = proc.init(batch_shape=batch)
    outs = []
    for xb in blocks:
        y, carry = proc.jitted(proc.params, carry, jnp.asarray(xb))
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=-1)


def _run_planar(proc, blocks, batch):
    p = planar(proc)
    carry = p.init(batch_shape=batch)
    outs = []
    for xb in blocks:
        x = (jnp.asarray(xb.real.copy()), jnp.asarray(xb.imag.copy()))
        (yr, yi), carry = p.jitted(p.params, carry, x)
        outs.append(np.asarray(yr) + 1j * np.asarray(yi))
    return np.concatenate(outs, axis=-1)


def _blocks(n, T, batch, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(batch + (T,)) +
             1j * rng.standard_normal(batch + (T,))).astype(np.complex64)
            for _ in range(n)]


def _check(proc, T=512, rtol=2e-4):
    blocks = _blocks(3, T, (2,))
    y_c = _run_complex(proc, blocks, (2,))
    y_p = _run_planar(proc, blocks, (2,))
    assert y_p.shape == y_c.shape
    rms = np.sqrt(np.mean(np.abs(y_c) ** 2)) + 1e-30
    assert np.abs(y_p - y_c).max() / rms < rtol


def test_nco_planar_vco():
    _check(nco(dphi=0.37, direction="down"))
    _check(nco(dphi=0.37, direction="up"))


def test_nco_planar_table_mode():
    _check(nco(dphi=0.21, direction="down", table=True))


def test_firfilt_planar():
    _check(firfilt(firdes_kaiser(33, 0.2, 60.0)))


def test_fused_headline_chain_planar():
    p = chain(nco(dphi=0.125, direction="down"),
              firfilt(firdes_kaiser(64, 0.2, 60.0)),
              firfilt(firdes_kaiser(57, 0.3, 60.0)),
              msresamp(0.5, 60.0))
    _check(fuse(p), T=1024)


def test_complex_taps_karatsuba_planar():
    # complex-tap FIR runs planar-natively via the 3-conv Karatsuba split
    h = firdes_kaiser(21, 0.2, 60.0) * np.exp(
        1j * 0.3 * np.arange(21))
    p = chain(nco(dphi=0.1, direction="down"), firfilt(h.astype(np.complex64)))
    assert p.children[1].planar_apply is not None
    _check(p)


def test_wrapped_stage_roundtrip():
    # an op with no planar path (complex-coefficient IIR) gets wrapped:
    # complex at the stage boundary, planes outside
    from liquid_dsp_tpu.ops.iir import iirfilt
    b = np.array([1.0, 0.4 + 0.2j], np.complex64)
    a = np.array([1.0, -0.3], np.float32)
    p = chain(nco(dphi=0.1, direction="down"), iirfilt(b, a))
    assert p.children[1].planar_apply is None
    _check(p, rtol=1e-3)


def test_iir_planar():
    from liquid_dsp_tpu.ops.iir import iirfilt, iirfilt_sos
    from liquid_dsp_tpu.design.iirdes import iirdes, iirdes_sos
    b, a = iirdes("butter", 5, 0.2)
    _check(iirfilt(b, a), rtol=1e-3)
    B, A = iirdes_sos("ellip", 5, 0.15)
    _check(iirfilt_sos(B, A), rtol=1e-3)


def test_firdecim_firinterp_planar():
    from liquid_dsp_tpu.ops.fir import firdecim, firinterp
    _check(firdecim(4, firdes_kaiser(24, 0.1, 60.0)), T=512)
    _check(firinterp(3, firdes_kaiser(21, 0.15, 60.0)), T=512)


def test_fftfilt_planar():
    from liquid_dsp_tpu.ops.fftfilt import fftfilt
    _check(fftfilt(firdes_kaiser(57, 0.3, 60.0)), T=1024)


def test_resamp2_decim_planar():
    from liquid_dsp_tpu.ops.resample import resamp2_decim
    _check(resamp2_decim(7), T=512)


def test_mixed_rate_planar_chain():
    # interp -> filter -> halfband decim, all planar-native
    from liquid_dsp_tpu.ops.fir import firinterp
    from liquid_dsp_tpu.ops.resample import resamp2_decim
    p = chain(nco(dphi=0.2, direction="up"),
              firinterp(2, firdes_kaiser(16, 0.2, 60.0)),
              firfilt(firdes_kaiser(33, 0.25, 60.0)),
              resamp2_decim(5))
    pp = planar(p)
    # every stage should be planar-native (no _wrapped fallback)
    assert all("wrapped" not in c.name for c in pp.children)
    _check(p, T=512)


def test_agc_planar():
    from liquid_dsp_tpu.ops.agc import agc
    rng = np.random.default_rng(5)
    x = (0.1 * (rng.standard_normal((2, 400)) +
                1j * rng.standard_normal((2, 400)))).astype(np.complex64)
    _check_proc_on(agc(bandwidth=0.05), x)
    _check_proc_on(agc(bandwidth=0.05, locked=True), x)


def _check_proc_on(proc, x, rtol=2e-4):
    y_c = _run_complex(proc, [x], x.shape[:-1])
    y_p = _run_planar(proc, [x], x.shape[:-1])
    rms = np.sqrt(np.mean(np.abs(y_c) ** 2)) + 1e-30
    assert np.abs(y_p - y_c).max() / rms < rtol


def test_nco_phase_exact_over_long_blocks():
    # the in-block phase is an int32 multiple of 2^-32 turns, so sample
    # t = 2^18 - 1 is as exact as sample 0 (a float32 t*dphi loses ~1e-3
    # rad there); both the complex and the planar paths, and the carry
    # into the next block
    T = 1 << 18
    dphi = 0.37
    p = nco(dphi=dphi, direction="up")
    x = jnp.ones((T,), jnp.complex64)
    y, c = p.apply(p.params, p.init(), x)
    step = (np.round(dphi / (2 * np.pi) * 2.0 ** 32)) * 2 * np.pi / 2.0 ** 32
    t = np.arange(T, dtype=np.float64)
    want = np.exp(1j * step * t)
    assert np.abs(np.asarray(y) - want).max() < 2e-6
    (yr, yi), _ = planar(p).apply(p.params, p.init(),
                                  (jnp.ones(T), jnp.zeros(T)))
    assert np.abs(np.asarray(yr) + 1j * np.asarray(yi) - want).max() < 2e-6
    y2, _ = p.apply(p.params, c, x[:4])
    want2 = np.exp(1j * step * (T + np.arange(4)))
    assert np.abs(np.asarray(y2) - want2).max() < 2e-6
