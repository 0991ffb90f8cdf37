"""Fused mix+FIR+decim GPU kernel (kernel_fuse): streaming output ==
the planar fused XLA chain, including carries across block boundaries.
The kernel runs here in Pallas interpret mode; the compiled kernel is
held to the same reference on the card by chip_smoke.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from liquid_dsp_tpu import chain, fuse, kernel_fuse, planar
from liquid_dsp_tpu.design.firdes import firdes_kaiser
from liquid_dsp_tpu.fuse import _kernel_plan, _kernel_proc
from liquid_dsp_tpu.ops.fir import firfilt
from liquid_dsp_tpu.ops.kernels.pallas_chain import (
    mix_fir_decim, mix_fir_decim_reference)
from liquid_dsp_tpu.ops.nco import nco, phase_step
from liquid_dsp_tpu.ops.resample import msresamp


def _headline():
    return fuse(chain(nco(dphi=0.125, direction="down"),
                      firfilt(firdes_kaiser(64, 0.2, 60.0)),
                      firfilt(firdes_kaiser(57, 0.3, 60.0)),
                      msresamp(0.5, 60.0)))


def _kproc(fused, out_dtype=None):
    """The kernel Proc kernel_fuse builds on the GPU, in interpret mode."""
    plan = _kernel_plan(fused)
    assert plan is not None, "headline pattern must match kernel_fuse"
    return _kernel_proc(fused.name, plan, out_dtype, interpret=True)


def _run_planar(proc, blocks, batch):
    p = planar(proc)
    params = jax.tree.map(np.asarray, p.params)
    carry = p.init(batch_shape=batch)
    outs = []
    for xb in blocks:
        (yr, yi), carry = p.apply(params, carry,
                                  (jnp.asarray(xb.real.copy()),
                                   jnp.asarray(xb.imag.copy())))
        outs.append(np.asarray(yr) + 1j * np.asarray(yi))
    return np.concatenate(outs, axis=-1)


def test_kernel_matches_fused_planar_streaming():
    fused = _headline()
    k = _kproc(fused)
    rng = np.random.default_rng(0)
    B, T, nblk = 8, 2048, 3
    blocks = [(rng.standard_normal((B, T)) +
               1j * rng.standard_normal((B, T))).astype(np.complex64)
              for _ in range(nblk)]
    y_ref = _run_planar(fused, blocks, (B,))
    y_k = _run_planar(k, blocks, (B,))
    assert y_k.shape == y_ref.shape
    rms = np.sqrt(np.mean(np.abs(y_ref) ** 2))
    assert np.abs(y_k - y_ref).max() / rms < 2e-4


def test_kernel_large_tile_and_mixed_blocks():
    # blocks of different lengths (one not a multiple of the tile) must
    # continue the stream correctly through the carry
    fused = _headline()
    k = _kproc(fused)
    rng = np.random.default_rng(2)
    B = 8
    blocks = [(rng.standard_normal((B, T)) +
               1j * rng.standard_normal((B, T))).astype(np.complex64)
              for T in (4096, 1000, 2048)]
    y_ref = _run_planar(fused, blocks, (B,))
    y_k = _run_planar(k, blocks, (B,))
    assert y_k.shape == y_ref.shape
    rms = np.sqrt(np.mean(np.abs(y_ref) ** 2))
    assert np.abs(y_k - y_ref).max() / rms < 2e-4


def test_kernel_complex_entry_point():
    k = _kproc(_headline())
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((8, 2048)) +
         1j * rng.standard_normal((8, 2048))).astype(np.complex64)
    y, c = k(jnp.asarray(x), batch_shape=(8,))
    assert np.asarray(y).shape == (8, 1024)
    assert np.iscomplexobj(np.asarray(y))


def test_kernel_bf16_planes_streaming():
    # bfloat16 input/output planes: same kernel, memory layout narrowed
    # (arithmetic stays f32).  Error budget: bf16 quantization of input
    # and output, ~2^-8 relative.  Output narrowing is an EXPLICIT
    # opt-in (out_dtype="input"); the default writes f32.
    fused = _headline()
    k = _kproc(fused, out_dtype="input")
    p = planar(k)
    rng = np.random.default_rng(3)
    B, T, nblk = 8, 2048, 3
    blocks = [(rng.standard_normal((B, T)) +
               1j * rng.standard_normal((B, T))).astype(np.complex64)
              for _ in range(nblk)]
    y_ref = _run_planar(fused, blocks, (B,))
    carry = p.init(batch_shape=(B,))
    outs = []
    for xb in blocks:
        r = jnp.asarray(xb.real.copy()).astype(jnp.bfloat16)
        i = jnp.asarray(xb.imag.copy()).astype(jnp.bfloat16)
        (yr, yi), carry = p.apply((), carry, (r, i))
        assert yr.dtype == jnp.bfloat16 and yi.dtype == jnp.bfloat16
        outs.append(np.asarray(yr.astype(jnp.float32)) +
                    1j * np.asarray(yi.astype(jnp.float32)))
    y_k = np.concatenate(outs, axis=-1)
    assert y_k.shape == y_ref.shape
    rms = np.sqrt(np.mean(np.abs(y_ref) ** 2))
    assert np.abs(y_k - y_ref).max() / rms < 3e-2

    # default policy: bf16 INPUT does not silently narrow the output —
    # kernel_fuse without out_dtype emits float32 planes
    pd = planar(_kproc(fused))
    cd = pd.init(batch_shape=(B,))
    r = jnp.asarray(blocks[0].real.copy()).astype(jnp.bfloat16)
    i = jnp.asarray(blocks[0].imag.copy()).astype(jnp.bfloat16)
    (yr, yi), _ = pd.apply((), cd, (r, i))
    assert yr.dtype == jnp.float32 and yi.dtype == jnp.float32


def test_kernel_bf16_exact_for_8bit_captures():
    # cu8 sample levels (k - 127.5)/127.5 must survive the f32->bf16
    # cast without rounding (the claim behind the bf16 fast path)
    k = np.arange(256, dtype=np.float64)
    lv = ((k - 127.5) / 127.5).astype(np.float32)
    as_bf = jnp.asarray(lv).astype(jnp.bfloat16).astype(jnp.float32)
    # levels are half-integers scaled by 1/127.5: bf16's 8 significand
    # bits hold k - 127.5 exactly; the /127.5 rounds once in f32 and
    # that SAME f32 value must round-trip bf16 unchanged
    exact = np.asarray(jnp.asarray((k - 127.5).astype(np.float32))
                       .astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(exact, (k - 127.5).astype(np.float32))
    # and the normalized form is within one bf16 ulp of the f32 level
    assert np.abs(np.asarray(as_bf) - lv).max() <= 2.0 ** -8


def test_kernel_fuse_no_match_is_identity():
    p = chain(nco(dphi=0.125, direction="down", table=True),
              firfilt(firdes_kaiser(64, 0.2, 60.0)))
    assert kernel_fuse(p) is p          # table-mode NCO: no match
    q = firfilt(firdes_kaiser(64, 0.2, 60.0))
    assert kernel_fuse(q) is q          # single stage: no match
    # the CPU policy takes no kernel even when the pattern matches
    f = _headline()
    assert _kernel_plan(f) is not None and kernel_fuse(f) is f


@pytest.mark.parametrize("L", [2, 64, 144, 257])
@pytest.mark.parametrize("down", [1, 2, 4])
def test_kernel_matches_reference(L, down):
    # the kernel against its plain-JAX statement: taps from 2 to the
    # dot form's 257, every decimation the sub-tile divides, a batch
    # that is no multiple of 8, a carry that is not zero
    rng = np.random.default_rng(100 * L + down)
    B, T = 5, 1024
    h = rng.standard_normal(L).astype(np.float32)
    xr, xi, cr, ci = (rng.standard_normal(s).astype(np.float32)
                      for s in ((B, T), (B, T), (B, L - 1), (B, L - 1)))
    kw = dict(down=down, sgn=-1.0, step=phase_step(0.37))
    th = jnp.float32(1.1)
    got = mix_fir_decim(xr, xi, cr, ci, th, h, interpret=True, **kw)
    want = mix_fir_decim_reference(xr, xi, cr, ci, th, h, **kw)
    # the dot runs as three bf16 passes (~2^-16 relative per product);
    # outputs are ~sqrt(L) in size
    scale = np.sqrt(L)
    for g, w in zip(got, want):
        assert g.shape == (B, T // down)
        assert np.abs(np.asarray(g) - np.asarray(w)).max() < 1e-4 * scale


def test_kernel_bf16_planes_match_reference():
    # bfloat16 planes are read as bf16 and computed in f32: same result
    # as the reference given the same bf16-rounded input
    rng = np.random.default_rng(7)
    B, T, L = 3, 512, 144
    h = rng.standard_normal(L).astype(np.float32)
    xr = jnp.asarray(rng.standard_normal((B, T)), jnp.bfloat16)
    xi = jnp.asarray(rng.standard_normal((B, T)), jnp.bfloat16)
    z = jnp.zeros((B, L - 1), jnp.float32)
    kw = dict(down=2, sgn=1.0, step=phase_step(0.125))
    got = mix_fir_decim(xr, xi, z, z, jnp.float32(0.0), h, interpret=True,
                        **kw)
    want = mix_fir_decim_reference(xr, xi, z, z, jnp.float32(0.0), h, **kw)
    for g, w in zip(got, want):
        assert g.dtype == jnp.float32
        assert np.abs(np.asarray(g) - np.asarray(w)).max() < 1e-4 * np.sqrt(L)
