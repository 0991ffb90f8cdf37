"""Tests for symsync (reference symsync_crcf_autotest style) and the
remaining filter components (firfarrow, iirdecim/iirinterp, lpc)."""
import numpy as np
import jax.numpy as jnp
import pytest

from liquid_dsp_tpu.ops.symsync import (
    symsync, symsync_banks, symsync_kaiser)
from liquid_dsp_tpu.ops.fir import firinterp
from liquid_dsp_tpu.ops.misc_filters import (
    firfarrow_taps, firfarrow, iirdecim, iirinterp, lpc)
from liquid_dsp_tpu.design.firdes import firdes_prototype
from liquid_dsp_tpu.design.iirdes import iirdes
from liquid_dsp_tpu.modem import constellation, modulate


def _tx_stream(n, k=2, m=5, beta=0.3, seed=0):
    rng = np.random.default_rng(seed)
    table = constellation("qpsk")
    syms = np.asarray(modulate(table, jnp.asarray(rng.integers(0, 4, n))))
    h = firdes_prototype("arkaiser", k, m, beta)
    tx = firinterp(k, h)
    x, _ = tx(jnp.asarray(syms.astype(np.complex64)), batch_shape=())
    return syms, np.asarray(x)


def _tail_err(y, syms, n, window=400, dmax=20):
    best = np.inf
    for d in range(dmax):
        L = min(len(y) - d, n)
        if L <= window:
            continue
        e = np.mean(np.abs(y[d + L - window: d + L] -
                           syms[L - window: L]) ** 2)
        best = min(best, e)
    return best


class TestSymsync:
    def test_banks_shape(self):
        mf, dmf = symsync_banks("arkaiser", 2, 5, 0.3, 32)
        assert mf.shape == (32, 20) and dmf.shape == (32, 20)

    @pytest.mark.parametrize("frac", [0.0, 0.35, 0.7])
    def test_recovers_timing_offset(self, frac):
        n = 2000
        syms, x = _tx_stream(n)
        X = np.fft.fft(x)
        f = np.fft.fftfreq(len(x))
        xd = np.fft.ifft(X * np.exp(-2j * np.pi * f * frac)
                         ).astype(np.complex64)
        q = symsync("arkaiser", 2, 5, 0.3, bw=0.02)
        (y, v), _ = q(jnp.asarray(xd), batch_shape=())
        y = np.asarray(y)[np.asarray(v)]
        assert abs(len(y) - n) <= 2
        assert _tail_err(y, syms, n) < 5e-3, frac

    def test_tracks_clock_rate_mismatch(self):
        # clock mismatch of ~300 ppm applied with the library's own
        # polyphase resampler (high quality, so the error floor reflects
        # the synchronizer, not the test fixture)
        from liquid_dsp_tpu.ops.resample import resamp
        n = 3000
        syms, x = _tx_stream(n, seed=3)
        num, den = 3333, 3334
        pad = (-len(x)) % den
        xp = np.concatenate([x, np.zeros(pad, np.complex64)])
        rs = resamp((num, den), m=9, fc=0.45, as_db=80.0)
        xd, _ = rs(jnp.asarray(xp), batch_shape=())
        xd = np.asarray(xd)
        q = symsync("arkaiser", 2, 5, 0.3, bw=0.02)
        (y, v), _ = q(jnp.asarray(xd), batch_shape=())
        y = np.asarray(y)[np.asarray(v)]
        assert _tail_err(y, syms, n - 10) < 5e-3

    @pytest.mark.parametrize("frac", [0.3, 0.65])
    def test_kaiser_interpolator_variant(self, frac):
        # reference symsync_crcf_create_kaiser (symsync.c:252-289): the
        # input is ALREADY Nyquist-shaped, so the bank is a wideband
        # fractional-delay interpolator, not a matched filter.
        rng = np.random.default_rng(11)
        k, m, n = 2, 5, 1500
        table = constellation("qpsk")
        syms = np.asarray(modulate(table, jnp.asarray(
            rng.integers(0, 4, n))))
        h = firdes_prototype("kaiser", k, m, 0.5)  # full Nyquist pulse
        tx = firinterp(k, h)
        x, _ = tx(jnp.asarray(syms.astype(np.complex64)), batch_shape=())
        x = np.asarray(x)
        X = np.fft.fft(x)
        f = np.fft.fftfreq(len(x))
        xd = np.fft.ifft(X * np.exp(-2j * np.pi * f * frac)
                         ).astype(np.complex64)
        q = symsync_kaiser(k, m, bw=0.02)
        (y, v), _ = q(jnp.asarray(xd), batch_shape=())
        y = np.asarray(y)[np.asarray(v)]
        assert abs(len(y) - n) <= 2
        # normalize residual pulse gain, then compare to the symbols
        tail = y[-400:]
        tail = tail / np.mean(np.abs(tail))
        d = np.abs(tail[:, None] - np.asarray(table)[None, :]).min(axis=1)
        assert np.sqrt(np.mean(d ** 2)) < 0.05, frac

    def test_streaming_matches_oneshot(self):
        n = 512
        syms, x = _tx_stream(n, seed=4)
        q = symsync("arkaiser", 2, 5, 0.3, bw=0.02)
        (y1, v1), _ = q(jnp.asarray(x), batch_shape=())
        c = q.init(batch_shape=())
        ys, vs = [], []
        for blk in x.reshape(4, -1):
            (yb, vb), c = q.jitted(q.params, c, jnp.asarray(blk))
            ys.append(np.asarray(yb))
            vs.append(np.asarray(vb))
        y2 = np.concatenate(ys)[np.concatenate(vs)]
        y1c = np.asarray(y1)[np.asarray(v1)]
        np.testing.assert_allclose(y2, y1c, atol=1e-5)


class TestFarrow:
    def test_delay_accuracy(self):
        # delay a tone by mu and compare phase
        for mu in [-0.5, -0.2, 0.3, 0.5]:
            h = firfarrow_taps(19, mu)
            f0 = 0.05
            n = 256
            x = np.exp(2j * np.pi * f0 * np.arange(n))
            y = np.convolve(x, h)[:n]
            # measured delay from phase slope
            d = 9 + mu
            expect = x * np.exp(-2j * np.pi * f0 * d)
            err = np.mean(np.abs(y[30:] - expect[30:]) ** 2)
            assert err < 1e-4, (mu, err)

    def test_proc(self):
        q = firfarrow(19, 0.25)
        y, _ = q(jnp.ones(64, jnp.complex64), batch_shape=())
        assert np.asarray(y).shape == (64,)

    def test_invalid_mu(self):
        with pytest.raises(ValueError):
            firfarrow_taps(19, 1.5)


class TestIIRResample:
    def test_iirdecim_tone(self):
        b, a = iirdes("butter", 5, 0.2)
        q = iirdecim(2, b, a)
        n = 512
        x = np.exp(2j * np.pi * 0.05 * np.arange(n)).astype(np.complex64)
        y, _ = q(jnp.asarray(x), batch_shape=())
        y = np.asarray(y)
        assert len(y) == n // 2
        # output tone at doubled frequency
        Y = np.fft.fft(y * np.hanning(len(y)))
        fpk = np.argmax(np.abs(Y)) / len(Y)
        assert abs(fpk - 0.1) < 0.01

    def test_iirinterp_tone(self):
        b, a = iirdes("butter", 5, 0.2)
        q = iirinterp(2, b, a)
        n = 256
        x = np.exp(2j * np.pi * 0.1 * np.arange(n)).astype(np.complex64)
        y, _ = q(jnp.asarray(x), batch_shape=())
        y = np.asarray(y)
        assert len(y) == 2 * n
        Y = np.fft.fft(y * np.hanning(len(y)))
        fpk = np.argmax(np.abs(Y)) / len(Y)
        assert abs(fpk - 0.05) < 0.01
        # image at 0.45 suppressed
        f = np.arange(len(Y)) / len(Y)
        img = np.abs(Y)[np.abs(f - 0.45) < 0.02].max()
        assert img < 0.05 * np.abs(Y).max()

    def test_bad_length(self):
        b, a = iirdes("butter", 3, 0.2)
        with pytest.raises(ValueError):
            iirdecim(3, b, a)(jnp.zeros(100, jnp.complex64), batch_shape=())


class TestLPC:
    def test_predicts_ar_process(self):
        # x generated by AR(2): x[n] = 1.2 x[n-1] - 0.5 x[n-2] + w
        rng = np.random.default_rng(5)
        n = 20000
        w = rng.standard_normal(n)
        x = np.zeros(n)
        for i in range(2, n):
            x[i] = 1.2 * x[i - 1] - 0.5 * x[i - 2] + w[i]
        a, g = lpc(x, 2)
        # prediction coefficients approximate the AR model
        np.testing.assert_allclose(a, [1.0, -1.2, 0.5], atol=0.03)


class TestSymsyncGolden:
    """symsync output sample-exact vs the compiled reference
    (symsync_crcf_create_rnyquist(RRC,2,5,0.3,32) over RRC-shaped QPSK;
    symsync case in tools/gen_flexframe_golden.py) — including the full
    loop-filter/timing dynamics."""

    def test_sample_exact(self):
        import pathlib
        path = pathlib.Path(__file__).parent / "golden/flexframe_golden.npz"
        if not path.exists():
            pytest.skip("flexframe_golden.npz not generated")
        g = dict(np.load(path))
        from liquid_dsp_tpu.ops.symsync import symsync
        p = symsync("rrcos", 2, 5, 0.3, npfb=32)
        out, _ = p(jnp.asarray(g["symsync_x"]), batch_shape=())
        y, valid = out if isinstance(out, tuple) else (out, None)
        y = np.asarray(y)
        if valid is not None:
            y = y[np.asarray(valid)]
        ref = g["symsync_y"]
        assert len(y) == len(ref)
        assert np.abs(y - ref).max() < 1e-5


class TestMiscGolden:
    """Batch of golden tests vs the compiled reference (cases in tools/
    gen_flexframe_golden.py): freqmod (16-bit LUT phase), freqdem,
    autocorr, firfarrow polynomial taps, firhilb 2:1 decimator."""

    @pytest.fixture(scope="class")
    def fg(self):
        import pathlib
        path = pathlib.Path(__file__).parent / "golden/flexframe_golden.npz"
        if not path.exists():
            pytest.skip("flexframe_golden.npz not generated")
        return dict(np.load(path))

    def test_freqmod_sample_exact(self, fg):
        from liquid_dsp_tpu.modem.analog import freq_modulator
        m = np.real(fg["freqmod_m"]).astype(np.float32)
        fm = freq_modulator(0.1)
        s, _ = fm(jnp.asarray(m), batch_shape=())
        assert np.abs(np.asarray(s) - fg["freqmod_s"]).max() < 1e-5

    def test_freqdem_sample_exact(self, fg):
        from liquid_dsp_tpu.modem.analog import freq_demodulator
        fd = freq_demodulator(0.1)
        md, _ = fd(jnp.asarray(fg["freqmod_s"]), batch_shape=())
        assert np.abs(np.asarray(md) -
                      np.real(fg["freqdem_m"])).max() < 1e-5

    def test_autocorr_sample_exact(self, fg):
        from liquid_dsp_tpu.ops.fir import autocorr
        ac = autocorr(32, 4)
        r, _ = ac(jnp.asarray(fg["autocorr_x"]), batch_shape=())
        assert np.abs(np.asarray(r) - fg["autocorr_r"]).max() < 1e-4

    @pytest.mark.parametrize("ci,mu", [(0, 0.0), (1, 0.3), (2, -0.7)])
    def test_firfarrow_taps_exact(self, fg, ci, mu):
        from liquid_dsp_tpu.ops.misc_filters import firfarrow_taps
        mine = firfarrow_taps(19, mu, 0.45, 60.0)
        ref = np.real(fg[f"farrow_h_{ci}"]).astype(np.float32)
        assert np.abs(mine - ref).max() < 5e-4

    def test_firhilb_decim_sample_exact(self, fg):
        from liquid_dsp_tpu.ops.fir import firhilb
        r2c = firhilb(5, 60.0)
        xr = np.real(fg["firhilb_x"]).astype(np.float32)
        y, _ = r2c(jnp.asarray(xr), batch_shape=())
        assert np.abs(np.asarray(y) - fg["firhilb_y"]).max() < 1e-5


def _hilb_ref_windows(m, as_db):
    """hq exactly as reference firhilb.c:90-101 builds it (reversed
    odd-sample imaginary branch) plus a window helper."""
    from liquid_dsp_tpu.ops.fir import _hilbert_branches
    him, _ = _hilbert_branches(m, as_db)
    h_len = 4 * m + 1
    hq = np.array([him[h_len - 1 - i] for i in range(1, h_len, 2)])
    return him, hq


class TestFirhilbForms:
    """interp (c2r 1:2) and single-rate r2c vs a literal numpy replica
    of the reference window/dotprod loops (firhilb.c:172-300)."""

    def test_interp_sample_exact_vs_reference_loop(self):
        from liquid_dsp_tpu.ops.fir import firhilb_interp
        m, as_db, n = 5, 60.0, 200
        _, hq = _hilb_ref_windows(m, as_db)
        rng = np.random.default_rng(11)
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)
        # reference loop: w0/w1 are 2m windows, oldest first
        w0 = np.zeros(2 * m)
        w1 = np.zeros(2 * m)
        ref = np.zeros(2 * n, np.float32)
        for i in range(n):
            w0 = np.append(w0[1:], x[i].imag)
            ref[2 * i] = w0[m - 1]
            w1 = np.append(w1[1:], x[i].real)
            ref[2 * i + 1] = np.dot(hq, w1)
        q = firhilb_interp(m, as_db)
        y, _ = q(jnp.asarray(x), batch_shape=())
        assert np.abs(np.asarray(y) - ref).max() < 1e-5

    def test_r2c_sample_exact_vs_reference_loop(self):
        from liquid_dsp_tpu.ops.fir import firhilb_r2c
        m, as_db, n = 4, 60.0, 200
        _, hq = _hilb_ref_windows(m, as_db)
        rng = np.random.default_rng(12)
        x = rng.standard_normal(n).astype(np.float32)
        # reference toggle loop (firhilb.c:172-210)
        w0 = np.zeros(2 * m)
        w1 = np.zeros(2 * m)
        toggle = 0
        ref = np.zeros(n, np.complex64)
        for i in range(n):
            if toggle == 0:
                w0 = np.append(w0[1:], x[i])
                yi = w0[m - 1]
                yq = np.dot(hq, w1)
            else:
                w1 = np.append(w1[1:], x[i])
                yi = w1[m - 1]
                yq = np.dot(hq, w0)
            toggle = 1 - toggle
            ref[i] = yi + 1j * yq
        q = firhilb_r2c(m, as_db)
        y, _ = q(jnp.asarray(x), batch_shape=())
        assert np.abs(np.asarray(y) - ref).max() < 1e-5

    def test_r2c_analytic_suppresses_negative_freq(self):
        from liquid_dsp_tpu.ops.fir import firhilb_r2c
        m, n, f0 = 7, 4096, 0.17
        x = np.cos(2 * np.pi * f0 * np.arange(n)).astype(np.float32)
        q = firhilb_r2c(m, 60.0)
        y, _ = q(jnp.asarray(x), batch_shape=())
        Y = np.abs(np.fft.fft(np.asarray(y)[200:]))
        pos = Y[int(f0 * (n - 200)) - 5:int(f0 * (n - 200)) + 5].max()
        neg = Y[-int(f0 * (n - 200)) - 5:-int(f0 * (n - 200)) + 5].max()
        assert 20 * np.log10(pos / neg) > 50

    def test_interp_then_r2c_streaming_consistency(self):
        # streaming across 4 blocks must equal one-shot
        from liquid_dsp_tpu.ops.fir import firhilb_interp
        m = 5
        rng = np.random.default_rng(13)
        x = (rng.standard_normal(256) + 1j * rng.standard_normal(256)
             ).astype(np.complex64)
        q = firhilb_interp(m)
        y1, _ = q(jnp.asarray(x), batch_shape=())
        c = q.init(batch_shape=())
        parts = []
        for b in range(4):
            yb, c = q.jitted(q.params, c, jnp.asarray(x[b * 64:(b + 1) * 64]))
            parts.append(np.asarray(yb))
        assert np.abs(np.concatenate(parts) - np.asarray(y1)).max() < 1e-6

    def test_c2r_roundtrip(self):
        from liquid_dsp_tpu.ops.fir import firhilb_c2r
        x = (np.arange(8) + 1j * np.ones(8)).astype(np.complex64)
        q = firhilb_c2r()
        y, _ = q(jnp.asarray(x), batch_shape=())
        assert np.abs(np.asarray(y) - np.arange(8)).max() == 0


class TestLpcGroupDelayGolden:
    """lpc and group delay vs the compiled reference (cases in tools/
    gen_flexframe_golden.py)."""

    @pytest.fixture(scope="class")
    def fg(self):
        import pathlib
        path = pathlib.Path(__file__).parent / "golden/flexframe_golden.npz"
        if not path.exists():
            pytest.skip("flexframe_golden.npz not generated")
        return dict(np.load(path))

    def test_lpc(self, fg):
        from liquid_dsp_tpu.ops.misc_filters import lpc
        x = np.real(fg["lpc_x"]).astype(np.float32)
        a, e = lpc(x, 6)
        assert np.abs(a - np.real(fg["lpc_a"])).max() < 1e-4
        ref_e = np.real(fg["lpc_g"])
        assert np.abs(e - ref_e).max() / ref_e[0] < 1e-5

    def test_group_delay(self, fg):
        from liquid_dsp_tpu.design.firdes import (fir_group_delay,
                                                  firdes_kaiser)
        from liquid_dsp_tpu.ops.iir import iir_group_delay
        h = firdes_kaiser(21, 0.2, 60.0)
        assert abs(fir_group_delay(h, 0.1) -
                   np.real(fg["gdelay_fir"])[0]) < 1e-3
        assert abs(iir_group_delay([0.2, 0.4, 0.2], [1.0, -0.3, 0.1], 0.1)
                   - np.real(fg["gdelay_iir"])[0]) < 1e-3


class TestIirResampGolden:
    """iirdecim/iirinterp default butterworth prototypes sample-exact vs
    the compiled reference (iird/iiri cases in tools/
    gen_flexframe_golden.py)."""

    @pytest.fixture(scope="class")
    def fg(self):
        import pathlib
        path = pathlib.Path(__file__).parent / "golden/flexframe_golden.npz"
        if not path.exists():
            pytest.skip("flexframe_golden.npz not generated")
        return dict(np.load(path))

    def test_iirdecim(self, fg):
        from liquid_dsp_tpu.ops.misc_filters import iirdecim
        qd = iirdecim(2)
        yd, _ = qd(jnp.asarray(fg["iird_x"]), batch_shape=())
        assert np.abs(np.asarray(yd) - fg["iird_y"]).max() < 1e-5

    def test_iirinterp(self, fg):
        from liquid_dsp_tpu.ops.misc_filters import iirinterp
        qi = iirinterp(2)
        yi, _ = qi(jnp.asarray(fg["iird_x"]), batch_shape=())
        assert np.abs(np.asarray(yi) - fg["iiri_y"]).max() < 1e-5


class TestSymsyncFormulations:
    """The GPU policy's symsync and symtrack formulations (hoisted
    matched filters; PLL+LMS fused into the scan) against the scan-body
    forms the CPU runs: same valid pattern, outputs within the
    reassociation of the matched-filter dots."""

    @pytest.mark.parametrize("batch,T", [((2,), 1024), ((), 2048)])
    def test_hoisted_matches_scan(self, batch, T):
        from liquid_dsp_tpu.ops.symsync import symsync_banks, symsync_run
        rng = np.random.default_rng(13)
        mf, dmf = symsync_banks("arkaiser", 2, 5, 0.3, 32)
        q = symsync("arkaiser", 2, 5, 0.3, bw=0.02)
        x = (rng.standard_normal(batch + (T,))
             + 1j * rng.standard_normal(batch + (T,))).astype(np.complex64)
        c0 = q.init(batch)
        y1, v1, c1 = symsync_run(mf, dmf, c0, jnp.asarray(x), 2, bw=0.02,
                                 hoist=False)
        y2, v2, c2 = symsync_run(mf, dmf, c0, jnp.asarray(x), 2, bw=0.02,
                                 hoist=True)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
        assert np.abs(np.asarray(y1) - np.asarray(y2)).max() < 1e-4
        assert np.abs(np.asarray(c1["tau"]) -
                      np.asarray(c2["tau"])).max() < 1e-4

    def test_symtrack_fused_matches_unfused(self):
        from liquid_dsp_tpu.framing.symtrack import symtrack_stream
        rng = np.random.default_rng(33)
        B, T = 2, 1024
        x = jnp.asarray((rng.standard_normal((B, T)) +
                         1j * rng.standard_normal((B, T))
                         ).astype(np.complex64))
        outs = []
        for fused in (False, True):
            p = symtrack_stream(fused=fused)
            (y, d, v), _ = p.apply((), p.init((B,)), x)
            outs.append((np.asarray(y), np.asarray(d), np.asarray(v)))
        (ya, da, va), (yb, db, vb) = outs
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(da[va], db[vb])
        assert np.abs(ya - yb)[va].max() < 1e-3
