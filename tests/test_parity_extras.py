"""Round-3 parity batch: incomplete-gamma family, distribution CDFs,
optim test objectives, unwrap_phase2, msequence genpoly, isstable,
count_bit_errors, soft descrambler, sparse bool x float, FSK frequency
error, scheme-name helpers.

Reference analogs cited per test (studied, not copied)."""
import math

import numpy as np
import pytest

from liquid_dsp_tpu.design.special import (lowergamma, uppergamma,
                                           lnlowergamma, gamma as lgamma_fn,
                                           nchoosek, marcumq1)
from liquid_dsp_tpu.utils import optim, random as lrandom
from liquid_dsp_tpu.utils.bits import count_bit_errors, count_bit_errors_array
from liquid_dsp_tpu.utils.sequence import (MSequence, msequence_bits,
                                           msequence_create_genpoly)
from liquid_dsp_tpu.utils.matrix import SMatrix
from liquid_dsp_tpu.design.iirdes import iirdes, iirdes_isstable
from liquid_dsp_tpu.ops.nco import unwrap_phase2


class TestGammaFamily:
    # reference src/math/src/math.gamma.c

    def test_lowergamma_vs_scipy(self):
        from scipy.special import gammainc, gamma as sgamma
        for z in (0.5, 1.0, 2.0, 3.7, 9.0):
            for a in (0.1, 0.5, 1.0, 2.5, 8.0):
                want = gammainc(z, a) * sgamma(z)   # unnormalized lower
                got = float(lowergamma(z, a))
                assert got == pytest.approx(want, rel=2e-5), (z, a)

    def test_upper_plus_lower_is_gamma(self):
        for z in (0.8, 1.5, 4.0):
            for a in (0.3, 1.0, 3.0):
                total = float(lowergamma(z, a) + uppergamma(z, a))
                assert total == pytest.approx(float(lgamma_fn(z)), rel=1e-4)

    def test_lnlowergamma_vectorizes(self):
        out = lnlowergamma(2.0, np.asarray([0.5, 1.0, 2.0]))
        assert out.shape == (3,)
        assert np.all(np.diff(out) > 0)    # monotone in alpha

    def test_nchoosek(self):
        # reference liquid_nchoosek (math.c): exact small, lgamma large
        for n, k in ((5, 2), (10, 3), (12, 6), (30, 7), (64, 3)):
            assert nchoosek(n, k) == float(math.comb(n, k))
        assert nchoosek(7, 0) == 1.0 and nchoosek(7, 7) == 1.0
        with pytest.raises(ValueError):
            nchoosek(3, 5)

    def test_marcumq1_limits(self):
        # Q1(a, b->0) -> 1 (incl. EXACTLY b=0); Q1(0+, b) = exp(-b^2/2)
        assert float(marcumq1(1.0, 1e-6)) == pytest.approx(1.0, abs=1e-5)
        assert float(marcumq1(1.0, 0.0)) == 1.0
        assert float(marcumq1(1e-9, 2.0)) == pytest.approx(
            math.exp(-2.0), rel=1e-5)

    def test_marcumq1_large_ab(self):
        # a fixed 64-term Bessel series gave percent-level
        # error for alpha*beta > ~400; term count now scales with a*b
        # and lnbesseli is log-sum-exp (no under/overflow).  References
        # are scipy ncx2.sf(b^2, 2, a^2) == Q1(a, b).
        from scipy import stats
        for a, b in ((10.0, 12.0), (20.0, 25.0), (30.0, 28.0),
                     (40.0, 41.0)):
            ref = stats.ncx2.sf(b * b, 2, a * a)
            assert float(marcumq1(a, b)) == pytest.approx(ref, rel=1e-9)

    def test_large_alpha_no_overflow(self):
        # the series terms reach exp(alpha): linear accumulation
        # overflowed for alpha >~ 710 (review finding); CDFs must
        # saturate to 1 instead of raising
        from liquid_dsp_tpu.utils.random import (randgammaf_cdf,
                                                 randnakmf_cdf)
        assert float(randgammaf_cdf(800.0, 2.0, 1.0)) == pytest.approx(1.0)
        assert float(randnakmf_cdf(30.0, 1.0, 1.0)) == pytest.approx(1.0)
        assert float(lowergamma(2.0, 1000.0)) == pytest.approx(1.0)

    def test_nchoosek_exact_large(self):
        # the reference's rounded-lgamma branch is off by one for many
        # (n, k); ours must stay exact (review finding: C(48,23))
        assert nchoosek(48, 23) == float(math.comb(48, 23))
        assert nchoosek(67, 30) == float(math.comb(67, 30))


class TestDistributionCdfs:
    # reference src/random/src/rand*.c *_pdf/_cdf

    def test_uniform(self):
        assert lrandom.randf_cdf(-0.5) == 0.0
        assert lrandom.randf_cdf(0.25) == 0.25
        assert lrandom.randf_cdf(2.0) == 1.0
        assert lrandom.randf_pdf(0.5) == 1.0 and lrandom.randf_pdf(1.5) == 0.0
        x = lrandom.randf(np.random.default_rng(0), 256)
        assert x.min() >= 0 and x.max() < 1

    def test_normal_cdf(self):
        from scipy.stats import norm
        x = np.linspace(-3, 3, 13)
        got = lrandom.randnf_cdf(x, eta=0.5, sig=2.0)
        assert np.allclose(got, norm.cdf(x, 0.5, 2.0), atol=1e-6)

    def test_exp_weib_cdf(self):
        from scipy.stats import expon, weibull_min
        x = np.linspace(0, 5, 11)
        assert np.allclose(lrandom.randexpf_cdf(x, 1.3),
                           expon.cdf(x, scale=1 / 1.3), atol=1e-6)
        assert np.allclose(lrandom.randweibf_cdf(x, 2.0, 1.5),
                           weibull_min.cdf(x, 2.0, scale=1.5), atol=1e-6)

    def test_gamma_pdf_cdf(self):
        from scipy.stats import gamma as sg
        x = np.linspace(0.05, 8, 17)
        a, b = 2.5, 1.2
        assert np.allclose(lrandom.randgammaf_pdf(x, a, b),
                           sg.pdf(x, a, scale=b), rtol=2e-4)
        assert np.allclose(lrandom.randgammaf_cdf(x, a, b),
                           sg.cdf(x, a, scale=b), rtol=2e-4, atol=1e-6)

    def test_nakagami_pdf_cdf(self):
        from scipy.stats import nakagami
        x = np.linspace(0.05, 3, 13)
        m, omega = 2.0, 1.5
        assert np.allclose(lrandom.randnakmf_pdf(x, m, omega),
                           nakagami.pdf(x, m, scale=np.sqrt(omega)),
                           rtol=2e-4)
        assert np.allclose(lrandom.randnakmf_cdf(x, m, omega),
                           nakagami.cdf(x, m, scale=np.sqrt(omega)),
                           rtol=2e-4, atol=1e-6)

    def test_rice_pdf_cdf(self):
        from scipy.stats import rice
        K, omega = 4.0, 1.0
        s = np.sqrt(omega * K / (K + 1))
        sig = np.sqrt(0.5 * omega / (K + 1))
        x = np.linspace(0.3, 2.2, 9)
        assert np.allclose(lrandom.randricekf_pdf(x, K, omega),
                           rice.pdf(x, s / sig, scale=sig), rtol=1e-3)
        # CDF within the reference's guard bands (alpha/beta ratio < 3)
        got = lrandom.randricekf_cdf(x, K, omega)
        want = rice.cdf(x, s / sig, scale=sig)
        assert np.allclose(got, want, atol=2e-3)

    def test_samplers_match_cdfs(self):
        # KS-style: empirical CDF of each sampler tracks its cdf fn
        rng = np.random.default_rng(42)
        n = 20000
        for draw, cdf in (
            (lambda: lrandom.randgammaf(4.0, 0.8, rng=rng, size=n),
             lambda x: lrandom.randgammaf_cdf(x, 4.0, 0.8)),
            (lambda: lrandom.randnakmf(1.5, 1.0, rng=rng, size=n),
             lambda x: lrandom.randnakmf_cdf(x, 1.5, 1.0)),
        ):
            xs = np.sort(np.asarray(draw(), np.float64))
            emp = (np.arange(n) + 0.5) / n
            dev = np.abs(cdf(xs) - emp).max()
            assert dev < 0.02, dev


class TestOptimUtilities:
    # reference src/optim/src/utilities.c:34-140

    def test_rosenbrock(self):
        assert optim.rosenbrock([1.0, 1.0, 1.0]) == 0.0
        assert optim.rosenbrock([1.0]) == 0.0
        v = np.asarray([0.5, -0.2, 1.3])
        want = sum((1 - v[i]) ** 2 + 100 * (v[i + 1] - v[i] ** 2) ** 2
                   for i in range(2))
        assert optim.rosenbrock(v) == pytest.approx(want)
        with pytest.raises(ValueError):
            optim.rosenbrock([])

    def test_invgauss(self):
        assert optim.invgauss([1.0, 1.0]) == 0.0
        v = np.asarray([0.0, 2.0, 1.0])
        t = (1.0 / 1.0 + 1.0 / 1.5 ** 2 + 0.0)
        assert optim.invgauss(v) == pytest.approx(1 - math.exp(-t))

    def test_multimodal(self):
        assert optim.multimodal(np.zeros(4)) == pytest.approx(0.0)
        # half-integer points sit on local maxima of the cost
        assert optim.multimodal([0.5]) == pytest.approx(
            1.0 - 0.0 * math.exp(-0.5 ** 2 / 16))

    def test_spiral(self):
        assert optim.spiral([0.3]) == pytest.approx(0.09)
        v = [0.4, -0.1, 0.2]
        r = math.hypot(0.4, -0.1)
        delta = math.atan2(-0.1, 0.4) - 10 * r
        while delta > math.pi:
            delta -= 2 * math.pi
        while delta < -math.pi:
            delta += 2 * math.pi
        delta /= math.pi
        want = 1 - delta * delta * math.exp(-r * r / 10) + 0.2 ** 2
        assert optim.spiral(v) == pytest.approx(want)

    def test_searchers_minimize_them(self):
        x, fx = optim.gradsearch(optim.rosenbrock, np.asarray([0.0, 0.0]),
                                 n_iters=4000)
        assert fx < optim.rosenbrock([0.0, 0.0])


class TestUnwrapPhase2:
    # reference src/nco/src/nco.utilities.c:45-70

    @staticmethod
    def _reference_loop(theta):
        th = np.asarray(theta, np.float64).copy()
        n = len(th)
        dphi = np.sum(np.diff(th)) / (n - 1)
        for i in range(1, n):
            while (th[i] - th[i - 1]) > math.pi + dphi:
                th[i] -= 2 * math.pi
            while (th[i] - th[i - 1]) < -math.pi + dphi:
                th[i] += 2 * math.pi
        return th

    def test_matches_reference_walk(self):
        rng = np.random.default_rng(3)
        true = np.cumsum(0.4 + 0.2 * rng.standard_normal(200))
        wrapped = np.mod(true + np.pi, 2 * np.pi) - np.pi
        got = np.asarray(unwrap_phase2(wrapped.astype(np.float32)))
        want = self._reference_loop(wrapped)
        assert np.allclose(got, want, atol=1e-3)

    def test_recovers_steep_ramp(self):
        # ramp steeper than pi/sample: plain unwrap CANNOT follow it,
        # the bias-aware version can
        n = 300
        true = 2.45 * np.arange(n)  # defeats (-pi, pi] diff window
        wrapped = np.mod(true + np.pi, 2 * np.pi) - np.pi
        got = np.asarray(unwrap_phase2(wrapped.astype(np.float32)))
        d = np.diff(got)
        assert np.allclose(d, 2.45, atol=1e-3)


class TestSequenceExtras:
    def test_create_genpoly_matches_default(self):
        # full-form generator for m=5 is 0x25 (x^5+x^2+1); the default
        # table entry is its internal (clipped) form 0x12
        ms = msequence_create_genpoly(0x25)
        bits = np.asarray([ms.advance() for _ in range(31)], np.uint8)
        assert np.array_equal(bits, msequence_bits(5))

    def test_full_period(self):
        ms = msequence_create_genpoly(0x43)   # m=6, x^6+x+1
        n = (1 << 6) - 1
        seq = [ms.advance() for _ in range(2 * n)]
        assert seq[:n] == seq[n:]             # periodic
        assert sum(seq[:n]) == 32             # balance property: 2^(m-1)

    def test_state_roundtrip(self):
        ms = MSequence(7)
        [ms.advance() for _ in range(13)]
        s = ms.get_state()
        a = [ms.advance() for _ in range(20)]
        ms.set_state(s)
        b = [ms.advance() for _ in range(20)]
        assert a == b

    def test_genpoly_rejects_trivial(self):
        with pytest.raises(ValueError):
            msequence_create_genpoly(1)


class TestBitErrors:
    def test_words(self):
        assert count_bit_errors(0b1011, 0b1011) == 0
        assert count_bit_errors(0b1011, 0b0010) == 2
        assert count_bit_errors(0xFFFF, 0x0000) == 16

    def test_array(self):
        a = np.asarray([0x00, 0xFF, 0x0F], np.uint8)
        b = np.asarray([0x01, 0xFF, 0xF0], np.uint8)
        assert count_bit_errors_array(a, b) == 1 + 0 + 8
        with pytest.raises(ValueError):
            count_bit_errors_array(a, b[:2])


class TestSoftDescrambler:
    def test_hard_soft_consistency(self):
        # bytes -> scramble -> expand to hard soft-bits -> soft
        # descramble -> pack == original (reference scramble.c contract)
        rng = np.random.default_rng(9)
        data = rng.integers(0, 256, 32, dtype=np.uint8)
        scr = lrandom.scramble_data(data)
        soft = np.unpackbits(scr).astype(np.uint8) * 255
        desoft = lrandom.unscramble_data_soft(soft)
        back = np.packbits((desoft > 127).astype(np.uint8))
        assert np.array_equal(back, data)

    def test_soft_levels_flip(self):
        # a mask bit flips x -> 255 - x exactly
        soft = np.full(64, 100, np.uint8)
        out = lrandom.unscramble_data_soft(soft)
        assert set(out.tolist()) == {100, 155}


class TestSmatrixFloat:
    def test_vmulf(self):
        A = SMatrix(3, 4, dtype=bool)
        A.set(0, 1, True)
        A.set(2, 3, True)
        x = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
        y = A.vmulf(x)
        assert np.allclose(y, [2.0, 0.0, 4.0])

    def test_mulf(self):
        A = SMatrix(2, 2, dtype=bool)
        A.set(0, 0, True)
        A.set(1, 1, True)
        B = SMatrix(2, 2, dtype=bool)
        B.set(0, 1, True)
        C = A.mulf(B)
        assert np.allclose(C, [[0, 1], [0, 0]])


class TestIirdesIsStable:
    def test_stable_butterworth(self):
        b, a = iirdes("butter", 5, 0.2)
        assert iirdes_isstable(b, a)

    def test_unstable(self):
        # pole at z = 1.5
        assert not iirdes_isstable([1.0, 0.0], [1.0, -1.5])
        with pytest.raises(ValueError):
            iirdes_isstable([1.0], [1.0])


class TestFskFrequencyError:
    def test_sign_tracks_offset(self):
        import jax.numpy as jnp
        from liquid_dsp_tpu.modem.cpm import (fsk_modulator,
                                              fsk_frequency_error)
        m, k = 2, 16
        mod = fsk_modulator(m, k)
        rng = np.random.default_rng(5)
        syms = rng.integers(0, 1 << m, 64)
        y, _ = mod(jnp.asarray(syms), batch_shape=())
        got, ferr0 = fsk_frequency_error(y, m, k)
        assert np.array_equal(np.asarray(got), syms)
        assert np.abs(np.asarray(ferr0)).mean() < 0.2
        # positive CFO biases the magnitude derivative positive
        t = np.arange(y.shape[-1])
        cfo = np.exp(1j * 2 * np.pi * 0.004 * t).astype(np.complex64)
        _, ferr_p = fsk_frequency_error(jnp.asarray(np.asarray(y) * cfo), m, k)
        _, ferr_n = fsk_frequency_error(jnp.asarray(np.asarray(y) *
                                                    np.conj(cfo)), m, k)
        assert np.mean(np.asarray(ferr_p)) > np.mean(np.asarray(ferr0))
        assert np.mean(np.asarray(ferr_n)) < np.mean(np.asarray(ferr0))


class TestSchemeHelpers:
    def test_str2(self):
        from liquid_dsp_tpu import compat as liquid
        assert liquid.liquid_getopt_str2fec("v27") == "v27"
        assert liquid.liquid_getopt_str2crc("crc32") == "crc32"
        assert liquid.liquid_getopt_str2mod("qam16") == "qam16"
        assert liquid.liquid_getopt_str2firfilt("arkaiser") == "arkaiser"
        with pytest.raises(ValueError):
            # the reference's error sentinel, not a valid prototype
            liquid.liquid_getopt_str2firfilt("unknown")
        for fn in (liquid.liquid_getopt_str2fec, liquid.liquid_getopt_str2crc,
                   liquid.liquid_getopt_str2mod,
                   liquid.liquid_getopt_str2firfilt):
            with pytest.raises(ValueError):
                fn("nope")

    def test_print_helpers(self, capsys):
        from liquid_dsp_tpu import compat as liquid
        liquid.liquid_print_fec_schemes()
        liquid.liquid_print_crc_schemes()
        liquid.liquid_print_modulation_schemes()
        out = capsys.readouterr().out
        assert "v27" in out and "crc32" in out and "qam16" in out
