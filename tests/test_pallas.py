"""firfilt backend='matmul': the banded-tap matrix formulation against
the XLA convolution it stands in for."""
import numpy as np
import jax.numpy as jnp
import pytest

from liquid_dsp_tpu.ops.fir import fir_apply, firfilt, fir_apply_matmul
from liquid_dsp_tpu.design.firdes import firdes_kaiser


class TestMatmulFIR:
    """firfilt backend='matmul': banded-tap-matrix formulation."""

    def test_matches_xla_backend(self):
        import numpy as np
        import jax.numpy as jnp
        from liquid_dsp_tpu.ops.fir import firfilt
        from liquid_dsp_tpu.design.firdes import firdes_kaiser
        rng = np.random.default_rng(3)
        for L, T in [(64, 1000), (57, 4096), (13, 257), (1, 128)]:
            h = firdes_kaiser(L, 0.2, 60.0) if L > 1 else np.array([0.7])
            x = jnp.asarray((rng.standard_normal((3, T)) +
                             1j * rng.standard_normal((3, T))
                             ).astype(np.complex64))
            ya, _ = firfilt(h)(x, batch_shape=(3,))
            ym, _ = firfilt(h, backend="matmul")(x, batch_shape=(3,))
            assert float(jnp.max(jnp.abs(ya - ym))) < 1e-5, (L, T)

    def test_streaming_complex_taps(self):
        import numpy as np
        import jax.numpy as jnp
        from liquid_dsp_tpu.ops.fir import firfilt
        rng = np.random.default_rng(4)
        h = (rng.standard_normal(21) +
             1j * rng.standard_normal(21)).astype(np.complex64)
        x = jnp.asarray((rng.standard_normal((2, 512)) +
                         1j * rng.standard_normal((2, 512))
                         ).astype(np.complex64))
        p = firfilt(h, backend="matmul")
        y_once, _ = p(x, batch_shape=(2,))
        c = p.init(batch_shape=(2,))
        ys = []
        for blk in np.split(np.asarray(x), 4, axis=-1):
            yb, c = p.apply(p.params, c, jnp.asarray(blk))
            ys.append(np.asarray(yb))
        d = np.abs(np.concatenate(ys, -1) - np.asarray(y_once)).max()
        assert d < 1e-5

    @pytest.mark.parametrize("L,T,B", [(64, 512, 3), (13, 256, 1),
                                       (129, 384, 2)])
    def test_banded_matches_conv(self, L, T, B):
        # the banded matmul the GPU policy selects, against the conv
        # form at the shapes the removed hand-written FIR kernel covered
        rng = np.random.default_rng(L)
        h = firdes_kaiser(L, 0.2, 60.0).astype(np.float32)
        x = jnp.asarray((rng.standard_normal((B, T)) +
                         1j * rng.standard_normal((B, T))
                         ).astype(np.complex64))
        carry = jnp.asarray((rng.standard_normal((B, L - 1)) +
                             1j * rng.standard_normal((B, L - 1))
                             ).astype(np.complex64))
        y_ref, c_ref = fir_apply(jnp.asarray(h), carry, x)
        y_m, c_m = fir_apply_matmul(jnp.asarray(h), carry, x)
        assert np.abs(np.asarray(y_m) - np.asarray(y_ref)).max() < 1e-4
        assert np.abs(np.asarray(c_m) - np.asarray(c_ref)).max() < 1e-6

    def test_firfilt_matmul_golden(self, golden):
        d = golden("firfilt_crcf_data_h13x32")
        q = firfilt(d["h"], backend="matmul")
        y, _ = q(jnp.asarray(d["x"]), batch_shape=())
        assert np.abs(np.asarray(y) - d["y"]).max() <= 1e-3

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError):
            firfilt(np.ones(8, np.float32), backend="pallas")
