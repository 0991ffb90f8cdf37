"""CPFSK spectra: occupied bandwidth vs modulation index and pulse shape
(reference cpfsk_psd_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.modem.cpm import cpfsk_modulator
from liquid_dsp_tpu.ops.fft import fft

bps, k, n_sym = 1, 4, 4000
rng = np.random.default_rng(2)
syms = rng.integers(0, 1 << bps, n_sym)


def rms_bw(x):
    """RMS bandwidth sqrt(sum p f^2) from the full-length spectrum."""
    p = np.abs(np.asarray(fft(jnp.asarray(x)))) ** 2
    p /= p.sum()
    f = np.fft.fftfreq(len(x))
    return float(np.sqrt(np.sum(p * f ** 2)))


print(f"binary CPFSK, k={k} samples/symbol: RMS bandwidth")
for h, kind in ((0.5, "square"), (0.5, "rcos_full"), (0.5, "gmsk"),
                (0.25, "square")):
    mod = cpfsk_modulator(bps, h, k, m=3, kind=kind)
    x, _ = mod(jnp.asarray(syms), batch_shape=())
    x = np.asarray(x)
    # constant envelope is the point of CPM
    env = np.abs(x)
    print(f"  h={h:4.2f} {kind:9s}: RMS BW {rms_bw(x):.4f} cycles/sample, "
          f"envelope ripple {env.std():.2e}")
    assert env.std() < 1e-5
# smaller modulation index packs tighter
mod_a = cpfsk_modulator(bps, 0.5, k, kind="square")
mod_b = cpfsk_modulator(bps, 0.25, k, kind="square")
xa, _ = mod_a(jnp.asarray(syms), batch_shape=())
xb, _ = mod_b(jnp.asarray(syms), batch_shape=())
assert rms_bw(np.asarray(xb)) < rms_bw(np.asarray(xa))
