"""ASCII spectrogram of a drifting tone in noise
(reference asgram_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.fft import spgram, asgram_render

nfft = 64
q = spgram(nfft, window="hamming")
rng = np.random.default_rng(3)
carry = q.init()
for i in range(16):
    f = -0.3 + 0.6 * i / 15          # tone sweeps across the band
    t = np.arange(512)
    x = (np.exp(2j * np.pi * f * t)
         + 0.1 * (rng.standard_normal(512) + 1j * rng.standard_normal(512))
         ).astype(np.complex64)
    psd, carry = q.apply(q.params, carry, jnp.asarray(x))
    psd_db = 10 * np.log10(np.fft.fftshift(np.asarray(psd)) + 1e-12)
    print(asgram_render(psd_db) + f"  f = {f:+.2f}")
    carry = q.init()   # fresh average per line, like the reference example
