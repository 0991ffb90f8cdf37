"""Streaming spectral periodogram + ASCII spectrogram
(reference spgramcf_example.c / asgram_rx example)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.fft import spgram, spgram_estimate, asgram_render
from liquid_dsp_tpu.framing import msource

x = msource(16384, [dict(kind="modem", fc=-0.2, ms="qpsk"),
                    dict(kind="tone", fc=0.3, gain_db=-6),
                    dict(kind="noise", gain_db=-30)])
q = spgram(nfft=72)
psd, c = q(jnp.asarray(x), batch_shape=())
db = np.asarray(spgram_estimate(psd))
print("PSD (dB), fftshifted:")
print(asgram_render(db))
print("modem signal at -0.2, tone at +0.3")
