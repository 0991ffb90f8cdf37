"""Multi-source signal generation with runtime control, viewed through
the streaming spectrogram (reference msource_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.framing.sources import Msource
from liquid_dsp_tpu.ops.fft import spgram_psd_oneshot

q = Msource(seed=0)
tone = q.add_tone(fc=-0.30, gain_db=-3)
q.add_noise(fc=0.00, bandwidth=0.10, gain_db=-20)
q.add_modem(fc=0.20, ms="qpsk", gain_db=0)

x1 = q.generate(1 << 15)
q.set_frequency(tone, -0.10)      # retune the tone mid-stream
q.set_gain(tone, -9.0)
x2 = q.generate(1 << 15)

for label, x in (("before retune", x1), ("after retune", x2)):
    psd = np.asarray(spgram_psd_oneshot(jnp.asarray(x), nfft=512))
    f = np.fft.fftshift(np.fft.fftfreq(512))
    pk = f[np.argmax(psd)]
    print(f"{label}: strongest emitter at {pk:+.3f} cycles/sample; "
          f"{q.num_sources} active sources")
