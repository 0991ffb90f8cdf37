"""CVSD audio codec round trip on a chirp
(reference cvsd_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.audio import cvsd_encode, cvsd_decode
from liquid_dsp_tpu.utils.quantization import compress_mulaw, expand_mulaw

n = 8000
t = np.arange(n)
audio = (0.5 * np.sin(2 * np.pi * 0.01 * t)).astype(np.float32)
bits = cvsd_encode(audio)
rec = cvsd_decode(bits)
a, r = audio[500:], np.asarray(rec)[500: len(audio)]
snr = 10 * np.log10(np.mean(a ** 2) / np.mean((a - r) ** 2))
print(f"CVSD: {n} samples -> {len(bits)} bits, reconstruction "
      f"SNR {snr:.1f} dB")
mu = compress_mulaw(audio, mu=255.0)
back = expand_mulaw(mu, mu=255.0)
print(f"mu-law companding round trip max err: "
      f"{np.max(np.abs(back - audio)):.2e}")
