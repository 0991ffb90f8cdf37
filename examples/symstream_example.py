"""Streaming pulse-shaped symbol source: arbitrary-length generation
with persistent state (reference symstreamcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing.sources import Symstream

src = Symstream(ftype="arkaiser", k=2, m=7, beta=0.3, ms="qpsk",
                gain_db=-6.0)
# odd request sizes: internal symbol-rate buffering carries the remainder
chunks = [src.generate(n) for n in (100, 37, 463, 1000)]
x = np.concatenate(chunks)
print(f"generated {len(x)} samples in {len(chunks)} odd-sized requests")
print(f"rms level: {20 * np.log10(np.sqrt(np.mean(np.abs(x) ** 2))):+.1f} dB "
      f"(gain set to -6 dB)")

# spectrum is confined to ~(1+beta)/2 of Nyquist at 2 samples/symbol
X = np.fft.fftshift(np.fft.fft(x * np.hanning(len(x))))
f = np.linspace(-0.5, 0.5, len(x), endpoint=False)
inband = np.mean(np.abs(X[np.abs(f) < 0.3]) ** 2)
outband = np.mean(np.abs(X[np.abs(f) > 0.4]) ** 2)
print(f"in-band/out-of-band power ratio: "
      f"{10 * np.log10(inband / outband):.0f} dB")
src.set_gain(0.0)
y = src.generate(512)
print(f"after retune to 0 dB: rms "
      f"{20 * np.log10(np.sqrt(np.mean(np.abs(y) ** 2))):+.1f} dB")
