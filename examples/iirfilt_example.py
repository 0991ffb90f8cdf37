"""IIR (SOS cascade) filtering of a noisy two-tone signal
(reference iirfilt_crcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.design.iirdes import iirdes_sos
from liquid_dsp_tpu.ops.iir import iirfilt_sos

n = 4096
t = np.arange(n)
x = (np.exp(2j * np.pi * 0.03 * t) +          # in band
     np.exp(2j * np.pi * 0.31 * t)            # out of band
     ).astype(np.complex64)
B, A = iirdes_sos("ellip", 7, 0.1, 0.0, 0.1, 60.0)
q = iirfilt_sos(B, A)
y, _ = q(jnp.asarray(x), batch_shape=())
Y = np.abs(np.fft.fft(np.asarray(y)[n // 2:]))
p_in = Y[int(0.03 * (n // 2))]
p_out = Y[int(0.31 * (n // 2))]
print(f"in-band tone kept:   {20*np.log10(p_in / (n//2)):6.1f} dB")
print(f"out-of-band removed: {20*np.log10(p_out / (n//2) + 1e-12):6.1f} dB")
