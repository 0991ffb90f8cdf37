"""Kaiser-window FIR design: size a lowpass from (transition width,
stop-band attenuation), design it, and verify the realized response
against the spec with an FFT (reference firdes_kaiser_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.design.firdes import (
    firdes_kaiser, estimate_req_filter_len)

fc, df, as_db = 0.20, 0.05, 60.0       # cutoff, transition, attenuation
n = estimate_req_filter_len(df, as_db)
h = firdes_kaiser(n, fc, as_db)
h = h / h.sum()                        # unity passband gain

nfft = 4096
H = np.fft.fft(h, nfft)
f = np.fft.fftfreq(nfft)
mag = 20 * np.log10(np.abs(H) + 1e-16)

pass_ripple = np.ptp(mag[(np.abs(f) < fc - df / 2)])
stop_peak = mag[(np.abs(f) > fc + df / 2)].max()
print(f"kaiser lowpass: n={n} taps, fc={fc}, df={df}, As={as_db:.0f} dB")
print(f"  passband ripple : {pass_ripple:.3f} dB")
print(f"  stopband peak   : {stop_peak:.1f} dB (spec {-as_db:.0f} dB)")
assert stop_peak < -as_db + 3.0, "stop-band attenuation missed"
