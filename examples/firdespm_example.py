"""Parks-McClellan equiripple FIR design
(reference firdespm_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.design.firdespm import firdespm_lowpass
from liquid_dsp_tpu.design.firdes import fir_group_delay

h_len, fc, as_db = 55, 0.2, 60.0
h = firdespm_lowpass(h_len, fc, as_db)
H = np.fft.fft(h, 2048)
f = np.fft.fftfreq(2048)
pb = np.abs(H[np.abs(f) < fc * 0.9])
sb = np.abs(H[np.abs(f) > fc * 1.25])
print(f"{h_len}-tap equiripple lowpass, fc={fc}")
print(f"passband ripple : {20*np.log10(pb.max()/pb.min()):.3f} dB")
print(f"stopband peak   : {20*np.log10(sb.max()+1e-12):.1f} dB")
print(f"group delay     : {fir_group_delay(h, 0.0):.1f} samples "
      f"(linear phase: {(h_len-1)/2})")
