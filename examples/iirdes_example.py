"""IIR design sweep: butter/cheby1/cheby2/ellip/bessel lowpass responses
(reference iirdes_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.design.iirdes import iirdes
from liquid_dsp_tpu.ops.iir import iir_freqresponse

fc, order = 0.15, 5
for ftype in ("butter", "cheby1", "cheby2", "ellip", "bessel"):
    b, a = iirdes(ftype, order, fc, 0.0, 1.0, 40.0)
    f = np.array([0.0, fc / 2, 0.35])
    H = np.array([iir_freqresponse(b, a, fi) for fi in f])
    print(f"{ftype:7s} |H(0)|={abs(H[0]):.3f}  |H(fc/2)|={abs(H[1]):.3f}  "
          f"|H(0.35)|={20*np.log10(abs(H[2])+1e-12):6.1f} dB")
