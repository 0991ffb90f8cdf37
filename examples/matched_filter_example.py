"""Matched filtering: root-Nyquist TX/RX pair gives zero ISI at symbol
instants (reference matched_filter_example.c / nyquist_filter_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.design.firdes import firdes_prototype

k, m, beta = 2, 7, 0.3
for ftype in ("rrcos", "arkaiser", "hM3"):
    h = firdes_prototype(ftype, k, m, beta)
    # composite TX*RX response sampled at symbol instants
    comp = np.convolve(h, h[::-1]) / k
    center = len(comp) // 2
    sym_taps = comp[center % k::k] if k else comp
    peaks = comp[center::k]          # t = 0, 1, 2, ... symbols
    isi = np.abs(peaks[1:]).max() / peaks[0]
    print(f"{ftype:9s}: composite peak {peaks[0]:.3f}, "
          f"worst ISI at symbol instants {20 * np.log10(isi + 1e-12):6.1f} dB")
