"""Complementary (Golay) code pairs: autocorrelation sidelobes cancel
exactly (reference complementary_codes_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.sequence import bsequence_create_ccodes

n = 64
a, b = bsequence_create_ccodes(n)
sa, sb = 2.0 * a - 1, 2.0 * b - 1
ra = np.correlate(sa, sa, "full")
rb = np.correlate(sb, sb, "full")
s = ra + rb
print(f"complementary pair, {n} bits each")
print(f"individual worst sidelobe: a {np.abs(np.delete(ra, n-1)).max():.0f}, "
      f"b {np.abs(np.delete(rb, n-1)).max():.0f}")
print(f"summed: peak {s[n-1]:.0f}, worst sidelobe "
      f"{np.abs(np.delete(s, n-1)).max():.0f} (exactly zero — the "
      f"defining property)")
