"""Data scrambling and m-sequence properties
(reference scramble_example.c / msequence_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.random import scramble_data, unscramble_data
from liquid_dsp_tpu.utils.sequence import msequence_bits

# scrambling whitens a constant payload
x = np.zeros(32, np.uint8)            # worst case: all zeros
s = np.asarray(scramble_data(x))
u = np.asarray(unscramble_data(s))
ones = np.unpackbits(s).mean()
print(f"scrambled all-zero payload: bit density {ones:.2f} (want ~0.5)")
print(f"unscramble round trip ok: {np.array_equal(u, x)}")

# m-sequence: balanced, two-valued autocorrelation
m = 7
bits = msequence_bits(m)              # period 2^m - 1
n = len(bits)
b = 2.0 * bits - 1
r = np.array([np.dot(b, np.roll(b, k)) for k in range(n)]) / n
print(f"msequence m={m}: period {n}, ones {int(bits.sum())} "
      f"(balanced: {int(bits.sum()) == (n + 1) // 2})")
print(f"autocorrelation: r[0]={r[0]:.3f}, max off-peak {np.abs(r[1:]).max():.3f} "
      f"(ideal -1/{n} = {-1 / n:.3f})")
