"""Bit-level utilities: repack between symbol widths, shifts, counts
(reference repack_bytes_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.bits import (repack_bytes, count_ones, msb_index,
                                       lbcircshift)

rng = np.random.default_rng(24)
# pack 8-bit bytes into 6-bit symbols and back
data = rng.integers(0, 256, 12).astype(np.uint8)
sym6 = repack_bytes(data, 8, 6)
back = repack_bytes(sym6, 6, 8)[: len(data)]
print(f"{len(data)} bytes -> {len(sym6)} 6-bit symbols -> back: "
      f"{np.array_equal(back, data)}")

v = 0b11010010
print(f"count_ones(0b11010010) = {count_ones(v)}")
print(f"msb_index(0b11010010)  = {msb_index(v)}")
arr = np.array([0b10000000, 0b00000001], np.uint8)
print(f"circular shift by 3: {[bin(int(b)) for b in lbcircshift(arr, 3)]}")
