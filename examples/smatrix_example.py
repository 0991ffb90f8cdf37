"""Sparse matrix create/multiply vs dense (reference smatrix_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.matrix import SMatrix

rng = np.random.default_rng(17)
m, n = 12, 16
s = SMatrix(m, n)
dense = np.zeros((m, n), np.float32)
for _ in range(20):
    i, j = rng.integers(0, m), rng.integers(0, n)
    v = float(rng.standard_normal())
    s.set(int(i), int(j), v)
    dense[i, j] = v

v = rng.standard_normal(n).astype(np.float32)
y_sparse = s.vmul(v)
y_dense = dense @ v
print(f"{m}x{n} sparse matrix, {s.nnz()} non-zeros "
      f"({100.0 * s.nnz() / (m * n):.0f}% fill)")
print(f"sparse mul == dense mul: "
      f"{np.allclose(y_sparse, y_dense, atol=1e-5)}")
print(f"dense round trip matches: "
      f"{np.array_equal(s.todense(), dense)}")
