"""Conjugate-gradient linear solve on a symmetric positive-definite
system (reference cgsolve_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.matrix import matrix_cgsolve, matrix_linsolve

rng = np.random.default_rng(25)
n = 16
A0 = rng.standard_normal((n, n)).astype(np.float32)
A = A0 @ A0.T + n * np.eye(n, dtype=np.float32)   # SPD, well-conditioned
x_true = rng.standard_normal(n).astype(np.float32)
b = A @ x_true

x_cg = np.asarray(matrix_cgsolve(A, b, tol=1e-6))
x_lu = np.asarray(matrix_linsolve(A, b))
print(f"{n}x{n} SPD system:")
print(f"  cgsolve  residual |Ax-b| = {np.abs(A @ x_cg - b).max():.2e}")
print(f"  linsolve residual |Ax-b| = {np.abs(A @ x_lu - b).max():.2e}")
print(f"  cg vs direct max diff    = {np.abs(x_cg - x_lu).max():.2e}")
assert np.abs(A @ x_cg - b).max() < 1e-3
