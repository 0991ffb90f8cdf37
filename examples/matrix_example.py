"""Dense matrix operations: LU/QR/Cholesky decompositions and a linear
solve (reference matrix_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.matrix import (
    matrix_mul, matrix_inv, matrix_linsolve, matrix_ludecomp,
    matrix_qrdecomp, matrix_chol)

rng = np.random.default_rng(5)
A = rng.standard_normal((4, 4)).astype(np.float32)
b = rng.standard_normal((4, 1)).astype(np.float32)

x = matrix_linsolve(A, b)
print("linsolve residual ||Ax-b|| :", float(np.abs(A @ x - b).max()))

L, U = matrix_ludecomp(A)
print("LU residual ||A-LU||       :", float(np.abs(A - L @ U).max()))

Q, R = matrix_qrdecomp(A)
print("QR residual ||A-QR||       :", float(np.abs(A - Q @ R).max()))

S = (A @ A.T + 4 * np.eye(4)).astype(np.float32)   # SPD
Lc = matrix_chol(S)
print("chol residual ||S-LL^T||   :", float(np.abs(S - Lc @ Lc.T).max()))
print("inv check ||A·A⁻¹-I||      :",
      float(np.abs(matrix_mul(A, matrix_inv(A)) - np.eye(4)).max()))
