"""Dense matrix math and sparse matrices.

Reference analog (studied, not copied): reference src/matrix/src/
(matrix.*.c: add/aug/mul/trans/LU/QR/Cholesky/inverse/linsolve/cgsolve/
gramschmidt; smatrix.c sparse bool/float/int).

Thin, explicitly-named wrappers over jnp linear algebra with the
reference's conventions (row-major flat arrays in the
golden vectors; Doolittle LU with P*A = L*U; reduced QR; lower Cholesky).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "matrix_add", "matrix_sub", "matrix_mul", "matrix_aug",
    "matrix_trans", "matrix_hermitian", "matrix_transmul",
    "matrix_multrans", "matrix_inv", "matrix_linsolve", "matrix_cgsolve",
    "matrix_ludecomp", "matrix_qrdecomp", "matrix_chol",
    "matrix_gramschmidt", "SMatrix",
]


def matrix_add(a, b):
    return jnp.asarray(a) + jnp.asarray(b)


def matrix_sub(a, b):
    return jnp.asarray(a) - jnp.asarray(b)


def matrix_mul(a, b):
    return jnp.asarray(a) @ jnp.asarray(b)


def matrix_aug(a, b):
    """[A | B] (reference matrixf_aug)."""
    return jnp.concatenate([jnp.asarray(a), jnp.asarray(b)], axis=-1)


def matrix_trans(a):
    return jnp.swapaxes(jnp.asarray(a), -1, -2)


def matrix_hermitian(a):
    return jnp.conj(matrix_trans(a))


def matrix_transmul(a):
    """A^H A (reference matrix_transmul)."""
    a = jnp.asarray(a)
    return matrix_hermitian(a) @ a


def matrix_multrans(a):
    """A A^H (reference matrix_multrans)."""
    a = jnp.asarray(a)
    return a @ matrix_hermitian(a)


def matrix_inv(a):
    return jnp.linalg.inv(jnp.asarray(a))


def matrix_linsolve(a, b):
    """Solve A x = b."""
    return jnp.linalg.solve(jnp.asarray(a), jnp.asarray(b))


def matrix_cgsolve(a, b, max_iters: int | None = None, tol: float = 1e-6):
    """Conjugate-gradient solve for symmetric positive definite A
    (reference matrix.cgsolve.c)."""
    A = jnp.asarray(a)
    b = jnp.asarray(b).reshape(-1)
    n = b.shape[0]
    iters = max_iters or 4 * n
    x = jnp.zeros_like(b)
    r = b - A @ x
    p = r
    rs = jnp.vdot(r, r).real
    for _ in range(iters):
        Ap = A @ p
        alpha = rs / jnp.maximum(jnp.vdot(p, Ap).real, 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.vdot(r, r).real
        p = r + (rs_new / jnp.maximum(rs, 1e-30)) * p
        rs = rs_new
    return x


def matrix_ludecomp(a):
    """Doolittle LU without pivoting (reference matrix.ludecomp.c):
    A = L U with unit-diagonal L.  Returns (L, U)."""
    A = np.array(a, dtype=np.result_type(np.asarray(a).dtype, np.float64))
    n = A.shape[0]
    L = np.eye(n, dtype=A.dtype)
    U = np.zeros_like(A)
    for i in range(n):
        for j in range(i, n):
            U[i, j] = A[i, j] - L[i, :i] @ U[:i, j]
        for j in range(i + 1, n):
            L[j, i] = (A[j, i] - L[j, :i] @ U[:i, i]) / U[i, i]
    return jnp.asarray(L), jnp.asarray(U)


def matrix_qrdecomp(a):
    """Reduced QR (Gram-Schmidt, reference matrix.qrdecomp.c)."""
    Q, R = jnp.linalg.qr(jnp.asarray(a))
    # fix sign convention: R diagonal non-negative (matches reference GS)
    d = jnp.sign(jnp.real(jnp.diagonal(R)))
    d = jnp.where(d == 0, 1.0, d)
    return Q * d[None, :], R * d[:, None]


def matrix_chol(a):
    """Lower-triangular Cholesky factor (reference matrix.chol.c)."""
    return jnp.linalg.cholesky(jnp.asarray(a))


def matrix_gramschmidt(a):
    """Orthonormalize the columns of A (reference matrix.gramschmidt.c)."""
    A = jnp.asarray(a)
    Q, _ = jnp.linalg.qr(A)
    # reference normalizes so each column's leading entry sign follows A
    d = jnp.sign(jnp.real(jnp.sum(jnp.conj(Q) * A, axis=0)))
    d = jnp.where(d == 0, 1.0, d)
    return Q * d[None, :]


class SMatrix:
    """Sparse matrix (reference smatrix{b,f,i}): COO-style dict of keys
    with the reference's small API surface."""

    def __init__(self, m: int, n: int, dtype=np.float32):
        self.m = m
        self.n = n
        self.dtype = dtype
        self.data: dict[tuple[int, int], object] = {}

    def set(self, i: int, j: int, v):
        if not (0 <= i < self.m and 0 <= j < self.n):
            raise IndexError("smatrix index out of range")
        if v:
            self.data[(i, j)] = self.dtype(v)
        else:
            self.data.pop((i, j), None)

    def get(self, i: int, j: int):
        return self.data.get((i, j), self.dtype(0))

    def isset(self, i: int, j: int) -> bool:
        return (i, j) in self.data

    def nnz(self) -> int:
        return len(self.data)

    def todense(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), self.dtype)
        for (i, j), v in self.data.items():
            out[i, j] = v
        return out

    def mul(self, other: "SMatrix") -> "SMatrix":
        if self.n != other.m:
            raise ValueError("smatrix dimension mismatch")
        out = SMatrix(self.m, other.n, self.dtype)
        dense = self.todense() @ other.todense()
        for i, j in zip(*np.nonzero(dense)):
            out.set(int(i), int(j), dense[i, j])
        return out

    def vmul(self, x) -> np.ndarray:
        return self.todense() @ np.asarray(x)

    def mulf(self, other: "SMatrix") -> np.ndarray:
        """Multiply treating entries as 0/1 masks over FLOAT values
        (reference smatrixb_mulf: boolean structure, float arithmetic)."""
        if self.n != other.m:
            raise ValueError("smatrix dimension mismatch")
        return (self.todense().astype(np.float32) @
                other.todense().astype(np.float32))

    def vmulf(self, x) -> np.ndarray:
        """Boolean-structure x float-vector product (reference
        smatrixb_vmulf)."""
        return self.todense().astype(np.float32) @ np.asarray(x, np.float32)
