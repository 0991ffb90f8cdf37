"""Kernel-layer vector primitives (the reference's L0 SIMD layer).

Reference analogs: src/dotprod/src/dotprod.c (dotprod_{rrrf,crcf,cccf}),
src/dotprod/src/sumsq.c, src/vector/src/vector_*.c.  On the device these
are element-wise ops and matmuls; XLA fuses them, so the baseline is plain
jnp.  Batched FIR correlation — the actual hot loop every liquid module
funnels into — lives in fir.py and kernels/pallas_chain.py.

Complex convolution note: the convolutions here are real; all complex FIR
paths decompose into real convolutions here (3-mult Karatsuba where it wins).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["dotprod", "sumsq", "vec_add", "vec_mul", "vec_norm", "vec_cexpj",
           "vec_init", "vec_addscalar", "vec_mulscalar", "vec_carg",
           "vec_abs", "vec_normalize",
           "conv1d_real"]


def dotprod(h, x):
    """y = sum_i h[i] * x[i] over the last axis (broadcasts leading axes).

    The reference precomputes a coefficient object (dotprod_crcf_create);
    here coefficients are just arrays closed over by jit.
    """
    return jnp.sum(h * x, axis=-1)


def sumsq(x):
    """Sum of squared magnitudes, sum |x|^2 (reference sumsq.c)."""
    if jnp.iscomplexobj(x):
        return jnp.sum(x.real * x.real + x.imag * x.imag, axis=-1)
    return jnp.sum(x * x, axis=-1)


def vec_add(x, y):
    return x + y


def vec_mul(x, y):
    return x * y


def vec_norm(x):
    """L2 norm over last axis (reference vector_norm.c)."""
    return jnp.sqrt(sumsq(x))


def vec_cexpj(theta):
    """exp(j*theta) elementwise (reference vector_trig.c)."""
    return lax.complex(jnp.cos(theta), jnp.sin(theta))


def vec_init(c, n: int):
    """Constant-filled vector (reference vector_init)."""
    return jnp.full((n,), c)


def vec_addscalar(x, c):
    """x + c elementwise (reference vector_addscalar)."""
    return x + c


def vec_mulscalar(x, c):
    """x * c elementwise (reference vector_mulscalar)."""
    return x * c


def vec_carg(x):
    """Complex phase elementwise (reference vector_trig.c carg)."""
    return jnp.angle(x)


def vec_abs(x):
    """Magnitude elementwise (reference vector_abs)."""
    return jnp.abs(x)


def vec_normalize(x):
    """Scale to unit L2 norm over the last axis (reference
    vector_normalize)."""
    return x / jnp.maximum(vec_norm(x), 1e-30)[..., None]


def conv1d_real(x, h, stride: int = 1, lhs_dilation: int = 1):
    """Valid-mode real 1-D convolution over the last axis.

    x: [..., T] float32; h: [L] float32 (convolution kernel, will be
    flipped internally so y[t] = sum_j h[j] * x[t*stride - j + L - 1]).
    Returns [..., (T - L)//stride + 1] (for lhs_dilation=1).

    This maps onto XLA's convolution via lax.conv_general_dilated.
    """
    batch_shape = x.shape[:-1]
    t = x.shape[-1]
    lhs = x.reshape((-1, 1, t))
    rhs = h[::-1].reshape((1, 1, h.shape[0])).astype(lhs.dtype)
    out = lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(stride,),
        padding="VALID",
        lhs_dilation=(lhs_dilation,),
        dimension_numbers=("NCH", "OIH", "NCH"),
    )
    return out.reshape(batch_shape + (out.shape[-1],))


def conv1d(x, h, stride: int = 1, lhs_dilation: int = 1):
    """Valid-mode 1-D convolution supporting any real/complex combination
    of input x and taps h, decomposed into real convolutions."""
    xc = jnp.iscomplexobj(x)
    hc = jnp.iscomplexobj(h)
    if not xc and not hc:
        return conv1d_real(x, h, stride, lhs_dilation)
    if xc and not hc:
        re = conv1d_real(x.real, h, stride, lhs_dilation)
        im = conv1d_real(x.imag, h, stride, lhs_dilation)
        return lax.complex(re, im)
    if not xc and hc:
        re = conv1d_real(x, h.real, stride, lhs_dilation)
        im = conv1d_real(x, h.imag, stride, lhs_dilation)
        return lax.complex(re, im)
    # complex * complex: Karatsuba — 3 real convolutions instead of 4
    k1 = conv1d_real(x.real + x.imag, h.real, stride, lhs_dilation)
    k2 = conv1d_real(x.real, h.imag - h.real, stride, lhs_dilation)
    k3 = conv1d_real(x.imag, h.imag + h.real, stride, lhs_dilation)
    return lax.complex(k1 - k3, k1 + k2)
