"""Polynomial fit, Lagrange interpolation, and root finding
(reference polyfit_example.c / polyfit_lagrange_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.poly import (
    poly_fit, poly_val, poly_interp_lagrange, poly_findroots, poly_expandroots)

# least-squares fit of a cubic through noisy samples
rng = np.random.default_rng(9)
x = np.linspace(-1, 1, 31).astype(np.float32)
y = (0.2 + 1.1 * x - 0.8 * x ** 2 + 2.0 * x ** 3).astype(np.float32)
p = poly_fit(x, y + 0.001 * rng.standard_normal(31).astype(np.float32), 4)
print("cubic fit coeffs (true 0.2 1.1 -0.8 2.0):",
      np.round(np.asarray(p, dtype=np.float64), 3))

# Lagrange interpolation hits the samples exactly
xi = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
yi = np.array([1.0, 2.0, 0.0, 5.0], np.float32)
yv = poly_interp_lagrange(xi, yi, np.float32(1.5))
print(f"lagrange(1.5) = {float(yv):.4f}")

# roots of (x-1)(x-2)(x-3)
c = poly_expandroots(np.array([1.0, 2.0, 3.0], np.float32))
r = np.sort_complex(poly_findroots(c))
print("recovered roots:", np.round(r.real, 4))
