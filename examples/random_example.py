"""Random distributions vs their analytic pdfs
(reference random_histogram_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils import random as lr

rng = np.random.default_rng(9)
n = 200000
cases = [
    ("normal", lr.randnf(rng=rng, size=n), lr.randnf_pdf, {}),
    ("exponential(1.3)", lr.randexpf(1.3, rng=rng, size=n), lr.randexpf_pdf,
     {"lam": 1.3}),
    ("weibull(1,2)", lr.randweibf(1.0, 2.0, rng=rng, size=n), lr.randweibf_pdf,
     {"alpha": 1.0, "beta": 2.0}),
]
for name, x, pdf, kw in cases:
    hist, edges = np.histogram(x, bins=60, density=True)
    mid = 0.5 * (edges[:-1] + edges[1:])
    ref = np.array([pdf(v, **kw) for v in mid])
    err = np.mean(np.abs(hist - ref))
    print(f"{name:18s}: mean {np.mean(x):+.3f}, "
          f"histogram-vs-pdf mean |err| {err:.4f}")
