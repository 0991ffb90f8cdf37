"""Nonlinear optimizers: gradient search, quasi-Newton, genetic
(reference gradsearch_example.c / qnsearch_example.c /
gasearch_knapsack_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.optim import gradsearch, qnsearch, gasearch


def rosenbrock(v):
    return float(np.sum(100 * (v[1:] - v[:-1] ** 2) ** 2
                        + (1 - v[:-1]) ** 2))


x0 = np.array([-1.2, 1.0, 0.5, -0.3])
for name, fn in (("gradsearch", gradsearch), ("qnsearch", qnsearch)):
    x, u = fn(rosenbrock, x0.copy(), n_iters=4000)
    print(f"{name:10s}: u={u:.3e} at {np.round(x, 3)} (optimum: ones)")

# knapsack via the genetic search: maximize value under a weight cap
rng = np.random.default_rng(10)
w = rng.uniform(1, 10, 16)
v = rng.uniform(1, 10, 16)
cap = 0.4 * w.sum()


def neg_value(bits):
    sel = np.asarray(bits) > 0.5
    if w[sel].sum() > cap:
        return 1e3 + w[sel].sum()
    return -v[sel].sum()


best, u = gasearch(neg_value, [(0.0, 1.0)] * 16, n_iters=300,
                   population=48, seed=10)
sel = np.asarray(best) > 0.5
print(f"gasearch knapsack: value {v[sel].sum():.1f}, "
      f"weight {w[sel].sum():.1f} / cap {cap:.1f}")
