"""Multi-stage arbitrary resampling (reference msresamp_crcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.resample import msresamp, as_rational

rate = (8, 3)
q = msresamp(rate, 60.0)
num, den = as_rational(rate)
n = 48 * den
x = np.exp(2j * np.pi * 0.02 * np.arange(n)).astype(np.complex64)
y, _ = q(jnp.asarray(x), batch_shape=())
print(f"resampled {n} -> {np.asarray(y).shape[-1]} samples "
      f"(rate {num}/{den} = {num/den:.4f})")
