"""Block state-space IIR backend: the off-CPU default formulation
(Toeplitz-of-impulse-response matmul + T/L state scan) matches the
sequential scan to float rounding, as matmuls instead of a per-sample
loop.  No reference analog — the reference executes
IIR filters one sample at a time (iirfilt.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.design.iirdes import iirdes_sos
from liquid_dsp_tpu.ops.iir import iirfilt_sos

rng = np.random.default_rng(0)
x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
     ).astype(np.complex64)
B, A = iirdes_sos("butter", 7, 0.2)
y_scan, c_scan = iirfilt_sos(B, A, backend="scan")(jnp.asarray(x),
                                                   batch_shape=())
y_blk, c_blk = iirfilt_sos(B, A, backend="block")(jnp.asarray(x),
                                                  batch_shape=())
err = float(np.abs(np.asarray(y_scan) - np.asarray(y_blk)).max())
cerr = float(np.abs(np.asarray(c_scan) - np.asarray(c_blk)).max())
print(f"block vs scan output max err: {err:.2e}")
print(f"block vs scan carry  max err: {cerr:.2e} (same DF2T state)")
assert err < 1e-4 and cerr < 1e-4
