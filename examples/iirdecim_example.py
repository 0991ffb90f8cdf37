"""IIR interpolation/decimation round trip on an in-band tone
(reference iirinterp_crcf_example.c / iirdecim_crcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.misc_filters import iirdecim, iirinterp

M, n = 4, 1024
w = 2 * np.pi * 0.04                       # well inside the 1/(2M) cutoff
s = np.exp(1j * w * np.arange(n)).astype(np.complex64)

qi = iirinterp(M, order=8)
qd = iirdecim(M, order=8)
x, _ = qi(jnp.asarray(s), batch_shape=())  # 1 -> M (tone moves to w/M)
y, _ = qd(x, batch_shape=())               # M -> 1
y = np.asarray(y) * M   # zero-stuff interp leaves a 1/M gain (reference
                        # applies none, iirinterp.c execute)

# the IIR cascade delay is not integer; compare steady-state magnitude
# and measure the group delay from the residual phase slope
seg = y[200:800]
gain = np.abs(seg).mean()
phase_err = np.unwrap(np.angle(seg / s[200:800]))
delay = -np.polyfit(np.arange(len(seg)), phase_err, 1)[0] / w
print(f"x{M} interp -> /{M} decim of a tone at {w / (2 * np.pi):.2f} "
      f"cycles/sample:")
print(f"  round-trip gain {gain:.4f} (want 1), group delay "
      f"{delay:.1f} samples, gain ripple {np.abs(seg).std():.2e}")
assert abs(gain - 1) < 0.01 and np.abs(seg).std() < 1e-2
