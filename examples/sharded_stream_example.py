"""Time-sharded streaming over a virtual 8-device mesh
(new capability — the reference is single-threaded)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import numpy as np
import jax
import jax.numpy as jnp

from liquid_dsp_tpu import chain
from liquid_dsp_tpu.design.firdes import firdes_kaiser
from liquid_dsp_tpu.ops.fir import firfilt
from liquid_dsp_tpu.ops.nco import nco
from liquid_dsp_tpu.parallel.mesh import stream_mesh
from liquid_dsp_tpu.parallel.stream import time_shard_apply

proc = chain(nco(dphi=0.1), firfilt(firdes_kaiser(63, 0.2, 60.0)))
mesh = stream_mesh(n_time=4, n_channel=2, devices=jax.devices()[:8])
x = jnp.asarray((np.random.randn(2, 4096) + 1j * np.random.randn(2, 4096)
                 ).astype(np.complex64))
carry = proc.init(batch_shape=(2,))
step = jax.jit(time_shard_apply(proc, mesh))
y, carry = step(carry, x)
y_ref, _ = proc.apply(proc.params, proc.init(batch_shape=(2,)), x)
print(f"8-device sharded output == single device: "
      f"max diff {float(jnp.abs(y - y_ref).max()):.2e}")
