"""Pipeline a receiver chain across device groups: each stage owns a
device, blocks stream through (SURVEY.md §2.12; no reference analog —
the reference is single-threaded).

Run with JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4
for a 4-device virtual mesh."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import os
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
import numpy as np
import jax
import jax.numpy as jnp
from liquid_dsp_tpu import chain
from liquid_dsp_tpu.design.firdes import firdes_kaiser
from liquid_dsp_tpu.ops.fir import firfilt
from liquid_dsp_tpu.ops.nco import nco
from liquid_dsp_tpu.ops.resample import resamp2_decim
from liquid_dsp_tpu.parallel.pipeline import StagePipeline

stages = [nco(dphi=0.31, direction="down"),
          firfilt(firdes_kaiser(48, 0.2, 60.0)),
          resamp2_decim(7)]
print(f"devices: {len(jax.devices())}; stages: {len(stages)}")

rng = np.random.default_rng(20)
blocks = (rng.standard_normal((8, 1024)) +
          1j * rng.standard_normal((8, 1024))).astype(np.complex64)

pipe = StagePipeline(stages, batch_shape=())
y_pipe = np.concatenate([np.asarray(b) for b in pipe.run(blocks)], axis=-1)

mono = chain(*stages)
c = mono.init(batch_shape=())
outs = []
for b in blocks:
    yb, c = mono.jitted(mono.params, c, jnp.asarray(b))
    outs.append(np.asarray(yb))
y_mono = np.concatenate(outs, axis=-1)
print(f"pipelined output == single-device chain: "
      f"{np.allclose(y_pipe, y_mono, atol=1e-5)} "
      f"({y_pipe.shape[-1]} samples)")
