"""Time-sharded streaming receiver: ONE hot channel's sample stream
split across a device mesh (sequence parallelism, SURVEY §2.12) — the
history halo rides a nearest-neighbor ppermute and a frame STRADDLING
the shard boundary still decodes exactly once, identically to the
single-device receiver.  Runs on the 8-virtual-device CPU mesh; the
same code scales one channel past a card over NVLink."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import os
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from liquid_dsp_tpu.framing.frame64 import (framegen64, FRAME64_LEN,
                                            framesync64_stream)
from liquid_dsp_tpu.parallel.rx import framesync64_time_sharded
from liquid_dsp_tpu.fec.device import qpacket_soft_decoder

n = min(4, len(jax.devices()))
T = n * 4096
mesh = Mesh(np.array(jax.devices()[:n]), ("t",))

rng = np.random.default_rng(1)
hdr = rng.integers(0, 256, 8, dtype=np.uint8)
pay = rng.integers(0, 256, 64, dtype=np.uint8)
x = np.zeros(T, np.complex64)
s0 = 4096 - FRAME64_LEN // 2          # straddles the shard 0/1 boundary
x[s0:s0 + FRAME64_LEN] = np.asarray(framegen64(hdr, pay))
x += (0.004 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
      ).astype(np.complex64)

init, step = framesync64_time_sharded(T, mesh)
out, carry = jax.jit(step)(init(), jnp.asarray(x))
v = np.asarray(out.valid)
assert v.sum() == 1, "expected exactly one decode across all shards"
slot = int(np.nonzero(v)[0][0])
dev, fin = qpacket_soft_decoder(72, "crc24", "none", "golay2412", "qpsk")
buf, ok = fin(np.asarray(jax.jit(dev)(out.symbols[slot])))
assert bool(ok) and np.array_equal(buf[:8], hdr) \
    and np.array_equal(buf[8:], pay)

# single-device cross-check
rx1 = framesync64_stream(T, max_frames=4 * n)
out1, _ = rx1.apply((), rx1.init(), jnp.asarray(x))
si_s = set(np.asarray(out.sample_index)[v].tolist())
si_1 = set(np.asarray(out1.sample_index)[np.asarray(out1.valid)].tolist())
assert si_s == si_1
print(f"frame straddling the shard boundary decoded exactly once on the "
      f"{n}-shard mesh (slot {slot}, shard {slot // 4}); bytes exact; "
      f"matches the single-device receiver")
