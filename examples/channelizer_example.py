"""64-channel polyphase channelizer (reference firpfbch2_crcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.multichannel import (firpfbch2_analyzer,
                                         firpfbch2_synthesizer)
from liquid_dsp_tpu.modem import constellation, modulate

M, m = 64, 4
rng = np.random.default_rng(0)
active = [4, 21, 40]
X = np.zeros((M, 64), np.complex64)
for c in active:
    X[c] = np.asarray(modulate(constellation("qpsk"),
                               jnp.asarray(rng.integers(0, 4, 64))))
y, _ = firpfbch2_synthesizer(M, m)(jnp.asarray(X), batch_shape=())
Y, _ = firpfbch2_analyzer(M, m)(y, batch_shape=())
p = np.mean(np.abs(np.asarray(Y))[:, 16:] ** 2, axis=1)
print("active channels:", active)
print("recovered top-3:", sorted(int(i) for i in np.argsort(p)[-3:]))
