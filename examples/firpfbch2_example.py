"""Oversampled polyphase channelizer: analysis + synthesis is (nearly)
perfect reconstruction (reference firpfbch2_crcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.multichannel.channelizer import (firpfbch2_analyzer,
                                                     firpfbch2_synthesizer)

M, m = 16, 4
qa = firpfbch2_analyzer(M, m)
qs = firpfbch2_synthesizer(M, m)

rng = np.random.default_rng(14)
n = 16384
x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
     ).astype(np.complex64)
Y, _ = qa(jnp.asarray(x), batch_shape=())      # [M, 2n/M]: M/2-hop streams
y, _ = qs(Y, batch_shape=())
y = np.asarray(y)

delay = 2 * M * m - M // 2 + 1                 # analysis+synthesis delay
err = y[delay:n] - x[: n - delay]
print(f"M={M} channels (x2 oversampled), m={m}: {Y.shape[0]} streams "
      f"of {Y.shape[1]} samples")
print(f"reconstruction error "
      f"{10 * np.log10(np.mean(np.abs(err) ** 2) / np.mean(np.abs(x) ** 2)):.1f}"
      f" dB after {delay}-sample delay")
chan_power = np.mean(np.abs(np.asarray(Y)) ** 2, axis=-1)
print(f"per-channel power spread (white input -> flat): "
      f"{chan_power.min() / chan_power.mean():.2f}.."
      f"{chan_power.max() / chan_power.mean():.2f}")
assert np.mean(np.abs(err) ** 2) < 1e-4
