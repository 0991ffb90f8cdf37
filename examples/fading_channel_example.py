"""Channel impairments: AWGN, CFO, multipath, and log-normal shadowing
(reference channel_cccf_example.c / fading_generator_example.c /
ricek_channel_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.channel import channel
from liquid_dsp_tpu.utils.random import randricekf, randnakmf

n = 8192
tone = np.exp(1j * 0.1 * np.arange(n)).astype(np.complex64)

ch = channel(snr_db=20.0, dphi=0.001,
             multipath_taps=[1.0, 0.0, 0.2 - 0.1j],
             shadowing_std=1.0, shadowing_fd=0.01, seed=3)
y, _ = ch(jnp.asarray(tone), batch_shape=())
y = np.asarray(y)
p = np.abs(y) ** 2
print(f"tone through AWGN+CFO+multipath+shadowing: "
      f"power mean {10 * np.log10(p.mean()):+.1f} dB, "
      f"std {p.std() / p.mean():.2f} (shadowing + multipath fading)")

# Rice-K and Nakagami-m fading envelope distributions
rng = np.random.default_rng(23)
rice = randricekf(2.0, 1.0, rng=rng, size=50000)
nakm = randnakmf(1.5, 1.0, rng=rng, size=50000)
print(f"Rice(K=2):    mean envelope {rice.mean():.3f}, "
      f"E[r^2] {np.mean(rice ** 2):.3f} (omega=1)")
print(f"Nakagami(1.5): mean envelope {nakm.mean():.3f}, "
      f"E[r^2] {np.mean(nakm ** 2):.3f} (omega=1)")
