"""Channel impairments: AWGN + carrier offset + multipath + shadowing
applied to a QPSK stream, then tracked (reference channel_cccf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.framing.sources import Symstream
from liquid_dsp_tpu.ops.channel import channel
from liquid_dsp_tpu.framing.symtrack import Symtrack

x = Symstream(ms="qpsk", seed=3).generate(12288)
ch = channel(snr_db=25.0, dphi=0.002, phi=0.7,
             multipath_taps=[1.0, 0.15 - 0.1j, -0.08j], seed=1)
y, _ = ch(jnp.asarray(x), batch_shape=())
y = np.asarray(y)

st = Symtrack(block_len=2048, eq_mu=0.1)
sy, dec = st.execute(y)
tail = sy[-1000:]
evm = 10 * np.log10(np.mean(np.abs(np.abs(tail) - 1.0) ** 2) + 1e-12)
print(f"{len(x)} samples through AWGN+CFO+multipath channel")
print(f"symtrack recovered {len(sy)} symbols; tail radius error "
      f"{evm:.1f} dB")
