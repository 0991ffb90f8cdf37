"""Batched device LDPC belief propagation: a (1024, 512) regular code,
64 noisy codewords decoded in ONE jitted call (fec/ldpc.py
ldpc_decoder_device).  The reference's sumproduct.c decodes one
codeword at a time on the CPU (internal/experimental module)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import jax
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.fec.ldpc import (make_regular_ldpc,
                                     ldpc_encode_systematic,
                                     ldpc_decoder_device)

rng = np.random.default_rng(0)
n, k, B = 256, 128, 64
H = make_regular_ldpc(n, k, col_weight=3, seed=0)
dec = jax.jit(ldpc_decoder_device(H, max_iters=30, min_sum=True))

cws, llrs = [], []
sigma = 0.6
for _ in range(B):
    msg = rng.integers(0, 2, k).astype(np.uint8)
    cw, _ = ldpc_encode_systematic(H, msg)
    cws.append(cw)
    y = 1.0 - 2.0 * cw + sigma * rng.standard_normal(n)   # BPSK + AWGN
    llrs.append((2 * y / sigma ** 2).astype(np.float32))
hard, ok = dec(jnp.asarray(np.stack(llrs)))
hard = np.asarray(hard)
ok = np.asarray(ok)
n_correct = int((hard == np.stack(cws)).all(axis=-1).sum())
raw_ber = float((np.stack(llrs) < 0).astype(int).__ne__(np.stack(cws)).mean())
print(f"raw channel BER : {raw_ber:.3f}")
print(f"decoded codewords: {n_correct}/{B} "
      f"(parity ok: {int(ok.sum())}/{B})")
assert n_correct >= B - 2
