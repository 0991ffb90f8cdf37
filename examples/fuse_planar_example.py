"""Chain transforms: LTI fusion + planar (SoA) execution.

No reference analog — the reference's C objects are bound to their own
implementations and to interleaved complex storage.  Here a cascade
advertising LTI descriptions collapses into ONE strided FIR (fuse) and
the whole chain can run on (re, im) float32 planes (planar) — the
layout/algebra freedoms the headline chain's fast paths are built on."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax
import jax.numpy as jnp
from liquid_dsp_tpu import chain, fuse, planar
from liquid_dsp_tpu.design.firdes import firdes_kaiser
from liquid_dsp_tpu.ops.fir import firfilt
from liquid_dsp_tpu.ops.nco import nco
from liquid_dsp_tpu.ops.resample import msresamp

p = chain(nco(dphi=0.125, direction="down"),
          firfilt(firdes_kaiser(64, 0.2, 60.0)),
          firfilt(firdes_kaiser(57, 0.3, 60.0)),
          msresamp(0.5, 60.0))
f = fuse(p)
print("original stages:", [c.name for c in p.children])
print("fused    stages:", [c.name for c in f.children])
lti = f.children[1].lti
print(f"  -> one {lti.taps.shape[-1]}-tap FIR, decimate {lti.down}, "
      f"offset {lti.d}")

rng = np.random.default_rng(19)
x = (rng.standard_normal((2, 2048)) + 1j * rng.standard_normal((2, 2048))
     ).astype(np.complex64)
y_ref, _ = p(jnp.asarray(x), batch_shape=(2,))

pp = planar(f)
params = jax.tree.map(np.asarray, pp.params)
carry = pp.init(batch_shape=(2,))
(yr, yi), _ = jax.jit(pp.apply)(params, carry,
                                (jnp.asarray(x.real.copy()),
                                 jnp.asarray(x.imag.copy())))
y_pl = np.asarray(yr) + 1j * np.asarray(yi)
rms = np.sqrt(np.mean(np.abs(np.asarray(y_ref)) ** 2))
print(f"fused+planar vs original chain: rel err "
      f"{np.abs(y_pl - np.asarray(y_ref)).max() / rms:.2e} "
      f"(fp32 reassociation only)")
