"""Channel impairment model: AWGN, carrier offset, multipath, shadowing.

Reference analog (studied, not copied): channel_cccf
(reference src/channel/src/channel.c:33-296): composable impairments —
AWGN (noise floor + SNR), carrier frequency/phase offset, multipath FIR,
log-normal shadowing through a one-pole lowpass.

Design: one pure Proc whose carry holds the mixer phase, the
multipath filter tail, the shadowing filter state, and the PRNG key —
the whole block of impairments is applied vectorized; randomness is
jax.random (explicit key in the carry, so runs are reproducible and
shardable).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import Proc, scan_unroll
from .fir import fir_apply_auto
from ..utils.random import jax_crandn

__all__ = ["channel"]


def channel(snr_db: float | None = None, noise_floor_db: float = -60.0,
            dphi: float = 0.0, phi: float = 0.0,
            multipath_taps=None, shadowing_std: float = 0.0,
            shadowing_fd: float = 0.1, seed: int = 0,
            name: str = "channel") -> Proc:
    """Build a channel Proc (reference channel_cccf_create + add_*).

    snr_db: if set, adds AWGN with gain gamma = 10^((noise_floor+snr)/20)
    applied to the signal and noise at the floor level (reference
    channel.c _add_awgn:136).
    """
    h = None
    if multipath_taps is not None:
        h = jnp.asarray(np.asarray(multipath_taps, np.complex64))
    nstd = 10.0 ** (noise_floor_db / 20.0)
    gamma = (10.0 ** ((noise_floor_db + snr_db) / 20.0)
             if snr_db is not None else 1.0)
    # one-pole shadowing filter coefficient from Doppler (channel.c)
    beta_sh = float(np.exp(-2 * np.pi * shadowing_fd)) if shadowing_std else 0.0

    def init(batch_shape=(), dtype=jnp.complex64):
        c = {"key": jax.random.PRNGKey(seed),
             "theta": jnp.zeros(batch_shape, jnp.float32)}
        if h is not None:
            c["mp_tail"] = jnp.zeros(batch_shape + (h.shape[-1] - 1,), dtype)
        if shadowing_std:
            c["sh_state"] = jnp.zeros(batch_shape, jnp.float32)
        return c

    def apply(params, carry, x):
        T = x.shape[-1]
        y = x
        new_carry = dict(carry)
        # multipath
        if h is not None:
            y, new_carry["mp_tail"] = fir_apply_auto(
                params["h"], carry["mp_tail"].astype(y.dtype), y)
        # shadowing: slow log-normal gain fluctuation
        if shadowing_std:
            key, k1 = jax.random.split(carry["key"])
            w = jax.random.normal(k1, y.shape[:-1] + (T,))

            def step(s, wt):
                s = beta_sh * s + np.sqrt(1 - beta_sh ** 2) * wt
                return s, s

            sh, seq = jax.lax.scan(step, carry["sh_state"],
                                   jnp.moveaxis(w, -1, 0), unroll=scan_unroll(16))
            g_db = shadowing_std * jnp.moveaxis(seq, 0, -1)
            y = y * (10.0 ** (g_db / 20.0)).astype(y.dtype)
            new_carry["sh_state"] = sh
            new_carry["key"] = key
        # carrier offset
        if dphi != 0.0 or phi != 0.0:
            t = jnp.arange(T)
            th = carry["theta"][..., None] + dphi * t + phi
            y = y * jnp.exp(1j * th).astype(y.dtype)
            new_carry["theta"] = jnp.mod(carry["theta"] + dphi * T,
                                         2 * np.pi)
        # signal gain + AWGN
        if snr_db is not None:
            key, k2 = jax.random.split(new_carry.get("key", carry["key"]))
            # noise power nstd^2 total (reference cawgn: nstd*crandn/sqrt2)
            y = gamma * y + nstd * jax_crandn(k2, y.shape) / np.sqrt(2)
            new_carry["key"] = key
        return y.astype(jnp.complex64), new_carry

    params = {"h": h} if h is not None else {}
    return Proc(params=params, init=init, apply=apply, name=name)
