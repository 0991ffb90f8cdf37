"""Analog modems: FM (freqmod/freqdem) and AM (ampmodem).

Reference analogs (studied, not copied):
  * freqmod — src/modem/src/freqmod.c:36-60: s(t) = exp(j*2*pi*kf*sum(m));
              the reference accumulates phase in 16-bit units with a 1024-
              entry sincos table; we accumulate exactly and evaluate exp
              directly.
  * freqdem — src/modem/src/freqdem.c: m(t) = arg(r[n-1]* . r[n]) / (2*pi*kf).
  * ampmodem— src/modem/src/ampmodem.c:153-256: DSB/USB/LSB with optional
              carrier suppression; SSB via Hilbert transform; demod is
              envelope (non-suppressed) or coherent (suppressed DSB).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import Proc
from ..ops.fir import fir_apply_auto

__all__ = ["freq_modulator", "freq_demodulator", "amp_modulator",
           "amp_demodulator"]


def freq_modulator(kf: float, name: str = "freqmod") -> Proc:
    """FM modulator: real message [..., T] -> complex baseband [..., T],
    sample-exact vs the reference (freqmod.c:106-121): phase accumulates
    in 16-bit integer steps round(kf*2^16*m) and the output is a
    1024-entry sincos table lookup with 10-bit rounded indexing.  The
    integer cumsum + gather needs no transcendental per sample.  Carry: 16-bit integer phase."""
    if not (0.0 < kf <= 1.0):
        raise ValueError("FM modulation factor must be in (0, 1]")
    ref = kf * (1 << 16)
    table = np.exp(2j * np.pi * np.arange(1024, dtype=np.float64) / 1024.0
                   ).astype(np.complex64)

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape, jnp.int32)

    def apply(params, carry, m):
        import jax as _jax
        from ..platform import policy
        x = ref * m
        # C roundf: round half away from zero
        steps = jnp.trunc(x + jnp.sign(x) * 0.5).astype(jnp.int32)
        # int32 cumsum wraps mod 2^32, which preserves the value mod 2^16
        ph = (carry[..., None] + jnp.cumsum(steps, axis=-1)) & 0xFFFF
        idx = ((ph + 0x0020) >> 6) & 0x03FF
        if not policy("analog_trig"):
            y = jnp.asarray(table)[idx]        # bit-exact table lookup
        else:
            # the table IS exp(2j*pi*i/1024): evaluate the trig of the
            # QUANTIZED phase directly instead of a traced-index gather
            # (platform.py "analog_trig"); values match the f32 table
            # entries to transcendental rounding (~1e-7)
            th = idx.astype(jnp.float32) * jnp.float32(2 * np.pi / 1024)
            y = _jax.lax.complex(jnp.cos(th), jnp.sin(th))
        return y, ph[..., -1]

    return Proc(params={}, init=init, apply=apply, name=name)


def freq_demodulator(kf: float, name: str = "freqdem") -> Proc:
    """FM demodulator: m[n] = arg(conj(r[n-1]) r[n]) / (2 pi kf).
    Carry: previous sample (reference freqdem.c)."""

    def init(batch_shape=(), dtype=jnp.complex64):
        return jnp.zeros(batch_shape, jnp.complex64)

    def apply(params, carry, r):
        prev = jnp.concatenate([carry[..., None], r[..., :-1]], axis=-1)
        m = jnp.angle(jnp.conj(prev) * r + 1e-20) / (2.0 * np.pi * kf)
        return m.astype(jnp.float32), r[..., -1]

    return Proc(params={}, init=init, apply=apply, name=name)


def _hilbert_taps(m: int = 25, as_db: float = 60.0) -> np.ndarray:
    """Type-III FIR Hilbert transformer taps, length 4m+1."""
    n = 4 * m + 1
    t = np.arange(n) - (n - 1) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(t == 0, 0.0, (1 - np.cos(np.pi * t)) / (np.pi * t))
    from ..design.windows import kaiser, kaiser_beta_as
    return (h * kaiser(n, kaiser_beta_as(as_db))).astype(np.float32)


def amp_modulator(mod_index: float = 0.1, kind: str = "dsb",
                  suppressed_carrier: bool = False,
                  name: str = "ampmod") -> Proc:
    """AM modulator: real message [..., T] -> complex baseband.

    kind: 'dsb' | 'usb' | 'lsb' (reference liquid.h LIQUID_AMPMODEM_*).
    SSB analytic signal via FIR Hilbert transform (reference uses
    firhilbf_r2c, ampmodem.c:166)."""
    kind = kind.lower()
    if kind not in ("dsb", "usb", "lsb"):
        raise ValueError(f"unknown AM type {kind!r}")
    # analytic signal via the reference's split Hilbert form (firhilb
    # r2c_execute with m=9, ampmodem.c:95): in-phase = x delayed 2m
    # samples, quadrature = the odd-sampled imag branch one sample back.
    # Both fold into ONE complex-tap FIR: c[2m] = 1 (real),
    # c[1+2l] = j*him[2l+1].
    m_h = 9
    from ..design.firdes import firdes_kaiser
    h_len = 4 * m_h + 1
    hk = firdes_kaiser(h_len, 0.25, 60.0, 0.0)
    t = np.arange(h_len, dtype=np.float64) - (h_len - 1) / 2.0
    him = np.imag(hk * np.exp(1j * 0.5 * np.pi * t))
    c = np.zeros(4 * m_h, np.complex64)
    c[2 * m_h] += 1.0
    c[1 + 2 * np.arange(2 * m_h)] += 1j * him[1::2]
    hh = jnp.asarray(c)
    L = int(hh.shape[-1])

    def init(batch_shape=(), dtype=jnp.complex64):
        if kind == "dsb":
            return ()
        return {"tail_h": jnp.zeros(batch_shape + (L - 1,), jnp.float32)}

    def apply(params, carry, x):
        if kind == "dsb":
            x_hat = x.astype(jnp.complex64)
            new_carry = carry
        else:
            x_hat, tail_h = fir_apply_auto(params["hh"],
                                      carry["tail_h"].astype(x.dtype), x)
            new_carry = {"tail_h": tail_h}
            if kind == "lsb":
                x_hat = jnp.conj(x_hat)
        if not suppressed_carrier:
            x_hat = 0.5 * (x_hat + 1.0)
        return x_hat.astype(jnp.complex64), new_carry

    return Proc(params={"hh": hh}, init=init, apply=apply, name=name)


def amp_demodulator(mod_index: float = 0.1, kind: str = "dsb",
                    suppressed_carrier: bool = False,
                    name: str = "ampdem") -> Proc:
    """AM demodulator (reference ampmodem.c:199-256).

    Non-suppressed carrier: envelope detector  x = 2|y| - 1.
    Suppressed carrier:     SSB -> real part; DSB -> coherent (assumes the
    carrier was removed upstream, e.g. by an NCO/PLL stage)."""
    kind = kind.lower()

    def init(batch_shape=(), dtype=jnp.complex64):
        return ()

    def apply(params, carry, y):
        if suppressed_carrier:
            x = y.real
        else:
            x = 2.0 * jnp.abs(y) - 1.0
        return x.astype(jnp.float32), carry

    return Proc(params={}, init=init, apply=apply, name=name)
