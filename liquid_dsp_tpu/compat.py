"""Reference-style naming shim.

Users migrating from the reference C library (liquid-dsp) can import
this module to find the familiar `liquid_*`/object-style names mapped to
their block-streaming equivalents.  The semantics differ only in the calling
model: reference objects stream one sample at a time; these process
blocks with explicit carries (see README).

    from liquid_dsp_tpu import compat as liquid
    h = liquid.liquid_firdes_kaiser(57, 0.2, 60.0, 0.0)
    q = liquid.firfilt_crcf_create(h)      # -> Proc
    y, carry = q(x, batch_shape=())

Where the reference distinguishes rrrf/crcf/cccf type suffixes, the
ops here are polymorphic over dtype; all suffixed aliases resolve to the
same factory.
"""
from __future__ import annotations

import numpy as np

from .design.firdes import (firdes_kaiser, firdes_prototype, firdes_rcos,
                            firdes_rrcos, firdes_rkaiser, firdes_arkaiser,
                            firdes_gmsktx, firdes_gmskrx, firdes_notch,
                            estimate_req_filter_len, estimate_req_filter_as,
                            fir_group_delay)
from .design.firdespm import firdespm, firdespm_lowpass
from .design.iirdes import (iirdes, iirdes_sos, iirdes_pll_active_lag,
                            iirdes_pll_active_pi)
from .design.windows import kaiser, hamming, hann, blackmanharris, kbd
from .ops.fir import firfilt, firdecim, firinterp, firhilb, autocorr
from .ops.fftfilt import fftfilt
from .ops.iir import iirfilt, iirfilt_sos
from .ops.nco import nco, mix_up, mix_down, pll_step
from .ops.agc import agc
from .ops.resample import (resamp, resamp2_decim, resamp2_interp,
                           msresamp, msresamp2)
from .ops.symsync import symsync
from .ops.equalize import eqlms, eqrls
from .ops.fft import fft, ifft, fft_shift, dct, dst, spgram, asgram_render
from .ops.channel import channel
from .ops.misc_filters import firfarrow, iirdecim, iirinterp, lpc
from .modem import (constellation, modulate, demodulate, demodulate_soft,
                    gmsk_modulator, gmsk_demodulator, fsk_modulator,
                    fsk_demodulator, cpfsk_modulator, cpfsk_demodulator,
                    freq_modulator, freq_demodulator, amp_modulator,
                    amp_demodulator)
from .fec import (crc_generate_key, crc_append_key, crc_check_key,
                  fec_encode, fec_decode, fec_get_enc_msg_length,
                  interleave, deinterleave, packetizer_encode,
                  packetizer_decode, packetizer_compute_enc_msg_len)
from .multichannel import (firpfbch_analyzer, firpfbch_synthesizer,
                           firpfbch2_analyzer, firpfbch2_synthesizer,
                           ofdm_params, ofdm_generate_frame,
                           ofdm_frame_sync)
from .framing import (framegen64, framesync64, flexframegen, flexframesync,
                      gmskframegen, gmskframesync, ofdmflexframegen,
                      ofdmflexframesync, qdetector_detect, symtrack,
                      symstream, msource, bpacketgen, bpacketsync)
from .utils import (MSequence, msequence_bits, scramble_data,
                    unscramble_data, compress_mulaw, expand_mulaw,
                    cvsd_encode, cvsd_decode, gradsearch)

# --- liquid-style names -----------------------------------------------------

liquid_firdes_kaiser = firdes_kaiser
liquid_firdes_prototype = firdes_prototype
liquid_firdes_rcos = firdes_rcos
liquid_firdes_rrcos = firdes_rrcos
liquid_firdes_rkaiser = firdes_rkaiser
liquid_firdes_arkaiser = firdes_arkaiser
liquid_firdes_gmsktx = firdes_gmsktx
liquid_firdes_gmskrx = firdes_gmskrx
liquid_firdes_notch = firdes_notch
liquid_iirdes = iirdes
liquid_iirdes_sos = iirdes_sos
liquid_estimate_req_filter_len = estimate_req_filter_len


def _alias_types(factory):
    """One factory serves the rrrf/crcf/cccf-suffixed create names."""
    def create(*args, **kw):
        return factory(*args, **kw)
    return create


for _base, _factory in [
        ("firfilt", firfilt), ("firdecim", firdecim),
        ("firinterp", firinterp), ("fftfilt", fftfilt),
        ("iirfilt", iirfilt), ("resamp", resamp),
        ("msresamp", msresamp), ("agc", agc), ("symsync", symsync),
        ("eqlms", eqlms), ("eqrls", eqrls), ("firfarrow", firfarrow),
        ("iirdecim", iirdecim), ("iirinterp", iirinterp),
        ("channel", channel)]:
    for _sfx in ("rrrf", "crcf", "cccf"):
        globals()[f"{_base}_{_sfx}_create"] = _alias_types(_factory)

from .ops.iir import (iirfilt_integrator, iirfilt_differentiator,  # noqa: E402
                      iirfilt_dc_blocker, iirfilt_pll)
from .ops.fir import firfilt_rect  # noqa: E402
for _sfx in ("rrrf", "crcf", "cccf"):
    globals()[f"iirfilt_{_sfx}_create_integrator"] = iirfilt_integrator
    globals()[f"iirfilt_{_sfx}_create_differentiator"] = iirfilt_differentiator
    globals()[f"iirfilt_{_sfx}_create_dc_blocker"] = iirfilt_dc_blocker
    globals()[f"iirfilt_{_sfx}_create_pll"] = iirfilt_pll
    globals()[f"firfilt_{_sfx}_create_rect"] = firfilt_rect

nco_crcf_create = nco
nco_crcf_mix_up = mix_up
nco_crcf_mix_down = mix_down

resamp2_crcf_decim_create = resamp2_decim
resamp2_crcf_interp_create = resamp2_interp
msresamp2_crcf_create = msresamp2

firpfbch_crcf_create_kaiser = firpfbch_analyzer
firpfbch2_crcf_create_kaiser = firpfbch2_analyzer

framegen64_execute = framegen64
framesync64_execute = framesync64
flexframegen_assemble = flexframegen
flexframesync_execute = flexframesync
gmskframegen_assemble = gmskframegen
gmskframesync_execute = gmskframesync
ofdmflexframegen_assemble = ofdmflexframegen
ofdmflexframesync_execute = ofdmflexframesync

msequence_create = MSequence
msequence_create_default = MSequence

from .utils.quantization import compress_cf_mulaw, expand_cf_mulaw  # noqa: F401,E402

# utility-module additions (reference liquid_* bit functions)
from .utils.bits import (bdotprod as liquid_bdotprod,              # noqa: E402,F401
                         count_ones as liquid_count_ones,
                         count_ones_mod2 as liquid_count_ones_mod2,
                         count_leading_zeros as liquid_count_leading_zeros,
                         msb_index as liquid_msb_index,
                         reverse_byte as liquid_reverse_byte,
                         reverse_uint16 as liquid_reverse_uint16,
                         reverse_uint24 as liquid_reverse_uint24,
                         reverse_uint32 as liquid_reverse_uint32,
                         repack_bytes as liquid_repack_bytes,
                         lbshift as liquid_lbshift,
                         rbshift as liquid_rbshift,
                         lbcircshift as liquid_lbcircshift,
                         rbcircshift as liquid_rbcircshift,
                         lshift as liquid_lshift,
                         rshift as liquid_rshift,
                         lcircshift as liquid_lcircshift,
                         rcircshift as liquid_rcircshift)
from .utils.sequence import bsequence_create_ccodes  # noqa: E402,F401

# math-module modular arithmetic (reference include/liquid.h:4617-4647)
from .design.special import (is_prime as liquid_is_prime,          # noqa: E402,F401
                             factor as liquid_factor,
                             unique_factor as liquid_unique_factor,
                             modpow as liquid_modpow,
                             primitive_root_prime as
                             liquid_primitive_root_prime,
                             totient as liquid_totient,
                             gcd as liquid_gcd,
                             factorial as liquid_factorialf)
from .ops.nco import unwrap_phase as liquid_unwrap_phase       # noqa: E402,F401

# scheme-name helpers (reference liquid_getopt_str2* / liquid_print_*:
# the reference maps strings to enums because its API is enum-keyed;
# this API is string-keyed, so these validate and echo the canonical
# scheme name, raising on unknown input like the reference's *_UNKNOWN)
from .fec.crc import CRC_SCHEMES                     # noqa: E402
from .fec.dispatch import FEC_SCHEMES                # noqa: E402
from .modem.linear import MODEM_SCHEMES              # noqa: E402


def _str2scheme(name: str, table, kind: str) -> str:
    s = str(name).lower()
    if s not in table:
        raise ValueError(f"unknown {kind} scheme {name!r}")
    return s


def liquid_getopt_str2crc(name: str) -> str:
    return _str2scheme(name, CRC_SCHEMES, "crc")


def liquid_getopt_str2fec(name: str) -> str:
    return _str2scheme(name, FEC_SCHEMES, "fec")


def liquid_getopt_str2mod(name: str) -> str:
    return _str2scheme(name, MODEM_SCHEMES, "modulation")


_FIRFILT_TYPES = ("kaiser", "pm", "rcos", "fexp", "fsech",
                  "farcsech", "arkaiser", "rkaiser", "rrcos", "hm3",
                  "gmsktx", "gmskrx", "rfexp", "rfsech", "rfarcsech")
# note: "unknown" is the reference's ERROR sentinel (LIQUID_FIRFILT_
# UNKNOWN), not a valid prototype — it is deliberately not listed


def liquid_getopt_str2firfilt(name: str) -> str:
    """Filter prototype names accepted by firdes_prototype (reference
    liquid_getopt_str2firfilt, src/filter/src/firdes.c:594)."""
    s = str(name).lower()
    if s not in _FIRFILT_TYPES:
        raise ValueError(f"unknown firfilt prototype {name!r}")
    return s


def liquid_print_crc_schemes():
    print("  ".join(CRC_SCHEMES))


def liquid_print_fec_schemes():
    print("  ".join(FEC_SCHEMES))


def liquid_print_modulation_schemes():
    print("  ".join(MODEM_SCHEMES))


# math / sequence / random additions (round 3 parity batch)
from .design.special import (lowergamma as liquid_lowergammaf,  # noqa: E402,F401
                             uppergamma as liquid_uppergammaf,
                             lnlowergamma as liquid_lnlowergammaf,
                             lnuppergamma as liquid_lnuppergammaf,
                             nchoosek as liquid_nchoosek,
                             marcumq1 as liquid_MarcumQ1f)
from .ops.nco import unwrap_phase2 as liquid_unwrap_phase2  # noqa: E402,F401
from .utils.sequence import msequence_create_genpoly        # noqa: E402,F401
from .utils.optim import (rosenbrock as liquid_rosenbrock,  # noqa: E402,F401
                          invgauss as liquid_invgauss,
                          multimodal as liquid_multimodal,
                          spiral as liquid_spiral)
from .utils.bits import (count_bit_errors,                  # noqa: E402,F401
                          count_bit_errors_array)
from .utils.random import (unscramble_data_soft,            # noqa: E402,F401
                           randf, randf_pdf, randf_cdf, randnf_cdf,
                           randexpf_cdf, randweibf_cdf, randgammaf_pdf,
                           randgammaf_cdf, randnakmf_pdf, randnakmf_cdf,
                           randricekf_pdf, randricekf_cdf)
from .design.iirdes import iirdes_isstable                  # noqa: E402,F401
from .modem.cpm import fsk_frequency_error                  # noqa: E402,F401

# N/A-by-design notes:
#  * framesync64_set_csma_callbacks — declared in the reference header
#    (include/liquid.h:3598) but implemented NOWHERE in its sources
#    (vestigial API); no analog needed.
#  * gmskdem_set_eq_bw — compiled out in the reference
#    (GMSKDEM_USE_EQUALIZER disabled, gmskdem.c:179-193 warns and
#    ignores); chain eqlms explicitly here instead.
