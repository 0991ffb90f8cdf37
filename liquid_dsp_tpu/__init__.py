"""liquid_dsp_tpu — a block-streaming software-defined-radio DSP framework
for accelerators, in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference C library (liquid-dsp v1.2.0): filter design and streaming
filters, FFT plans, resamplers, NCO mixing, AGC, equalizers, FEC, modems,
polyphase channelizers, OFDM, and full framing PHY chains — redesigned as
pure block functions with explicit carry state, shardable over device
meshes.

Package layout:
  core        — Proc abstraction: (params, carry, block) -> (out, carry)
  design/     — host-side coefficient generators (firdes, iirdes, windows)
  ops/        — streaming compute ops (fir, fft, resample, nco, agc, eq, ...)
  ops/kernels — Pallas GPU kernels (Triton route) for the hot paths
  platform    — the per-platform formulation choices, in one table
  fec/        — CRC + forward error correction + packetizer
  modem/      — linear/GMSK/FSK/analog modems
  multichannel/ — polyphase channelizers, OFDM frame PHY
  framing/    — frame generators/synchronizers (framegen64, flexframe, ...)
  parallel/   — device-mesh stream runtime (halo exchange, carry handoff)
  utils/      — buffers, sequences, packing, quantization, random
"""

__version__ = "0.1.0"

from .core import LTI, Proc, chain  # noqa: F401
from .fuse import fuse, fused_fir, kernel_fuse  # noqa: F401
from .planar import planar, to_planes, from_planes  # noqa: F401
