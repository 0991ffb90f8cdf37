"""Wideband burst scanner: a 64-channel spectrum is synthesized with
frame64 bursts hiding on a few channels (tones and noise elsewhere),
channelized back apart with the oversampled polyphase analyzer, and ALL
64 channel streams are scanned by ONE batched streaming frame64
receiver — the data-parallel story: the whole scanner is a single
jitted pipeline, channels ride the batch axis.

(The reference can only do this one channel at a time:
firpfbch2_crcf_example.c + framesync64_example.c composed by hand.)
"""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax
import jax.numpy as jnp
from liquid_dsp_tpu.multichannel import (firpfbch2_analyzer,
                                         firpfbch2_synthesizer)
from liquid_dsp_tpu.framing.frame64 import (FRAME64_LEN, framegen64,
                                            framesync64_stream)
from liquid_dsp_tpu.framing.qpacket import qpacketmodem_decode

rng = np.random.default_rng(42)
M = 64                     # channels
n_ch = 8192                # samples per channel stream
burst_channels = {5: 2, 23: 1, 40: 3}   # channel -> number of bursts

# --- build the per-channel baseband streams -------------------------
chans = (0.002 * (rng.standard_normal((M, n_ch)) +
                  1j * rng.standard_normal((M, n_ch)))).astype(np.complex64)
chans[10] += 0.5 * np.exp(2j * np.pi * 0.05 * np.arange(n_ch)
                          ).astype(np.complex64)        # an interferer tone
sent = {}
for ch, n_bursts in burst_channels.items():
    pos = 200
    for b in range(n_bursts):
        header = np.frombuffer(f"ch{ch:02d}b{b}##".encode(), np.uint8)[:8]
        payload = rng.integers(0, 256, 64).astype(np.uint8)
        frame = framegen64(header, payload)
        chans[ch, pos:pos + FRAME64_LEN] += frame
        sent.setdefault(ch, []).append((header.copy(), payload.copy()))
        pos += FRAME64_LEN + rng.integers(400, 900)

# --- synthesize ONE wideband stream, then take it apart again -------
synth = firpfbch2_synthesizer(M)
wideband, _ = synth(jnp.asarray(chans), batch_shape=())
ana = firpfbch2_analyzer(M)
streams, _ = ana(jnp.asarray(np.asarray(wideband)), batch_shape=())
streams = np.asarray(streams)[:, :n_ch]       # [M, n_ch] channel streams

# --- ONE batched streaming receiver scans all 64 channels -----------
block = 4096
rx = framesync64_stream(block)
carry = jax.jit(lambda: rx.init(batch_shape=(M,)))()
step = jax.jit(rx.apply)
pad = (-streams.shape[-1]) % block + 2 * block      # flush the history
x = np.concatenate([streams, np.zeros((M, pad), np.complex64)], axis=-1)
found = {}
for blk in np.split(x, x.shape[-1] // block, axis=-1):
    out, carry = step((), carry, jnp.asarray(np.ascontiguousarray(blk)))
    o = jax.tree_util.tree_map(np.asarray, out)
    for ch in range(M):
        for p in np.nonzero(o.valid[ch])[0]:
            data, ok = qpacketmodem_decode(o.symbols[ch, p], 72, "crc24",
                                           "none", "golay2412", "qpsk")
            if ok:
                found.setdefault(ch, []).append(
                    (data[:8], data[8:], float(o.evm_db[ch, p])))

print(f"scanned {M} channels x {n_ch} samples in one batched pipeline")
n_ok = 0
for ch in sorted(found):
    for hdr, pay, evm in found[ch]:
        tag = hdr.tobytes().decode(errors="replace")
        match = any(np.array_equal(hdr, h) and np.array_equal(pay, p)
                    for h, p in sent.get(ch, []))
        n_ok += match
        print(f"  ch {ch:2d}: frame '{tag}' EVM {evm:6.1f} dB "
              f"{'(payload verified)' if match else '(UNEXPECTED)'}")
n_sent = sum(len(v) for v in sent.values())
print(f"{n_ok}/{n_sent} transmitted bursts recovered, "
      f"{sum(len(v) for v in found.values()) - n_ok} false decodes")
assert n_ok == n_sent
