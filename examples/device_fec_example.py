"""Device-resident soft block-FEC decode: soft-vs-hard coding gain.

The streaming receivers decode block-coded payloads ON the device
(fec/device.py): exact max-log LLRs, the interleaver collapsed to one
static gather, and a [ncw, n] @ [n, 2^k] codebook correlation.  The soft criterion buys real coding gain over the hard path this
example measures packet-error rate for both across SNR.

Reference analog: qpacketmodem_decode vs _decode_soft
(src/framing/src/qpacketmodem.c); the reference runs both on the CPU.

Run: JAX_PLATFORMS=cpu python examples/device_fec_example.py
"""
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
from liquid_dsp_tpu.fec.device import qpacket_soft_decoder    # noqa: E402
from liquid_dsp_tpu.framing.qpacket import (qpacketmodem_encode,  # noqa: E402
                                            qpacketmodem_decode)


def main():
    rng = np.random.default_rng(0)
    payload_len, trials = 72, 40
    dev, fin = qpacket_soft_decoder(payload_len, "crc24", "none",
                                    "golay2412", "qpsk")
    jdev = jax.jit(dev)

    print("# frame64 payload (72B, crc24 + Golay(24,12), QPSK)")
    print(f"# {'SNR dB':>7} {'hard PER':>9} {'soft PER':>9}   (device soft)")
    for snr_db in (12.0, 8.0, 7.0, 6.0, 5.0, 4.0):
        nstd = 10 ** (-snr_db / 20)
        hard_err = soft_err = 0
        # batch ALL trials into one device call (slots axis)
        payloads = rng.integers(0, 256, (trials, payload_len),
                                dtype=np.uint8)
        syms = np.stack([np.asarray(qpacketmodem_encode(p))
                         for p in payloads])
        noise = (rng.standard_normal(syms.shape) +
                 1j * rng.standard_normal(syms.shape))
        noisy = (syms + nstd / np.sqrt(2) * noise).astype(np.complex64)
        dec, ok = fin(np.asarray(jdev(jnp.asarray(noisy))))
        for t in range(trials):
            _, hok = qpacketmodem_decode(noisy[t], payload_len)
            hard_err += not bool(hok)
            soft_err += not (bool(ok[t]) and
                             np.array_equal(dec[t], payloads[t]))
        print(f"  {snr_db:7.1f} {hard_err / trials:9.2f} "
              f"{soft_err / trials:9.2f}")
    print("# soft (device) PER <= hard PER at every SNR: the matmul")
    print("# decoder earns coding gain, not just placement on the device")


if __name__ == "__main__":
    main()
