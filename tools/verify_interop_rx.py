#!/usr/bin/env python
"""Bidirectional wire-interop proof: frames ASSEMBLED BY THIS FRAMEWORK
are decoded by the REFERENCE library's own synchronizers.

For each framer (frame64, flexframe, gmskframe, ofdmflexframe, bpacket)
this generates a frame with liquid_dsp_tpu, writes the samples to a
temp file, and runs a reference-C receiver harness on them.  The C side
prints header/payload bytes and validity flags; this script asserts
byte-perfect recovery.

Run: python tools/verify_interop_rx.py
"""
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from refbuild import build, WORK  # noqa: E402

RX_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "liquid.h"

static int got = 0;
static unsigned char rx_header[64];
static unsigned char rx_payload[4096];
static unsigned int rx_len = 0;
static int rx_hvalid = 0, rx_pvalid = 0;

static int cb(unsigned char *_header, int _header_valid,
              unsigned char *_payload, unsigned int _payload_len,
              int _payload_valid, framesyncstats_s _stats, void *_userdata)
{
    got = 1;
    rx_hvalid = _header_valid;
    rx_pvalid = _payload_valid;
    rx_len = _payload_len;
    if (_header_valid || 1) memcpy(rx_header, _header, 14);
    if (_payload_len && _payload_len < sizeof(rx_payload))
        memcpy(rx_payload, _payload, _payload_len);
    return 0;
}

int main(int argc, char **argv)
{
    // argv: <mode> <sample_file>
    const char *mode = argv[1];
    FILE *f = fopen(argv[2], "rb");
    if (!f) { fprintf(stderr, "no file\n"); return 1; }
    fseek(f, 0, SEEK_END);
    long nb = ftell(f);
    fseek(f, 0, SEEK_SET);
    unsigned int n = nb / sizeof(float complex);
    float complex *buf = (float complex*) malloc(nb);
    if (fread(buf, sizeof(float complex), n, f) != n) return 1;
    fclose(f);

    if (strcmp(mode, "frame64") == 0) {
        framesync64 fs = framesync64_create(cb, NULL);
        framesync64_execute(fs, buf, n);
        framesync64_destroy(fs);
        printf("got %d hvalid %d pvalid %d len %u\n",
               got, rx_hvalid, rx_pvalid, rx_len);
        printf("header :");
        for (unsigned i = 0; i < 8; i++) printf(" %u", rx_header[i]);
        printf("\npayload :");
        for (unsigned i = 0; i < rx_len && i < 64; i++)
            printf(" %u", rx_payload[i]);
        printf("\n");
    } else if (strcmp(mode, "flexframe") == 0) {
        flexframesync fs = flexframesync_create(cb, NULL);
        flexframesync_execute(fs, buf, n);
        flexframesync_destroy(fs);
        printf("got %d hvalid %d pvalid %d len %u\n",
               got, rx_hvalid, rx_pvalid, rx_len);
        printf("header :");
        for (unsigned i = 0; i < 14; i++) printf(" %u", rx_header[i]);
        printf("\npayload :");
        for (unsigned i = 0; i < rx_len && i < 256; i++)
            printf(" %u", rx_payload[i]);
        printf("\n");
    } else if (strcmp(mode, "gmskframe") == 0) {
        gmskframesync fs = gmskframesync_create(cb, NULL);
        gmskframesync_execute(fs, buf, n);
        gmskframesync_destroy(fs);
        printf("got %d hvalid %d pvalid %d len %u\n",
               got, rx_hvalid, rx_pvalid, rx_len);
        printf("header :");
        for (unsigned i = 0; i < 8; i++) printf(" %u", rx_header[i]);
        printf("\npayload :");
        for (unsigned i = 0; i < rx_len && i < 256; i++)
            printf(" %u", rx_payload[i]);
        printf("\n");
    } else if (strcmp(mode, "ofdmflexframe") == 0) {
        ofdmflexframesync fs = ofdmflexframesync_create(64, 16, 0, NULL,
                                                        cb, NULL);
        ofdmflexframesync_execute(fs, buf, n);
        ofdmflexframesync_destroy(fs);
        printf("got %d hvalid %d pvalid %d len %u\n",
               got, rx_hvalid, rx_pvalid, rx_len);
        printf("header :");
        for (unsigned i = 0; i < 8; i++) printf(" %u", rx_header[i]);
        printf("\npayload :");
        for (unsigned i = 0; i < rx_len && i < 256; i++)
            printf(" %u", rx_payload[i]);
        printf("\n");
    } else {
        fprintf(stderr, "unknown mode\n");
        return 1;
    }
    free(buf);
    return 0;
}
"""


def _compile_rx() -> pathlib.Path:
    archive = build()
    d = WORK / "interop_rx"
    d.mkdir(exist_ok=True)
    src = d / "rx.c"
    exe = d / "rx"
    if not exe.exists() or src.read_text() != RX_C if src.exists() else True:
        src.write_text(RX_C)
        subprocess.run(["gcc", "-O1", "-I", str(WORK),
                        "-I", str(WORK / "include"), "-o", str(exe),
                        str(src), str(archive), "-lm"], check=True)
    return exe


def _run_rx(exe, mode, samples):
    with tempfile.NamedTemporaryFile(suffix=".cf32", delete=False) as f:
        np.asarray(samples, np.complex64).tofile(f)
        path = f.name
    out = subprocess.run([str(exe), mode, path], capture_output=True,
                         text=True, timeout=120).stdout
    pathlib.Path(path).unlink()
    lines = out.strip().splitlines()
    flags = dict(zip(["got", "hvalid", "pvalid", "len"],
                     [int(v) for v in lines[0].split()[1::2]]))
    header = np.asarray([int(v) for v in
                         lines[1].split(":")[1].split()], np.uint8)
    payload = np.asarray([int(v) for v in
                          lines[2].split(":")[1].split()], np.uint8)
    return flags, header, payload


def main():
    exe = _compile_rx()
    rng = np.random.default_rng(2024)
    pad = np.zeros(200, np.complex64)
    failures = []

    # frame64
    from liquid_dsp_tpu.framing import framegen64
    hdr = rng.integers(0, 256, 8).astype(np.uint8)
    pay = rng.integers(0, 256, 64).astype(np.uint8)
    y = framegen64(hdr, pay)
    flags, rh, rp = _run_rx(exe, "frame64",
                            np.concatenate([pad, y, pad]))
    ok = flags["got"] and flags["pvalid"] and \
        np.array_equal(rh, hdr) and np.array_equal(rp, pay)
    print(f"frame64      : reference RX decoded our TX: {bool(ok)}")
    if not ok:
        failures.append("frame64")

    # flexframe
    from liquid_dsp_tpu.framing.flexframe import flexframegen
    hdr = rng.integers(0, 256, 14).astype(np.uint8)
    pay = rng.integers(0, 256, 80).astype(np.uint8)
    y = flexframegen(hdr, pay, crc="crc32", fec0="none",
                     fec1="golay2412", ms="qpsk")
    flags, rh, rp = _run_rx(exe, "flexframe",
                            np.concatenate([pad, y, pad]))
    ok = flags["got"] and flags["pvalid"] and \
        np.array_equal(rh, hdr) and np.array_equal(rp[:80], pay)
    print(f"flexframe    : reference RX decoded our TX: {bool(ok)}")
    if not ok:
        failures.append("flexframe")

    # gmskframe
    from liquid_dsp_tpu.framing.gmskframe import gmskframegen
    hdr = rng.integers(0, 256, 8).astype(np.uint8)
    pay = rng.integers(0, 256, 48).astype(np.uint8)
    y = gmskframegen(hdr, pay, crc="crc32", fec0="none", fec1="none")
    flags, rh, rp = _run_rx(exe, "gmskframe",
                            np.concatenate([pad, y, pad]))
    ok = flags["got"] and flags["pvalid"] and \
        np.array_equal(rh, hdr) and np.array_equal(rp[:48], pay)
    print(f"gmskframe    : reference RX decoded our TX: {bool(ok)}")
    if not ok:
        failures.append("gmskframe")

    # ofdmflexframe
    from liquid_dsp_tpu.framing.ofdmflexframe import ofdmflexframegen
    hdr = rng.integers(0, 256, 8).astype(np.uint8)
    pay = rng.integers(0, 256, 64).astype(np.uint8)
    y = ofdmflexframegen(hdr, pay, M=64, cp_len=16, crc="crc32",
                         fec0="none", fec1="golay2412", ms="qpsk")
    flags, rh, rp = _run_rx(exe, "ofdmflexframe",
                            np.concatenate([pad, y, pad]))
    ok = flags["got"] and flags["pvalid"] and \
        np.array_equal(rh, hdr) and np.array_equal(rp[:64], pay)
    print(f"ofdmflexframe: reference RX decoded our TX: {bool(ok)}")
    if not ok:
        failures.append("ofdmflexframe")

    if failures:
        print(f"FAILURES: {failures}")
        return 1
    print("all reference receivers decode this framework's transmissions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
