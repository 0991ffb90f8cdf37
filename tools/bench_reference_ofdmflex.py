"""Measure the reference C library's ofdmflexframesync throughput on
this host (single thread, -O2) — the honest baseline for the
OFDM-flexframe full-RX comparison (methodology identical to
bench_reference_rx.py; stream mirrors tools/bench_ofdmflex_rx.py:
M=64 cp=16 taper=0 default allocation, 64-byte qpsk payload,
crc32 + golay2412 outer, noise gaps at ~20 dB).
Prints one line: `rx_msps <value> frames <decoded> of <embedded>`.
"""
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import refbuild

SRC = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <complex.h>
#include "liquid.h"

static int n_frames = 0;
static int cb(unsigned char *h, int hv, unsigned char *p, unsigned int plen,
              int pv, framesyncstats_s s, void *ctx)
{ (void)h;(void)p;(void)plen;(void)s;(void)ctx; n_frames += hv && pv; return 0; }

int main(void) {
    unsigned int M = 64, cp = 16, taper = 0;
    unsigned int payload_len = 64;
    unsigned int gap = 2048;
    unsigned int nrep = 16;

    ofdmflexframegenprops_s props;
    ofdmflexframegenprops_init_default(&props);
    props.check      = LIQUID_CRC_32;
    props.fec0       = LIQUID_FEC_NONE;
    props.fec1       = LIQUID_FEC_GOLAY2412;
    props.mod_scheme = LIQUID_MODEM_QPSK;
    ofdmflexframegen fg = ofdmflexframegen_create(M, cp, taper, NULL, &props);

    unsigned char header[8], payload[64];
    unsigned int i, k;
    for (i = 0; i < 8; i++)  header[i]  = i;
    for (i = 0; i < payload_len; i++) payload[i] = (unsigned char)(i * 7);
    ofdmflexframegen_assemble(fg, header, payload, payload_len);
    unsigned int n_sym = ofdmflexframegen_getframelen(fg);
    unsigned int frame_len = n_sym * (M + cp);
    unsigned int cap_len = nrep * (frame_len + gap);
    float complex *cap = malloc(cap_len * sizeof(float complex));
    float complex *buf = malloc((M + cp) * sizeof(float complex));

    float nstd = 0.1f;
    unsigned int pos = 0;
    for (k = 0; k < nrep; k++) {
        ofdmflexframegen_reset(fg);
        ofdmflexframegen_assemble(fg, header, payload, payload_len);
        int done = 0;
        while (!done) {
            done = ofdmflexframegen_writesymbol(fg, buf);
            if (pos + (M + cp) <= cap_len)
                { memcpy(cap + pos, buf, (M + cp) * sizeof(float complex));
                  pos += M + cp; }
        }
        for (i = 0; i < gap && pos < cap_len; i++)
            cap[pos++] = nstd * (randnf() + _Complex_I * randnf()) * 0.7071f;
    }
    cap_len = pos;

    ofdmflexframesync fs = ofdmflexframesync_create(M, cp, taper, NULL,
                                                    cb, NULL);
    /* warm + count */
    ofdmflexframesync_execute(fs, cap, cap_len);
    int decoded_once = n_frames;

    unsigned int trials = 8;
    n_frames = 0;
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (k = 0; k < trials; k++) {
        ofdmflexframesync_reset(fs);
        ofdmflexframesync_execute(fs, cap, cap_len);
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double dt = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
    double msps = (double)cap_len * trials / dt / 1e6;
    printf("rx_msps %f frames %d of %u (first pass %d)\n",
           msps, n_frames, trials * nrep, decoded_once);
    return 0;
}
"""


def main() -> int:
    lib = refbuild.build()
    work = refbuild.WORK
    c = work / "bench_ofdmflex_rx.c"
    exe = work / "bench_ofdmflex_rx"
    c.write_text(SRC)
    r = subprocess.run(
        ["gcc", "-O2", "-o", str(exe), str(c),
         "-I", str(work / "include"), str(lib), "-lm"],
        capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stderr[-2000:], file=sys.stderr)
        return 1
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=600)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
