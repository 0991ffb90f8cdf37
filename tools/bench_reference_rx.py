"""Measure the reference C library's framesync64 streaming-RX
throughput on this host (single thread, -O2), the honest baseline for
the config-#5 comparison (reference bench analog:
/root/reference/bench/bench.c methodology — wall-time a tight loop,
report samples/s).

The stream mirrors tools/bench_frame64_rx.py: frames separated by
noise gaps at ~20 dB SNR, receiver runs `framesync64_execute` over the
whole capture.  Prints one line: `rx_msps <value> frames <decoded>`.
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
    unsigned int gap = 1280;               /* noise samples between frames */
    unsigned int nrep = 64;                /* frames per capture */
    unsigned int frame_len = LIQUID_FRAME64_LEN;
    unsigned int cap_len = nrep * (frame_len + gap);
    float complex *cap = malloc(cap_len * sizeof(float complex));

    framegen64 fg = framegen64_create();
    unsigned char header[8], payload[64];
    unsigned int i, k;
    for (i = 0; i < 8; i++)  header[i]  = i;
    for (i = 0; i < 64; i++) payload[i] = (unsigned char)(i * 7);
    float nstd = 0.1f;                     /* ~20 dB SNR */
    unsigned int pos = 0;
    for (k = 0; k < nrep; k++) {
        framegen64_execute(fg, header, payload, cap + pos);
        pos += frame_len;
        for (i = 0; i < gap; i++)
            cap[pos + i] = nstd * (randnf() + _Complex_I * randnf()) * 0.7071f;
        pos += gap;
    }
    for (i = 0; i < cap_len; i++)          /* add noise to the frames too */
        cap[i] += nstd * (randnf() + _Complex_I * randnf()) * 0.7071f;

    framesync64 fs = framesync64_create(cb, NULL);
    /* warm pass (exercise the code paths once) */
    framesync64_execute(fs, cap, cap_len);
    framesync64_reset(fs);
    n_frames = 0;

    unsigned int trials = 8;
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (k = 0; k < trials; k++) {
        framesync64_execute(fs, cap, cap_len);
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double dt = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
    double msps = (double)cap_len * trials / dt / 1e6;
    printf("rx_msps %f frames %d of %u\n", msps, n_frames, trials * nrep);
    return 0;
}
"""


def main() -> int:
    lib = refbuild.build()
    work = refbuild.WORK
    c = work / "bench_rx.c"
    exe = work / "bench_rx"
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
