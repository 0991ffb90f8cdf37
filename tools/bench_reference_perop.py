#!/usr/bin/env python
"""Measure the reference C library's per-op single-thread throughput on
this host for every family of the per-op suite (tools/bench_suite.py),
giving each row a measured reference-C context column
(tests/baseline_perop.json).

Configs mirror tools/bench_suite.py / tools/bench_timing_family.py
exactly (tap counts, orders, schemes); the loop shapes mirror the
reference's own bench/ programs (reference bench/bench.c:85 calibrated
50-500 ms trials; per-family call patterns from src/*/bench/*.c).

Output: tests/baseline_perop.json {name: Msamples/s} (MACs/s for the
dotprod rows, Mbit/s decoded for FEC rows, Msym/s for modem rows).

NOT measurable with this build: conv (v27..) and RS decode — the
reference delegates those to the external libfec library
(include/liquid.internal.h:42 LIBFEC_ENABLED; fec_conv.c:284 returns
NULL without it), which is not present on this host.  This library
decodes them natively (fec/conv.py, fec/rs.py, fec/device.py).
"""
import json
import pathlib
import re
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from refbuild import build, WORK  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / \
    "tests/baseline_perop.json"

GEN_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <math.h>
#include "liquid.h"
#include "liquid.internal.h"   /* fec_sumproduct (LDPC BP) */

static double now_s(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

/* calibrated trial loop (reference bench/bench.c:85 50-500ms policy):
   BODY processes NSAMP samples; prints NAME and Munits/s */
#define BENCH(NAME, NSAMP, BODY) do {                                   \
    unsigned long __tr = 4, __t; double __dt;                           \
    while (1) {                                                         \
        double __t0 = now_s();                                          \
        for (__t = 0; __t < __tr; __t++) { BODY }                       \
        __dt = now_s() - __t0;                                          \
        if (__dt > 0.4 || __tr >= (1UL << 28)) break;                   \
        __tr = (__dt < 0.01) ? __tr * 8 : __tr * 2;                     \
    }                                                                   \
    printf("%s %f\n", NAME, (double)__tr * (NSAMP) / __dt / 1e6);       \
    fflush(stdout);                                                     \
} while (0)

#define N 16384

int main() {
    unsigned int i;
    float complex *x  = malloc(2 * N * sizeof(float complex));
    float complex *y  = malloc(8 * N * sizeof(float complex));
    float         *xr = malloc(2 * N * sizeof(float));
    for (i = 0; i < 2 * N; i++) {
        x[i]  = 0.5f * (cosf(0.02f * i) + _Complex_I * sinf(0.031f * i));
        xr[i] = 0.5f * cosf(0.02f * i);
    }
    unsigned int nw;

    /* ---- FIR family (suite: kaiser(64,0.2,60)/(257,0.1,80)/(13,...)) */
    {
        float h[257];
        liquid_firdes_kaiser(13, 0.3f, 60.0f, 0.0f, h);
        firfilt_crcf f = firfilt_crcf_create(h, 13);
        BENCH("firfilt13", N, firfilt_crcf_execute_block(f, x, N, y););
        firfilt_crcf_destroy(f);
        liquid_firdes_kaiser(64, 0.2f, 60.0f, 0.0f, h);
        f = firfilt_crcf_create(h, 64);
        BENCH("firfilt64", N, firfilt_crcf_execute_block(f, x, N, y););
        firfilt_crcf_destroy(f);
        liquid_firdes_kaiser(257, 0.1f, 80.0f, 0.0f, h);
        f = firfilt_crcf_create(h, 257);
        BENCH("firfilt257", N, firfilt_crcf_execute_block(f, x, N, y););
        firfilt_crcf_destroy(f);
    }
    {
        float h[57];
        liquid_firdes_kaiser(57, 0.3f, 60.0f, 0.0f, h);
        fftfilt_crcf f = fftfilt_crcf_create(h, 57, N);
        BENCH("fftfilt57", N, fftfilt_crcf_execute(f, x, y););
        fftfilt_crcf_destroy(f);
    }
    {
        float h[48];
        liquid_firdes_kaiser(48, 0.1f, 60.0f, 0.0f, h);
        firdecim_crcf f = firdecim_crcf_create(4, h, 48);
        BENCH("firdecim4", N,
              firdecim_crcf_execute_block(f, x, N / 4, y););
        firdecim_crcf_destroy(f);
        firinterp_crcf g = firinterp_crcf_create(4, h, 48);
        BENCH("firinterp4", N,
              firinterp_crcf_execute_block(g, x, N / 4, y););
        firinterp_crcf_destroy(g);
    }
    {   /* real 2N in -> N complex out; count REAL input samples */
        firhilbf q = firhilbf_create(5, 60.0f);
        BENCH("firhilb_decim", N,
              for (i = 0; i + 2 <= N; i += 2)
                  firhilbf_decim_execute(q, &xr[i], &y[i / 2]););
        firhilbf_destroy(q);
    }

    /* ---- resamplers (suite: resamp((3,2)) m=7 fc=0.25 As=60 npfb=64) */
    {
        resamp_crcf q = resamp_crcf_create(1.5f, 7, 0.25f, 60.0f, 64);
        BENCH("resamp_3_2", N,
              resamp_crcf_execute_block(q, x, N, y, &nw););
        resamp_crcf_destroy(q);
    }
    {
        resamp2_crcf q = resamp2_crcf_create(7, 0.0f, 60.0f);
        BENCH("resamp2_decim", N,
              for (i = 0; i + 2 <= N; i += 2)
                  resamp2_crcf_decim_execute(q, &x[i], &y[i / 2]););
        resamp2_crcf_destroy(q);
    }
    {
        msresamp_crcf q = msresamp_crcf_create(0.5f, 60.0f);
        BENCH("msresamp_0.5", N,
              msresamp_crcf_execute(q, x, N, y, &nw););
        msresamp_crcf_destroy(q);
    }

    /* ---- nco / agc / iir */
    {
        nco_crcf q = nco_crcf_create(LIQUID_NCO);
        nco_crcf_set_frequency(q, 0.125f);
        BENCH("nco_mix", N, nco_crcf_mix_block_down(q, x, y, N););
        nco_crcf_destroy(q);
    }
    {
        agc_crcf q = agc_crcf_create();
        agc_crcf_set_bandwidth(q, 0.01f);
        BENCH("agc", N, agc_crcf_execute_block(q, x, N, y););
        agc_crcf_destroy(q);
    }
    {
        iirfilt_crcf q = iirfilt_crcf_create_prototype(
            LIQUID_IIRDES_BUTTER, LIQUID_IIRDES_LOWPASS, LIQUID_IIRDES_SOS,
            7, 0.2f, 0.0f, 0.1f, 60.0f);
        BENCH("iirfilt_sos7", N, iirfilt_crcf_execute_block(q, x, N, y););
        iirfilt_crcf_destroy(q);
    }

    /* ---- channelizers (suite: M=64, m=4, As=60) */
    {
        firpfbch_crcf q = firpfbch_crcf_create_kaiser(
            LIQUID_ANALYZER, 64, 4, 60.0f);
        BENCH("firpfbch_64", N,
              for (i = 0; i + 64 <= N; i += 64)
                  firpfbch_crcf_analyzer_execute(q, &x[i], y););
        firpfbch_crcf_destroy(q);
    }
    {
        firpfbch2_crcf q = firpfbch2_crcf_create_kaiser(
            LIQUID_ANALYZER, 64, 4, 60.0f);
        BENCH("firpfbch2_64", N,
              for (i = 0; i + 32 <= N; i += 32)
                  firpfbch2_crcf_execute(q, &x[i], y););
        firpfbch2_crcf_destroy(q);
    }

    /* ---- linear modem (Msym/s) */
    {
        modem md = modem_create(LIQUID_MODEM_QAM16);
        unsigned int sym = 0, so;
        float complex pt;
        BENCH("qam16_mod", N,
              for (i = 0; i < N; i++) {
                  modem_modulate(md, sym, &pt);
                  sym = (sym + 1) & 15;
              });
        modem_destroy(md);
        md = modem_create(LIQUID_MODEM_QAM16);
        BENCH("qam16_demod", N,
              for (i = 0; i < N; i++)
                  modem_demodulate(md, x[i], &so););
        modem_destroy(md);
    }

    /* ---- analog modem */
    {
        freqmod q = freqmod_create(0.1f);
        BENCH("freqmod", N, freqmod_modulate_block(q, xr, N, y););
        freqmod_destroy(q);
        freqdem d = freqdem_create(0.1f);
        BENCH("freqdem", N, freqdem_demodulate_block(d, x, N, xr););
        freqdem_destroy(d);
    }

    /* ---- GMSK modem (Mbit/s in, Msamples/s in for the demod) */
    {
        gmskmod mod = gmskmod_create(2, 3, 0.3f);
        float complex buf[2];
        BENCH("gmskmod_bits", N,
              for (i = 0; i < N; i++)
                  gmskmod_modulate(mod, i & 1, buf););
        gmskmod_destroy(mod);
        gmskdem dem = gmskdem_create(2, 3, 0.3f);
        unsigned int bit;
        BENCH("gmskdem_samps", N,
              for (i = 0; i + 2 <= N; i += 2)
                  gmskdem_demodulate(dem, &x[i], &bit););
        gmskdem_destroy(dem);
    }

    /* ---- M-FSK (Msym/s mod, Msamples/s dem; M=4, k=8) */
    {
        fskmod mod = fskmod_create(2, 8, 0.25f);
        float complex buf[8];
        BENCH("fskmod4_syms", N / 8,
              for (i = 0; i < N / 8; i++)
                  fskmod_modulate(mod, i & 3, buf););
        fskmod_destroy(mod);
        fskdem dem = fskdem_create(2, 8, 0.25f);
        BENCH("fskdem4_samps", N,
              for (i = 0; i + 8 <= N; i += 8)
                  (void)fskdem_demodulate(dem, &x[i]););
        fskdem_destroy(dem);
    }

    /* ---- IIR decimator / interpolator (default prototype order 4) */
    {
        iirdecim_crcf q = iirdecim_crcf_create_default(4, 4);
        BENCH("iirdecim4", N,
              for (i = 0; i + 4 <= N; i += 4)
                  iirdecim_crcf_execute(q, &x[i], &y[i / 4]););
        iirdecim_crcf_destroy(q);
        iirinterp_crcf g = iirinterp_crcf_create_default(4, 4);
        /* INPUT-sample units (N/4 inputs -> N outputs), matching the
           device suite row */
        BENCH("iirinterp4", N / 4,
              for (i = 0; i + 4 <= N; i += 4)
                  iirinterp_crcf_execute(g, x[i / 4], &y[i]););
        iirinterp_crcf_destroy(g);
    }

    /* ---- soft demod (Msym/s) + CVSD (Msamples/s) */
    {
        modem md = modem_create(LIQUID_MODEM_QAM16);
        unsigned int so;
        unsigned char sb[4];
        BENCH("qam16_demodsoft", N,
              for (i = 0; i < N; i++)
                  modem_demodulate_soft(md, x[i], &so, sb););
        modem_destroy(md);
        cvsd cv = cvsd_create(3, 1.5f, 0.95f);
        BENCH("cvsd_enc", N,
              for (i = 0; i < N; i++)
                  (void)cvsd_encode(cv, xr[i]););
        cvsd_destroy(cv);
    }

    /* ---- timing-recovery / adaptive family
       (bench_timing_family.py configs) */
    {
        symsync_crcf q = symsync_crcf_create_rnyquist(
            LIQUID_FIRFILT_ARKAISER, 2, 5, 0.3f, 32);
        symsync_crcf_set_lf_bw(q, 0.01f);
        BENCH("symsync_k2", N,
              symsync_crcf_execute(q, x, N, y, &nw););
        symsync_crcf_destroy(q);
    }
    {
        symtrack_cccf q = symtrack_cccf_create(
            LIQUID_FIRFILT_ARKAISER, 2, 7, 0.3f, LIQUID_MODEM_QPSK);
        BENCH("symtrack", N,
              symtrack_cccf_execute_block(q, x, N, y, &nw););
        symtrack_cccf_destroy(q);
    }
    {
        eqlms_cccf q = eqlms_cccf_create(NULL, 13);
        eqlms_cccf_set_bw(q, 0.05f);
        float complex z;
        BENCH("eqlms13_trained", N,
              for (i = 0; i < N; i++) {
                  eqlms_cccf_push(q, x[i]);
                  eqlms_cccf_execute(q, &z);
                  eqlms_cccf_step(q, x[i], z);
              });
        eqlms_cccf_destroy(q);
    }
    {
        eqrls_cccf q = eqrls_cccf_create(NULL, 13);
        float complex z;
        BENCH("eqrls13_trained", N,
              for (i = 0; i < N; i++) {
                  eqrls_cccf_push(q, x[i]);
                  eqrls_cccf_execute(q, &z);
                  eqrls_cccf_step(q, x[i], z);
              });
        eqrls_cccf_destroy(q);
    }

    /* ---- FEC decode (Mbit/s of DECODED payload; 64-byte messages)
       conv/RS need external libfec - not available in this build */
    {
        unsigned char md[64], me[512];
        for (i = 0; i < 64; i++) md[i] = (unsigned char)(i * 37);
        struct { const char *name; fec_scheme fs; } codes[] = {
            {"fec_rep3_dec",       LIQUID_FEC_REP3},
            {"fec_hamming74_dec",  LIQUID_FEC_HAMMING74},
            {"fec_hamming128_dec", LIQUID_FEC_HAMMING128},
            {"fec_golay2412_dec",  LIQUID_FEC_GOLAY2412},
            {"fec_secded7264_dec", LIQUID_FEC_SECDED7264},
        };
        for (unsigned c = 0; c < 5; c++) {
            fec q = fec_create(codes[c].fs, NULL);
            fec_encode(q, 64, md, me);
            BENCH(codes[c].name, 64 * 8 / 1e0,
                  fec_decode(q, 64, me, md););
            fec_destroy(q);
        }
    }
    /* ---- SOFT decode (fec_decode_soft, liquid.h:953): the
       apples-to-apples row for the device soft decoders */
    {
        unsigned char md[64], me[512], sb[4096];
        for (i = 0; i < 64; i++) md[i] = (unsigned char)(i * 37);
        struct { const char *name; fec_scheme fs; } codes[] = {
            {"fecsoft_hamming128_dec", LIQUID_FEC_HAMMING128},
            {"fecsoft_golay2412_dec",  LIQUID_FEC_GOLAY2412},
            {"fecsoft_secded7264_dec", LIQUID_FEC_SECDED7264},
        };
        for (unsigned c = 0; c < 3; c++) {
            fec q = fec_create(codes[c].fs, NULL);
            unsigned int elen = fec_get_enc_msg_length(codes[c].fs, 64);
            fec_encode(q, 64, md, me);
            for (i = 0; i < 8 * elen; i++) {
                unsigned bit = (me[i / 8] >> (7 - (i & 7))) & 1;
                sb[i] = bit ? 220 : 35;   /* confident soft bits */
            }
            BENCH(codes[c].name, 64 * 8,
                  fec_decode_soft(q, 64, sb, md););
            fec_destroy(q);
        }
    }

    {   /* crc32 over 256-byte messages: Mbyte/s */
        unsigned char msg[256];
        for (i = 0; i < 256; i++) msg[i] = (unsigned char)i;
        BENCH("crc32_bytes", 256,
              (void)crc_generate_key(LIQUID_CRC_32, msg, 256););
    }
    {   /* packetizer decode, flexframe payload-ish config: Mbyte/s dec */
        packetizer p = packetizer_create(64, LIQUID_CRC_32,
                                         LIQUID_FEC_NONE,
                                         LIQUID_FEC_GOLAY2412);
        unsigned int plen = packetizer_get_enc_msg_len(p);
        unsigned char md[64], *pk = malloc(plen);
        for (i = 0; i < 64; i++) md[i] = (unsigned char)(i * 11);
        packetizer_encode(p, md, pk);
        BENCH("packetizer64_golay_dec", 64,
              (void)packetizer_decode(p, pk, md););
        packetizer_destroy(p);
        free(pk);
    }
    {   /* interleaver (Mbyte/s) */
        interleaver q = interleaver_create(256);
        unsigned char a[256], b[256];
        for (i = 0; i < 256; i++) a[i] = (unsigned char)i;
        BENCH("interleaver256", 256, interleaver_encode(q, a, b););
        interleaver_destroy(q);
    }

    /* ---- LDPC sum-product BP (internal fec_sumproduct, the analog of
       the batched device BP): decode noisy all-zero codewords of a
       random column-weight-3 regular H, ~0.7-sigma AWGN LLRs (the device
       ldpc row's channel), max 20 iterations.  Mbit/s of INFO bits. */
    {
        unsigned int mrows[2] = {48, 512};
        srand(12345);
        for (unsigned k = 0; k < 2; k++) {
            unsigned int m = mrows[k], n = 2 * m;
            unsigned char *Hd = calloc((size_t)m * n, 1);
            for (unsigned c = 0; c < n; c++)
                for (unsigned w = 0; w < 3; w++)
                    Hd[(rand() % m) * n + c] = 1;
            smatrixb H = smatrixb_create_array(Hd, m, n);
            float *LLR = malloc(n * sizeof(float));
            unsigned char *chat = malloc(n);
            for (i = 0; i < n; i++) {
                /* all-zero codeword, BPSK +1, AWGN sigma 0.7:
                   LLR = 2 r / sigma^2, r = 1 + noise */
                float u1 = (rand() % 10000 + 1) / 10000.0f;
                float u2 = (rand() % 10000) / 10000.0f;
                float g = sqrtf(-2.0f * logf(u1)) *
                          cosf(6.2831853f * u2);
                LLR[i] = 2.0f * (1.0f + 0.7f * g) / (0.7f * 0.7f);
            }
            char nm[32];
            snprintf(nm, 32, "ldpc_sumproduct_%u_%u", n, m);
            BENCH(nm, m,
                  fec_sumproduct(m, n, H, LLR, chat, 20););
            smatrixb_destroy(H);
            free(Hd); free(LLR); free(chat);
        }
    }

    /* ---- framing detectors (Msamples/s in) */
    {
        float complex h[64];
        for (i = 0; i < 64; i++)
            h[i] = cexpf(_Complex_I * (0.3f * i * i));
        detector_cccf q = detector_cccf_create(h, 64, 0.5f, 0.01f);
        float tau, dphi, gam;
        BENCH("detector_cccf", N,
              for (i = 0; i < N; i++)
                  (void)detector_cccf_correlate(q, x[i], &tau, &dphi,
                                                &gam););
        detector_cccf_destroy(q);
    }
    {
        msequence ms = msequence_create_default(6);
        bsequence bs = bsequence_create(64);
        for (i = 0; i < 64; i++)
            bsequence_push(bs, msequence_advance(ms));
        msequence_destroy(ms);
        bsync_crcf q = bsync_crcf_create_msequence(6, 1);
        float complex rxy;
        BENCH("bsync_crcf", N,
              for (i = 0; i < N; i++)
                  bsync_crcf_correlate(q, x[i], &rxy););
        bsync_crcf_destroy(q);
        bsequence_destroy(bs);
    }

    /* ---- OFDM frame sync acquisition (M=64 cp=16, seek over noise):
       the C analog of the s0 detect-everywhere stage */
    {
        ofdmframesync fs = ofdmframesync_create(64, 16, 4, NULL, NULL,
                                                NULL);
        BENCH("ofdmframesync_acquire", N,
              ofdmframesync_execute(fs, x, N);
              ofdmframesync_reset(fs););
        ofdmframesync_destroy(fs);
    }

    /* ---- VCO-mode mixer (exact sincos per sample) */
    {
        nco_crcf q = nco_crcf_create(LIQUID_VCO);
        nco_crcf_set_frequency(q, 0.125f);
        BENCH("vco_mix", N, nco_crcf_mix_block_down(q, x, y, N););
        nco_crcf_destroy(q);
    }

    /* ---- DCT (r2r REDFT10, n=256) */
    {
        unsigned int n = 256;
        float *ra = malloc(n * sizeof(float));
        float *rb = malloc(n * sizeof(float));
        for (i = 0; i < n; i++) ra[i] = xr[i];
        fftplan pl = fft_create_plan_r2r_1d(n, ra, rb,
                                            LIQUID_FFT_REDFT10, 0);
        BENCH("dct_256", n, fft_execute(pl););
        fft_destroy_plan(pl);
        free(ra); free(rb);
    }

    /* ---- dense matrix multiply n=64 (M MAC/s) */
    {
        unsigned int n = 64;
        float *A = malloc(n * n * sizeof(float));
        float *Bm = malloc(n * n * sizeof(float));
        float *Cm = malloc(n * n * sizeof(float));
        for (i = 0; i < n * n; i++) { A[i] = i * 0.01f; Bm[i] = 1.0f - A[i]; }
        BENCH("matrixf_mul_64", (unsigned long)n * n * n,
              matrixf_mul(A, n, n, Bm, n, n, Cm, n, n););
        free(A); free(Bm); free(Cm);
    }

    /* ---- random normal + msequence + window (host support ops) */
    {
        float acc = 0.0f;
        BENCH("randnf", N, for (i = 0; i < N; i++) acc += randnf(););
        if (acc == 1.0f) printf("# %f\n", acc);
        msequence ms = msequence_create_default(14);
        unsigned int bit = 0;
        BENCH("msequence_bits", N,
              for (i = 0; i < N; i++) bit ^= msequence_advance(ms););
        msequence_destroy(ms);
        windowcf w = windowcf_create(64);
        float complex *rp;
        BENCH("windowcf_push_read", N,
              for (i = 0; i < N; i++) windowcf_push(w, x[i]);
              windowcf_read(w, &rp););
        windowcf_destroy(w);
    }

    /* ---- dotprod sweep (reference dotprod_crcf_benchmark.c:74-77)
       unit: M MAC/s */
    {
        unsigned int ns[4] = {4, 16, 64, 256};
        for (unsigned k = 0; k < 4; k++) {
            unsigned int n = ns[k];
            float h[256];
            for (i = 0; i < n; i++) h[i] = 1.0f / (1 + i);
            dotprod_crcf dp = dotprod_crcf_create(h, n);
            float complex r;
            char nm[32];
            snprintf(nm, 32, "dotprod_crcf_%u", n);
            BENCH(nm, (unsigned long)n * 64,
                  for (i = 0; i < 64; i++)
                      dotprod_crcf_execute(dp, &x[i], &r););
            dotprod_crcf_destroy(dp);
        }
    }

    /* ---- FFT size sweep (reference fftbench families) */
    {
        unsigned int sizes[10] = {64, 256, 1024, 4096,
                                  96, 384, 1200, 127, 509, 1021};
        for (unsigned k = 0; k < 10; k++) {
            unsigned int n = sizes[k];
            float complex *fa = malloc(n * sizeof(float complex));
            float complex *fb = malloc(n * sizeof(float complex));
            for (i = 0; i < n; i++) fa[i] = x[i];
            fftplan pl = fft_create_plan(n, fa, fb,
                                         LIQUID_FFT_FORWARD, 0);
            char nm[32];
            snprintf(nm, 32, "fft_%u", n);
            BENCH(nm, n, fft_execute(pl););
            fft_destroy_plan(pl);
            free(fa); free(fb);
        }
    }

    return 0;
}
"""


def main() -> int:
    lib = build()
    cdir = WORK / "benchperop"
    cdir.mkdir(exist_ok=True)
    (cdir / "gen.c").write_text(GEN_C)
    exe = cdir / "gen"
    # -O2 like the library objects (bench fairness; refbuild's
    # compile_and_run uses -O1 for golden generators where speed is moot)
    subprocess.run(["gcc", "-O2", "-I", str(WORK),
                    "-I", str(WORK / "include"),
                    "-o", str(exe), str(cdir / "gen.c"), str(lib), "-lm"],
                   check=True, capture_output=True, text=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=3600).stdout
    vals = {}
    for line in out.splitlines():
        m = re.match(r"([\w.]+)\s+([\d.eE+-]+)", line)
        if m:
            v = float(m.group(2))
            # keep sub-kbit/s readings (the C LDPC decodes in ~ms/cw)
            vals[m.group(1)] = round(v, 6 if v < 0.01 else 3)
    # BEST-OF merge with prior runs (host noise only ever slows the
    # reference down; the stored baseline should favor it)
    if OUT.exists():
        prior = json.loads(OUT.read_text())
        for k, v in prior.items():
            vals[k] = max(v, vals.get(k, v))
    OUT.write_text(json.dumps(vals, indent=2) + "\n")
    print(json.dumps(vals, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
