/* iokit.c — native SDR sample-format conversion loops.
 *
 * The host-side data loader converts captured IQ byte streams
 * (cu8/cs8/cs16/cf32 interleaved, the formats produced by common SDR
 * front-ends) into the float32 real/imag planes the device compute path
 * consumes, and back.  These are memory-bandwidth-bound byte loops —
 * runtime-side native code, not device work (cf. reference liquid-dsp,
 * whose entire runtime is C; this framework keeps the compute path in
 * XLA and the byte-wrangling here).
 *
 * All functions are length-explicit and operate on caller-owned
 * buffers; no allocation.
 */
#include <stddef.h>
#include <stdint.h>

/* unsigned 8-bit offset-binary IQ (RTL-SDR): x = (b - 127.5)/127.5 */
void iok_cu8_to_planes(const uint8_t *in, float *re, float *im, size_t n)
{
    /* one FMA per sample; no shared mutable state (ctypes releases the
     * GIL, so this must be safe to call from concurrent threads) */
    const float s = 1.0f / 127.5f;
    for (size_t i = 0; i < n; i++) {
        re[i] = ((float)in[2 * i] - 127.5f) * s;
        im[i] = ((float)in[2 * i + 1] - 127.5f) * s;
    }
}

void iok_planes_to_cu8(const float *re, const float *im, uint8_t *out,
                       size_t n)
{
    for (size_t i = 0; i < n; i++) {
        float r = re[i] * 127.5f + 127.5f;
        float q = im[i] * 127.5f + 127.5f;
        if (r < 0.0f) r = 0.0f; if (r > 255.0f) r = 255.0f;
        if (q < 0.0f) q = 0.0f; if (q > 255.0f) q = 255.0f;
        out[2 * i] = (uint8_t)(r + 0.5f);
        out[2 * i + 1] = (uint8_t)(q + 0.5f);
    }
}

/* signed 8-bit IQ (HackRF): x = b / 127 */
void iok_cs8_to_planes(const int8_t *in, float *re, float *im, size_t n)
{
    const float s = 1.0f / 127.0f;
    for (size_t i = 0; i < n; i++) {
        re[i] = (float)in[2 * i] * s;
        im[i] = (float)in[2 * i + 1] * s;
    }
}

void iok_planes_to_cs8(const float *re, const float *im, int8_t *out,
                       size_t n)
{
    for (size_t i = 0; i < n; i++) {
        float r = re[i] * 127.0f;
        float q = im[i] * 127.0f;
        if (r < -127.0f) r = -127.0f; if (r > 127.0f) r = 127.0f;
        if (q < -127.0f) q = -127.0f; if (q > 127.0f) q = 127.0f;
        out[2 * i] = (int8_t)(r + (r >= 0 ? 0.5f : -0.5f));
        out[2 * i + 1] = (int8_t)(q + (q >= 0 ? 0.5f : -0.5f));
    }
}

/* signed 16-bit IQ (UHD sc16): x = b / 32767 */
void iok_cs16_to_planes(const int16_t *in, float *re, float *im, size_t n)
{
    const float s = 1.0f / 32767.0f;
    for (size_t i = 0; i < n; i++) {
        re[i] = (float)in[2 * i] * s;
        im[i] = (float)in[2 * i + 1] * s;
    }
}

void iok_planes_to_cs16(const float *re, const float *im, int16_t *out,
                        size_t n)
{
    for (size_t i = 0; i < n; i++) {
        float r = re[i] * 32767.0f;
        float q = im[i] * 32767.0f;
        if (r < -32767.0f) r = -32767.0f; if (r > 32767.0f) r = 32767.0f;
        if (q < -32767.0f) q = -32767.0f; if (q > 32767.0f) q = 32767.0f;
        out[2 * i] = (int16_t)(r + (r >= 0 ? 0.5f : -0.5f));
        out[2 * i + 1] = (int16_t)(q + (q >= 0 ? 0.5f : -0.5f));
    }
}

/* interleaved float32 IQ <-> planes (deinterleave / interleave) */
void iok_cf32_to_planes(const float *in, float *re, float *im, size_t n)
{
    for (size_t i = 0; i < n; i++) {
        re[i] = in[2 * i];
        im[i] = in[2 * i + 1];
    }
}

void iok_planes_to_cf32(const float *re, const float *im, float *out,
                        size_t n)
{
    for (size_t i = 0; i < n; i++) {
        out[2 * i] = re[i];
        out[2 * i + 1] = im[i];
    }
}
