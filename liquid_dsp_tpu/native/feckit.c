/* Native byte/bit kernels for the packet path.
 *
 * The reference implements its packet framing (CRC polynomial division,
 * block interleaving, bit packing) as tight C99 loops; these are the
 * host/runtime-side hot paths that do not map to the accelerator.  This library
 * provides the same inner loops natively, loaded via ctypes with a pure
 * Python fallback (see liquid_dsp_tpu/native/__init__.py).
 *
 * Algorithms mirror liquid_dsp_tpu/fec/crc.py and fec/interleave.py,
 * which are byte-exact with the reference (reference src/fec/src/crc.c,
 * interleaver.c).
 */
#include <stdint.h>
#include <stddef.h>

/* reflected CRC with 32-bit ~0 init register (reference crc.c quirk) */
uint32_t ldt_crc(const uint8_t *msg, size_t n, uint32_t rpoly,
                 uint32_t mask) {
    uint32_t key = 0xFFFFFFFFu;
    for (size_t i = 0; i < n; i++) {
        key ^= msg[i];
        for (int j = 0; j < 8; j++)
            key = (key >> 1) ^ (rpoly & (-(key & 1u)));
    }
    return (~key) & mask;
}

uint32_t ldt_checksum(const uint8_t *msg, size_t n) {
    uint32_t sum = 0;
    for (size_t i = 0; i < n; i++) sum += msg[i];
    return (uint32_t)((~(sum & 0xFFu) + 1u) & 0xFFu);
}

/* one interleaver permutation pass (reference interleaver.c:196-219):
 * swaps x[2i] <-> x[2j+1] over the (M, N) index scan */
void ldt_interleave_pass(uint8_t *x, size_t n, unsigned M, unsigned N) {
    unsigned m = 0, nn = (unsigned)(n / 3);
    size_t n2 = n / 2;
    for (size_t i = 0; i < n2; i++) {
        size_t j;
        do {
            j = (size_t)m * N + nn;
            if (++m == M) { nn = (nn + 1) % N; m = 0; }
        } while (j >= n2);
        uint8_t tmp = x[2 * j + 1];
        x[2 * j + 1] = x[2 * i];
        x[2 * i] = tmp;
    }
}

void ldt_interleave_pass_mask(uint8_t *x, size_t n, unsigned M, unsigned N,
                              uint8_t mask) {
    unsigned m = 0, nn = (unsigned)(n / 3);
    size_t n2 = n / 2;
    uint8_t inv = (uint8_t)~mask;
    for (size_t i = 0; i < n2; i++) {
        size_t j;
        do {
            j = (size_t)m * N + nn;
            if (++m == M) { nn = (nn + 1) % N; m = 0; }
        } while (j >= n2);
        uint8_t a = x[2 * i], b = x[2 * j + 1];
        x[2 * i] = (uint8_t)((a & inv) | (b & mask));
        x[2 * j + 1] = (uint8_t)((a & mask) | (b & inv));
    }
}

/* MSB-first byte <-> bit expansion */
void ldt_unpack_bits(const uint8_t *bytes, size_t n, uint8_t *bits) {
    for (size_t i = 0; i < n; i++)
        for (int b = 0; b < 8; b++)
            bits[8 * i + b] = (bytes[i] >> (7 - b)) & 1u;
}

void ldt_pack_bits(const uint8_t *bits, size_t nbits, uint8_t *bytes) {
    size_t nbytes = (nbits + 7) / 8;
    for (size_t i = 0; i < nbytes; i++) bytes[i] = 0;
    for (size_t i = 0; i < nbits; i++)
        bytes[i / 8] = (uint8_t)(bytes[i / 8] |
                                 ((bits[i] & 1u) << (7 - (i % 8))));
}

/* LFSR m-sequence bit generation (reference msequence.c:166-177) */
void ldt_msequence(unsigned m, unsigned g, unsigned v, size_t n,
                   uint8_t *bits) {
    unsigned mask = (1u << m) - 1u;
    for (size_t i = 0; i < n; i++) {
        unsigned b = __builtin_popcount(v & g) & 1u;
        v = ((v << 1) | b) & mask;
        bits[i] = (uint8_t)b;
    }
}
