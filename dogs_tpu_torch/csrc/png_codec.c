/* PNG row filters undone in C, for the port's PNG reader
 * (dogs_tpu_torch/utils/png.py).
 *
 * Built with gcc -O3 -shared -fPIC at first use (dogs_tpu_torch/data/native.py)
 * and loaded with ctypes, which releases the interpreter lock for the call.
 * The function keeps its state on its own stack, so threads decode in
 * parallel.
 */

#include <stdint.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    return (uint8_t)(pb <= pc ? b : c);
}

/* Undo the filters of h rows of raw (each 1 + stride bytes, the filter type
 * first) into out (h rows of stride bytes), PNG's five filter types (None,
 * Sub, Up, Average, Paeth) with bpp bytes to the byte on the left (1..8).
 * The row above the first is zeros. Returns -1, or the index of the first
 * row with an unknown filter type (out is then written up to that row). */
long png_unfilter(const uint8_t *raw, long h, long stride, int bpp, uint8_t *out) {
    for (long y = 0; y < h; y++) {
        const uint8_t *line = raw + y * (stride + 1) + 1;
        uint8_t *cur = out + y * stride;
        const uint8_t *up = y ? cur - stride : NULL;
        long lead = bpp < stride ? bpp : stride; /* bytes with no left neighbour */
        switch (line[-1]) {
        case 0:
            memcpy(cur, line, (size_t)stride);
            break;
        case 1:
            memcpy(cur, line, (size_t)lead);
            for (long i = bpp; i < stride; i++) cur[i] = (uint8_t)(line[i] + cur[i - bpp]);
            break;
        case 2:
            if (up)
                for (long i = 0; i < stride; i++) cur[i] = (uint8_t)(line[i] + up[i]);
            else
                memcpy(cur, line, (size_t)stride);
            break;
        case 3:
            if (up) {
                for (long i = 0; i < lead; i++) cur[i] = (uint8_t)(line[i] + (up[i] >> 1));
                for (long i = bpp; i < stride; i++) cur[i] = (uint8_t)(line[i] + ((cur[i - bpp] + up[i]) >> 1));
            } else {
                memcpy(cur, line, (size_t)lead);
                for (long i = bpp; i < stride; i++) cur[i] = (uint8_t)(line[i] + (cur[i - bpp] >> 1));
            }
            break;
        case 4:
            if (up) { /* with no left pixel Paeth picks the byte above */
                for (long i = 0; i < lead; i++) cur[i] = (uint8_t)(line[i] + up[i]);
                for (long i = bpp; i < stride; i++)
                    cur[i] = (uint8_t)(line[i] + paeth(cur[i - bpp], up[i], up[i - bpp]));
            } else { /* with no row above it picks the byte on the left: Sub */
                memcpy(cur, line, (size_t)lead);
                for (long i = bpp; i < stride; i++) cur[i] = (uint8_t)(line[i] + cur[i - bpp]);
            }
            break;
        default:
            return y;
        }
    }
    return -1;
}
