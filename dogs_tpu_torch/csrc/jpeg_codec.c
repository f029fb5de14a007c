/* JPEG decoding and encoding, baseline and progressive, and GIF LZW coding,
 * for the port's data layer (dogs_tpu_torch/utils/jpeg.py,
 * dogs_tpu_torch/utils/gif.py).
 *
 * Built with gcc -O3 -shared -fPIC at first use (dogs_tpu_torch/data/native.py)
 * and loaded with ctypes. Every function keeps its state on its own stack or
 * heap, so threads decode in parallel.
 *
 * Decoder: Huffman JPEG, sequential (SOF0, and SOF1 at 8 bits) and
 * progressive (SOF2), 1 or 3 components at any integral sampling ratio, one
 * or several scans, restart intervals, 8- and 16-bit quantization tables. A
 * sequential scan is decoded straight into the component's plane; a
 * progressive file's scans (DC first and refinement, AC first with
 * end-of-band runs, AC refinement with correction bits, jdphuff.c) build a
 * coefficient buffer of the whole image, which goes through the IDCT at EOI.
 * It reproduces libjpeg's default decompression (libjpeg-turbo's as PIL
 * calls it) step for step:
 *   - the ISLOW integer IDCT (jidctint.c) with its range-limit table;
 *   - "fancy" upsampling (jdsample.c): h2v1 and h2v2 triangle filters for
 *     components wider than 2 samples, h1v2, edge samples replicated, and
 *     box replication for every other integral ratio;
 *   - YCbCr -> RGB in 16-bit fixed point (jdcolor.c);
 *   - the colour space rule of jdapimin.c (JFIF, Adobe transform, component
 *     ids), and no EXIF rotation.
 * libjpeg's block smoothing (jdcoefct.c) is not: it changes a progressive
 * image only while bits of coefficients 1-9 are still unsent at output,
 * so such a file returns JPEG_UNSUPPORTED, as do lossless, hierarchical and
 * arithmetic-coded files, precisions other than 8 bits and 2- or
 * 4-component files; a stream that ends early (a progressive one without
 * its EOI), a bad Huffman code or table, a missing restart marker or an
 * inconsistent header returns JPEG_CORRUPT. The caller's output is written
 * only after the whole stream has decoded.
 *
 * Encoder: 1 or 3 components, Y sampling 1x1, 2x1, 2x2 or 1x2, the Annex K
 * quantization tables scaled by libjpeg's quality rule, libjpeg's RGB ->
 * YCbCr, downsampling and ISLOW forward DCT, optional restart interval;
 * baseline with the Annex K Huffman tables, or progressive with libjpeg's
 * simple progression and Huffman tables optimized per scan (jcphuff.c,
 * jchuff.c), over the same quantized coefficients.
 *
 * GIF: LZW coding of 8-bit indices into GIF data sub-blocks.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define JPEG_OK 0
#define JPEG_UNSUPPORTED 1
#define JPEG_CORRUPT 2

static const uint8_t ZIGZAG[64] = {  /* zigzag index -> natural (row-major) index */
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* ---- ISLOW constants (jidctint.c / jfdctint.c, CONST_BITS 13) --------- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* ======================================================================= */
/* Decoder                                                                 */
/* ======================================================================= */

#define LOOK 9

typedef struct {
    int defined;
    uint8_t bits[17];
    uint8_t vals[256];
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint16_t look[1 << LOOK]; /* (length << 8) | value, 0 for longer codes */
} HuffTable;

typedef struct {
    int id, h, v, tq, td, ta;
    int dw, dh;          /* downsampled size: ceil(image size * h / max h) */
    int stride, rows;    /* plane size: whole MCUs */
    uint8_t *plane;
    int pred;            /* DC predictor */
    int decoded;         /* its scan has been read */
    /* progressive: every block's coefficients (natural order, stride / 8
     * blocks a row), the quantization table latched at the component's
     * first scan, and for each coefficient (zigzag index) the point
     * transform Al of its last scan, -1 before any (libjpeg's coef_bits) */
    int16_t *coef;
    uint16_t q[64];
    int coef_bits[64];
} Component;

typedef struct {
    const uint8_t *data;
    long size, pos;
    int width, height, ncomp, maxh, maxv, mcux, mcuy;
    int frame, progressive, restart_interval;
    int saw_jfif, saw_adobe, adobe_transform;
    uint16_t qt[4][64]; /* natural order */
    int qt_defined[4];
    HuffTable dc[4], ac[4];
    Component comp[3];
    /* entropy-coded data: MSB-first bit accumulator */
    uint64_t acc;
    int nbits, padbits, marker_hit;
    int eobrun; /* progressive AC scans: blocks left in the current end-of-band run */
    jmp_buf fail_jump;
    char *err;
    int errlen;
} Decoder;

static void fail(Decoder *d, int code, const char *fmt, ...) __attribute__((noreturn, format(printf, 3, 4)));

static void fail(Decoder *d, int code, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    if (d->err && d->errlen > 0) vsnprintf(d->err, (size_t)d->errlen, fmt, ap);
    va_end(ap);
    longjmp(d->fail_jump, code);
}

static int read_u16(Decoder *d) {
    if (d->pos + 2 > d->size) fail(d, JPEG_CORRUPT, "truncated: the file ends inside a marker segment");
    int v = (d->data[d->pos] << 8) | d->data[d->pos + 1];
    d->pos += 2;
    return v;
}

/* The payload of the marker segment at d->pos: returns its start and
 * length, and moves d->pos past it. */
static const uint8_t *segment(Decoder *d, long *len) {
    long n = read_u16(d);
    if (n < 2 || d->pos + n - 2 > d->size) fail(d, JPEG_CORRUPT, "truncated: a marker segment runs past the end of the file");
    const uint8_t *p = d->data + d->pos;
    d->pos += n - 2;
    *len = n - 2;
    return p;
}

static void build_huffman(Decoder *d, HuffTable *t, int is_dc) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
        for (int i = 0; i < t->bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int n = p;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1 << si)) fail(d, JPEG_CORRUPT, "corrupt: bad Huffman table");
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (t->bits[l]) {
            t->valoffset[l] = p - huffcode[p];
            p += t->bits[l];
            t->maxcode[l] = huffcode[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->maxcode[17] = 0xFFFFF;
    memset(t->look, 0, sizeof(t->look));
    p = 0;
    for (int l = 1; l <= LOOK; l++) {
        for (int i = 0; i < t->bits[l]; i++, p++) {
            int lookbits = huffcode[p] << (LOOK - l);
            for (int c = 1 << (LOOK - l); c > 0; c--) t->look[lookbits++] = (uint16_t)((l << 8) | t->vals[p]);
        }
    }
    if (is_dc)
        for (int i = 0; i < n; i++)
            if (t->vals[i] > 15) fail(d, JPEG_CORRUPT, "corrupt: bad Huffman table (DC symbol %d)", t->vals[i]);
    t->defined = 1;
}

static void read_dht(Decoder *d) {
    long len;
    const uint8_t *p = segment(d, &len);
    while (len > 0) {
        if (len < 17) fail(d, JPEG_CORRUPT, "corrupt: short DHT segment");
        int tc = p[0] >> 4, th = p[0] & 15;
        if (tc > 1 || th > 3) fail(d, JPEG_CORRUPT, "corrupt: DHT table class %d id %d", tc, th);
        HuffTable *t = tc ? &d->ac[th] : &d->dc[th];
        int count = 0;
        t->bits[0] = 0;
        for (int i = 1; i <= 16; i++) {
            t->bits[i] = p[i];
            count += p[i];
        }
        if (count > 256 || 17 + count > len) fail(d, JPEG_CORRUPT, "corrupt: bad DHT segment");
        memcpy(t->vals, p + 17, (size_t)count);
        build_huffman(d, t, tc == 0);
        p += 17 + count;
        len -= 17 + count;
    }
}

static void read_dqt(Decoder *d) {
    long len;
    const uint8_t *p = segment(d, &len);
    while (len > 0) {
        int pq = p[0] >> 4, tq = p[0] & 15;
        long need = 1 + 64 * (pq ? 2 : 1);
        if (pq > 1 || tq > 3 || len < need) fail(d, JPEG_CORRUPT, "corrupt: bad DQT segment");
        for (int k = 0; k < 64; k++)
            d->qt[tq][ZIGZAG[k]] = pq ? (uint16_t)((p[1 + 2 * k] << 8) | p[2 + 2 * k]) : p[1 + k];
        d->qt_defined[tq] = 1;
        p += need;
        len -= need;
    }
}

static void read_sof(Decoder *d, int marker) {
    long len;
    const uint8_t *p = segment(d, &len);
    if (d->frame) fail(d, JPEG_CORRUPT, "corrupt: a second frame header");
    if (len < 6) fail(d, JPEG_CORRUPT, "corrupt: short SOF segment");
    if (p[0] != 8) fail(d, JPEG_UNSUPPORTED, "%d-bit sample precision (SOF%d) is not supported", p[0], marker - 0xC0);
    d->height = (p[1] << 8) | p[2];
    d->width = (p[3] << 8) | p[4];
    d->ncomp = p[5];
    if (d->height == 0) fail(d, JPEG_UNSUPPORTED, "a height defined by a DNL marker is not supported");
    if (d->width == 0) fail(d, JPEG_CORRUPT, "corrupt: zero image width");
    if (d->ncomp == 4) fail(d, JPEG_UNSUPPORTED, "4-component (CMYK or YCCK) images are not supported");
    if (d->ncomp != 1 && d->ncomp != 3)
        fail(d, JPEG_UNSUPPORTED, "%d-component images are not supported", d->ncomp);
    if (len < 6 + 3 * d->ncomp) fail(d, JPEG_CORRUPT, "corrupt: short SOF segment");
    d->maxh = d->maxv = 1;
    for (int i = 0; i < d->ncomp; i++) {
        Component *c = &d->comp[i];
        c->id = p[6 + 3 * i];
        c->h = p[7 + 3 * i] >> 4;
        c->v = p[7 + 3 * i] & 15;
        c->tq = p[8 + 3 * i];
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
            fail(d, JPEG_CORRUPT, "corrupt: component %d sampling %dx%d table %d", c->id, c->h, c->v, c->tq);
        if (c->h > d->maxh) d->maxh = c->h;
        if (c->v > d->maxv) d->maxv = c->v;
    }
    d->mcux = (d->width + 8 * d->maxh - 1) / (8 * d->maxh);
    d->mcuy = (d->height + 8 * d->maxv - 1) / (8 * d->maxv);
    for (int i = 0; i < d->ncomp; i++) {
        Component *c = &d->comp[i];
        if (d->maxh % c->h || d->maxv % c->v)
            fail(d, JPEG_UNSUPPORTED, "fractional sampling ratios (component %d at %dx%d of %dx%d) are not supported",
                 c->id, c->h, c->v, d->maxh, d->maxv);
        c->dw = (int)(((long)d->width * c->h + d->maxh - 1) / d->maxh);
        c->dh = (int)(((long)d->height * c->v + d->maxv - 1) / d->maxv);
        c->stride = d->mcux * c->h * 8;
        c->rows = d->mcuy * c->v * 8;
        for (int k = 0; k < 64; k++) c->coef_bits[k] = -1;
    }
    d->frame = 1;
    d->progressive = marker == 0xC2;
}

static void read_app(Decoder *d, int marker) {
    long len;
    const uint8_t *p = segment(d, &len);
    if (marker == 0xE0 && len >= 5 && memcmp(p, "JFIF\0", 5) == 0) d->saw_jfif = 1;
    if (marker == 0xEE && len >= 12 && memcmp(p, "Adobe", 5) == 0) {
        d->saw_adobe = 1;
        d->adobe_transform = p[11];
    }
}

/* ---- entropy-coded data ---------------------------------------------- */

/* Top the accumulator up to at least 57 bits. At a marker or the end of the
 * data it shifts in zeros and counts them in padbits: a decode that
 * consumes them has run past the data (checked after every block). */
static inline void fill(Decoder *d) {
    while (d->nbits <= 56) {
        unsigned b = 0;
        if (!d->marker_hit && d->pos < d->size) {
            b = d->data[d->pos];
            if (b == 0xFF) {
                long q = d->pos + 1;
                while (q < d->size && d->data[q] == 0xFF) q++; /* fill bytes */
                if (q < d->size && d->data[q] == 0x00) {
                    d->pos = q + 1;
                } else {
                    d->marker_hit = 1; /* d->pos stays on the marker's first 0xFF */
                    b = 0;
                    d->padbits += 8;
                }
            } else {
                d->pos++;
            }
        } else {
            d->padbits += 8;
        }
        d->acc |= (uint64_t)b << (56 - d->nbits);
        d->nbits += 8;
    }
}

static inline int get_bits(Decoder *d, int n) {
    if (n == 0) return 0;
    if (d->nbits < n) fill(d);
    int v = (int)(d->acc >> (64 - n));
    d->acc <<= n;
    d->nbits -= n;
    return v;
}

static inline int extend(int v, int n) { return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v; }

static inline int huff_decode(Decoder *d, const HuffTable *t) {
    if (d->nbits < 16) fill(d);
    int e = t->look[d->acc >> (64 - LOOK)];
    if (e) {
        int l = e >> 8;
        d->acc <<= l;
        d->nbits -= l;
        return e & 0xFF;
    }
    int l = LOOK + 1;
    int32_t code = (int32_t)(d->acc >> (64 - l));
    while (code > t->maxcode[l]) {
        l++;
        if (l > 16) fail(d, JPEG_CORRUPT, "corrupt: bad Huffman code");
        code = (int32_t)(d->acc >> (64 - l));
    }
    d->acc <<= l;
    d->nbits -= l;
    return t->vals[t->valoffset[l] + code];
}

/* The IDCT's output range limit (jdmaster.c prepare_range_limit_table, as
 * indexed by jidctint.c: x & 1023 after the descale). */
static inline uint8_t idct_limit(int x) {
    int i = x & 1023;
    if (i < 128) return (uint8_t)(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return (uint8_t)(i - 896);
}

/* jpeg_idct_islow: coef in natural order, dequantized here. */
static void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *in = coef + c;
        const uint16_t *qt = q + c;
        int *w = ws + c;
        if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 && in[48] == 0 && in[56] == 0) {
            int dc = (in[0] * qt[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; r++) w[8 * r] = dc;
            continue;
        }
        int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
        z2 = in[16] * qt[16];
        z3 = in[48] * qt[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = in[0] * qt[0];
        z3 = in[32] * qt[32];
        tmp0 = (z2 + z3) * (1 << CONST_BITS);
        tmp1 = (z2 - z3) * (1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = in[56] * qt[56];
        tmp1 = in[40] * qt[40];
        tmp2 = in[24] * qt[24];
        tmp3 = in[8] * qt[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        w[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
        w[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
        w[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
        w[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
        w[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
        w[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
        w[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
        w[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; r++) {
        const int *w = ws + 8 * r;
        uint8_t *o = out + (long)r * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
            uint8_t v = idct_limit((int)DESCALE((int64_t)w[0], PASS1_BITS + 3));
            memset(o, v, 8);
            continue;
        }
        int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
        z2 = w[2];
        z3 = w[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
        tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int s = CONST_BITS + PASS1_BITS + 3;
        o[0] = idct_limit((int)DESCALE(tmp10 + tmp3, s));
        o[7] = idct_limit((int)DESCALE(tmp10 - tmp3, s));
        o[1] = idct_limit((int)DESCALE(tmp11 + tmp2, s));
        o[6] = idct_limit((int)DESCALE(tmp11 - tmp2, s));
        o[2] = idct_limit((int)DESCALE(tmp12 + tmp1, s));
        o[5] = idct_limit((int)DESCALE(tmp12 - tmp1, s));
        o[3] = idct_limit((int)DESCALE(tmp13 + tmp0, s));
        o[4] = idct_limit((int)DESCALE(tmp13 - tmp0, s));
    }
}

/* A block that consumed the zeros fill() shifts in past the data ran off
 * its end. */
static inline void check_padding(Decoder *d) {
    if (d->padbits > d->nbits) fail(d, JPEG_CORRUPT, "truncated: the entropy-coded data ends before the image does");
}

static void decode_block(Decoder *d, Component *c, uint8_t *out) {
    int16_t coef[64];
    memset(coef, 0, sizeof(coef));
    const HuffTable *dc = &d->dc[c->td], *ac = &d->ac[c->ta];
    if (d->nbits < 32) fill(d);
    int s = huff_decode(d, dc);
    if (s) s = extend(get_bits(d, s), s);
    c->pred += s;
    coef[0] = (int16_t)c->pred;
    for (int k = 1; k < 64; k++) {
        if (d->nbits < 32) fill(d);
        int rs = huff_decode(d, ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) fail(d, JPEG_CORRUPT, "corrupt: an AC run past the end of a block");
            coef[ZIGZAG[k]] = (int16_t)extend(get_bits(d, s), s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    check_padding(d);
    idct_islow(coef, d->qt[c->tq], out, c->stride);
}

/* Move d->pos to the next marker (the entropy data's last byte is padded
 * with 1 bits; libjpeg skips stray bytes before a marker, so this does),
 * and reset the bit reader. Returns the marker code, or -1 at the end. */
static int next_marker_after_data(Decoder *d) {
    if (!d->marker_hit) {
        while (d->pos < d->size) {
            if (d->data[d->pos] == 0xFF && d->pos + 1 < d->size && d->data[d->pos + 1] != 0x00 &&
                d->data[d->pos + 1] != 0xFF)
                break;
            d->pos++;
        }
    }
    d->acc = 0;
    d->nbits = d->padbits = d->marker_hit = 0;
    while (d->pos < d->size && d->data[d->pos] == 0xFF) d->pos++;
    if (d->pos >= d->size) return -1;
    return d->data[d->pos++];
}

/* ---- progressive scans (jdphuff.c) -------------------------------------- */

/* DC first scan: the DC difference, point-transformed by al. */
static void dc_first(Decoder *d, Component *c, int16_t *blk, int al) {
    if (d->nbits < 32) fill(d);
    int s = huff_decode(d, &d->dc[c->td]);
    if (s) s = extend(get_bits(d, s), s);
    c->pred += s;
    blk[0] = (int16_t)(int)((unsigned)c->pred << al);
}

/* DC refinement: one more bit of the DC value. */
static void dc_refine(Decoder *d, int16_t *blk, int al) {
    if (get_bits(d, 1)) blk[0] = (int16_t)(blk[0] | (1 << al));
}

/* AC first scan of the band ss..se (zigzag): run-length coded values with
 * end-of-band runs that span blocks. */
static void ac_first(Decoder *d, Component *c, int16_t *blk, int ss, int se, int al) {
    if (d->eobrun > 0) {
        d->eobrun--;
        return;
    }
    const HuffTable *ac = &d->ac[c->ta];
    for (int k = ss; k <= se; k++) {
        if (d->nbits < 32) fill(d);
        int rs = huff_decode(d, ac), r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            if (k > se) fail(d, JPEG_CORRUPT, "corrupt: an AC run past the end of a spectral band");
            blk[ZIGZAG[k]] = (int16_t)(int)((unsigned)extend(get_bits(d, s), s) << al);
        } else if (r == 15) {
            k += 15;
        } else {
            d->eobrun = 1 << r;
            if (r) d->eobrun += get_bits(d, r);
            d->eobrun--;
            break;
        }
    }
}

/* One correction bit for a coefficient already nonzero: a 1 moves it one
 * step of 1 << al away from zero, unless that bit is already set. */
static inline void correct(Decoder *d, int16_t *coef, int p1) {
    if (get_bits(d, 1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef - p1);
}

/* AC refinement scan: newly nonzero coefficients of magnitude 1 << al, and
 * a correction bit for each coefficient already nonzero that the band's
 * runs pass over, also within an end-of-band run. */
static void ac_refine(Decoder *d, Component *c, int16_t *blk, int ss, int se, int al) {
    const int p1 = 1 << al;
    const HuffTable *ac = &d->ac[c->ta];
    int k = ss;
    if (d->eobrun == 0) {
        for (; k <= se; k++) {
            if (d->nbits < 32) fill(d);
            int rs = huff_decode(d, ac), r = rs >> 4, s = rs & 15;
            if (s) { /* s must be 1; libjpeg warns and reads the sign bit either way */
                s = get_bits(d, 1) ? p1 : -p1;
            } else if (r != 15) {
                d->eobrun = 1 << r;
                if (r) d->eobrun += get_bits(d, r);
                break;
            }
            /* Pass over the nonzero coefficients (a correction bit each) and
             * r zero ones; a new value goes into the zero one after them. */
            do {
                int16_t *coef = blk + ZIGZAG[k];
                if (*coef != 0)
                    correct(d, coef, p1);
                else if (--r < 0)
                    break;
                k++;
            } while (k <= se);
            if (s) {
                if (k > se) fail(d, JPEG_CORRUPT, "corrupt: an AC run past the end of a spectral band");
                blk[ZIGZAG[k]] = (int16_t)s;
            }
        }
    }
    if (d->eobrun > 0) {
        for (; k <= se; k++)
            if (blk[ZIGZAG[k]] != 0) correct(d, blk + ZIGZAG[k], p1);
        d->eobrun--;
    }
}

static void read_sos(Decoder *d) {
    long len;
    const uint8_t *p = segment(d, &len);
    if (!d->frame) fail(d, JPEG_CORRUPT, "corrupt: a scan before the frame header");
    int ns = p[0];
    if (ns < 1 || ns > d->ncomp || len < 4 + 2 * ns) fail(d, JPEG_CORRUPT, "corrupt: bad SOS segment");
    int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
    /* the scan's kind: 0 sequential, 1 DC first, 2 DC refinement, 3 AC
     * first, 4 AC refinement */
    int kind = 0;
    if (d->progressive) {
        if (ss == 0 ? se != 0 : se < ss || se > 63 || ns != 1)
            fail(d, JPEG_CORRUPT, "corrupt: a progressive scan of %d components with spectral selection %d-%d", ns, ss,
                 se);
        if ((ah != 0 && al != ah - 1) || al > 13)
            fail(d, JPEG_CORRUPT, "corrupt: successive approximation Ah %d Al %d", ah, al);
        kind = (ss == 0 ? 1 : 3) + (ah != 0);
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
        fail(d, JPEG_CORRUPT, "corrupt: a sequential scan with spectral selection %d-%d", ss, se);
    }
    Component *sc[3];
    int blocks = 0;
    for (int i = 0; i < ns; i++) {
        int id = p[1 + 2 * i], tables = p[2 + 2 * i];
        Component *c = NULL;
        for (int k = 0; k < d->ncomp; k++)
            if (d->comp[k].id == id) c = &d->comp[k];
        if (!c) fail(d, JPEG_CORRUPT, "corrupt: the scan names component %d, which the frame lacks", id);
        if (c->decoded && !d->progressive) fail(d, JPEG_CORRUPT, "corrupt: component %d appears in two scans", id);
        c->td = tables >> 4;
        c->ta = tables & 15;
        int need_dc = kind <= 1, need_ac = kind == 0 || kind >= 3;
        if (c->td > 3 || c->ta > 3 || (need_dc && !d->dc[c->td].defined) || (need_ac && !d->ac[c->ta].defined))
            fail(d, JPEG_CORRUPT, "corrupt: component %d uses an undefined Huffman table", id);
        if (!d->qt_defined[c->tq]) fail(d, JPEG_CORRUPT, "corrupt: component %d uses an undefined quantization table", id);
        sc[i] = c;
        blocks += c->h * c->v;
    }
    if (ns > 1 && blocks > 10) fail(d, JPEG_CORRUPT, "corrupt: %d blocks in an MCU", blocks);
    for (int i = 0; i < ns; i++) {
        Component *c = sc[i];
        if (d->progressive && !c->coef) {
            c->coef = (int16_t *)calloc((size_t)(c->stride / 8) * (c->rows / 8) * 64, sizeof(int16_t));
            if (!c->coef) fail(d, JPEG_CORRUPT, "out of memory for %dx%d coefficient blocks", c->stride / 8, c->rows / 8);
            memcpy(c->q, d->qt[c->tq], sizeof(c->q)); /* latched as libjpeg latches it */
        } else if (!d->progressive && !c->plane) {
            c->plane = (uint8_t *)malloc((size_t)c->stride * c->rows);
            if (!c->plane) fail(d, JPEG_CORRUPT, "out of memory for a %dx%d plane", c->stride, c->rows);
        }
        for (int k = ss; kind && k <= se; k++) c->coef_bits[k] = al;
        c->pred = 0;
    }
    d->acc = 0;
    d->nbits = d->padbits = d->marker_hit = 0;
    d->eobrun = 0;
    /* An interleaved scan walks MCUs of h x v blocks of each component; a
     * single-component scan walks that component's own blocks. */
    long nx, ny;
    if (ns == 1) {
        nx = (sc[0]->dw + 7) / 8;
        ny = (sc[0]->dh + 7) / 8;
    } else {
        nx = d->mcux;
        ny = d->mcuy;
    }
    long count = 0;
    int rst = 0;
    for (long my = 0; my < ny; my++) {
        for (long mx = 0; mx < nx; mx++) {
            if (d->restart_interval && count > 0 && count % d->restart_interval == 0) {
                int m = next_marker_after_data(d);
                if (m < 0) fail(d, JPEG_CORRUPT, "truncated: the file ends inside a scan");
                if (m != 0xD0 + rst) fail(d, JPEG_CORRUPT, "corrupt: expected restart marker RST%d", rst);
                rst = (rst + 1) & 7;
                for (int i = 0; i < ns; i++) sc[i]->pred = 0;
                d->eobrun = 0;
            }
            for (int i = 0; i < ns; i++) {
                Component *c = sc[i];
                int bh = ns == 1 ? 1 : c->h, bv = ns == 1 ? 1 : c->v;
                for (int v = 0; v < bv; v++) {
                    for (int h = 0; h < bh; h++) {
                        long bx = mx * bh + h, by = my * bv + v;
                        if (kind == 0) {
                            decode_block(d, c, c->plane + by * 8 * c->stride + bx * 8);
                            continue;
                        }
                        int16_t *blk = c->coef + 64 * (by * (c->stride / 8) + bx);
                        switch (kind) {
                        case 1: dc_first(d, c, blk, al); break;
                        case 2: dc_refine(d, blk, al); break;
                        case 3: ac_first(d, c, blk, ss, se, al); break;
                        default: ac_refine(d, c, blk, ss, se, al); break;
                        }
                        check_padding(d);
                    }
                }
            }
            count++;
        }
    }
    for (int i = 0; i < ns; i++) sc[i]->decoded = 1;
    /* leave d->pos on the next marker */
    int m = next_marker_after_data(d);
    if (m >= 0) d->pos -= 2;
}

/* After a progressive file's EOI: every component's DC was sent, and no
 * block needs libjpeg's smoothing (jdcoefct.c:smoothing_ok smooths while
 * some bits of coefficients 1-9 are still unknown at output, a file that
 * stops short of its last refinement scans), which this decoder does not
 * do. Then each block's IDCT into its component's plane. */
static void finish_progressive(Decoder *d) {
    for (int i = 0; i < d->ncomp; i++) {
        Component *c = &d->comp[i];
        if (c->coef_bits[0] < 0) fail(d, JPEG_CORRUPT, "truncated: EOI before the DC scan of component %d", c->id);
    }
    for (int i = 0; i < d->ncomp; i++)
        for (int k = 1; k < 10; k++)
            if (d->comp[i].coef_bits[k] != 0)
                fail(d, JPEG_UNSUPPORTED,
                     "a progressive JPEG whose scans leave bits of coefficient %d of component %d unsent (libjpeg "
                     "smooths its blocks) is not supported", k, d->comp[i].id);
    for (int i = 0; i < d->ncomp; i++) {
        Component *c = &d->comp[i];
        c->plane = (uint8_t *)malloc((size_t)c->stride * c->rows);
        if (!c->plane) fail(d, JPEG_CORRUPT, "out of memory for a %dx%d plane", c->stride, c->rows);
        long bw = c->stride / 8, bh = c->rows / 8;
        for (long by = 0; by < bh; by++)
            for (long bx = 0; bx < bw; bx++)
                idct_islow(c->coef + 64 * (by * bw + bx), c->q, c->plane + by * 8 * c->stride + bx * 8, c->stride);
    }
}

/* Parse up to and including every scan; returns when EOI is read (or the
 * data ends after every component's scan). */
static void parse(Decoder *d, int header_only) {
    if (d->size < 4 || d->data[0] != 0xFF || d->data[1] != 0xD8) fail(d, JPEG_CORRUPT, "not a JPEG file (no SOI marker)");
    d->pos = 2;
    for (;;) {
        if (d->pos >= d->size) { /* a sequential file may stop after its last scan; a progressive one has EOI */
            int done = d->frame && !d->progressive;
            for (int i = 0; i < d->ncomp; i++) done &= d->comp[i].decoded;
            if (done && !header_only) return;
            fail(d, JPEG_CORRUPT, "truncated: the file ends before the image does");
        }
        if (d->data[d->pos] != 0xFF) fail(d, JPEG_CORRUPT, "corrupt: expected a marker at byte %ld", d->pos);
        while (d->pos < d->size && d->data[d->pos] == 0xFF) d->pos++;
        if (d->pos >= d->size) fail(d, JPEG_CORRUPT, "truncated: the file ends inside a marker");
        int m = d->data[d->pos++];
        switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
            read_sof(d, m);
            if (header_only) return;
            break;
        case 0xC3: fail(d, JPEG_UNSUPPORTED, "lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7:
            fail(d, JPEG_UNSUPPORTED, "hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
            fail(d, JPEG_UNSUPPORTED, "arithmetic-coded JPEG (SOF%d) is not supported", m - 0xC0);
        case 0xCC: fail(d, JPEG_UNSUPPORTED, "arithmetic-coded JPEG (DAC) is not supported");
        case 0xC4: read_dht(d); break;
        case 0xDB: read_dqt(d); break;
        case 0xDD: {
            long len;
            const uint8_t *p = segment(d, &len);
            if (len < 2) fail(d, JPEG_CORRUPT, "corrupt: short DRI segment");
            d->restart_interval = (p[0] << 8) | p[1];
            break;
        }
        case 0xDA: read_sos(d); break;
        case 0xD9: {
            int done = d->frame;
            for (int i = 0; i < d->ncomp; i++) done &= d->comp[i].decoded;
            if (!done) fail(d, JPEG_CORRUPT, "truncated: EOI before every component was decoded");
            if (d->progressive) finish_progressive(d);
            return;
        }
        case 0xDC: fail(d, JPEG_UNSUPPORTED, "a DNL marker is not supported");
        case 0xFE: {
            long len;
            segment(d, &len);
            break;
        }
        default:
            if (m >= 0xE0 && m <= 0xEF) {
                read_app(d, m);
                break;
            }
            fail(d, JPEG_CORRUPT, "corrupt: unexpected marker 0x%02X", m);
        }
    }
}

/* ---- upsampling and colour conversion -------------------------------- */

/* One output row of component c at the image's full resolution, into out
 * (width samples), as libjpeg's upsampler (jdsample.c) produces it. tmp
 * holds 2 * dw + 1 samples: the 2x filters write whole sample pairs. */
static void upsample_row(const Decoder *d, const Component *c, int y, uint8_t *out, uint8_t *tmp) {
    int rh = d->maxh / c->h, rv = d->maxv / c->v, w = d->width, dw = c->dw;
    const uint8_t *row = c->plane + (long)(y / rv) * c->stride;
    if (rh == 1 && rv == 1) {
        memcpy(out, row, (size_t)w);
    } else if (rh == 2 && rv == 1 && dw > 2) { /* h2v1_fancy_upsample */
        uint8_t *o = tmp;
        o[0] = row[0];
        o[1] = (uint8_t)((row[0] * 3 + row[1] + 2) >> 2);
        for (int k = 1; k < dw - 1; k++) {
            int v3 = row[k] * 3;
            o[2 * k] = (uint8_t)((v3 + row[k - 1] + 1) >> 2);
            o[2 * k + 1] = (uint8_t)((v3 + row[k + 1] + 2) >> 2);
        }
        o[2 * dw - 2] = (uint8_t)((row[dw - 1] * 3 + row[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = row[dw - 1];
        memcpy(out, o, (size_t)w);
    } else if (rh == 1 && rv == 2) { /* h1v2_fancy_upsample */
        int i = y >> 1, odd = y & 1;
        int j = odd ? (i + 1 < c->dh ? i + 1 : i) : (i > 0 ? i - 1 : 0);
        const uint8_t *near = c->plane + (long)i * c->stride, *far = c->plane + (long)j * c->stride;
        int bias = odd ? 2 : 1;
        for (int x = 0; x < w; x++) out[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
    } else if (rh == 2 && rv == 2 && dw > 2) { /* h2v2_fancy_upsample */
        int i = y >> 1, odd = y & 1;
        int j = odd ? (i + 1 < c->dh ? i + 1 : i) : (i > 0 ? i - 1 : 0);
        const uint8_t *near = c->plane + (long)i * c->stride, *far = c->plane + (long)j * c->stride;
        uint8_t *o = tmp;
        int last = near[0] * 3 + far[0], this_sum = last, next;
        for (int k = 0; k < dw; k++) {
            next = k + 1 < dw ? near[k + 1] * 3 + far[k + 1] : this_sum;
            o[2 * k] = (uint8_t)((this_sum * 3 + last + 8) >> 4);
            o[2 * k + 1] = (uint8_t)((this_sum * 3 + next + 7) >> 4);
            last = this_sum;
            this_sum = next;
        }
        memcpy(out, o, (size_t)w);
    } else { /* int_upsample, h2v1_upsample, h2v2_upsample: replication */
        for (int x = 0; x < w; x++) out[x] = row[x / rh];
    }
}

#define SCALEBITS 16
#define ONE_HALF ((int32_t)1 << (SCALEBITS - 1))
#define FIX16(x) ((int32_t)((x) * (1L << SCALEBITS) + 0.5))

static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

static void convert(const Decoder *d, uint8_t *out, uint8_t *rows) {
    int w = d->width, nc = d->ncomp;
    int ycc = 1;
    if (nc == 3) {
        if (d->saw_jfif)
            ycc = 1;
        else if (d->saw_adobe)
            ycc = d->adobe_transform != 0;
        else if (d->comp[0].id == 82 && d->comp[1].id == 71 && d->comp[2].id == 66)
            ycc = 0; /* 'R', 'G', 'B' */
    }
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
        int32_t x = i - 128;
        cr_r[i] = (int)((FIX16(1.40200) * x + ONE_HALF) >> SCALEBITS);
        cb_b[i] = (int)((FIX16(1.77200) * x + ONE_HALF) >> SCALEBITS);
        cr_g[i] = (-FIX16(0.71414)) * x;
        cb_g[i] = (-FIX16(0.34414)) * x + ONE_HALF;
    }
    uint8_t *r0 = rows, *r1 = rows + w, *r2 = rows + 2 * (long)w, *tmp = rows + 3 * (long)w;
    for (int y = 0; y < d->height; y++) {
        uint8_t *o = out + (long)y * w * nc;
        if (nc == 1) {
            upsample_row(d, &d->comp[0], y, o, tmp);
            continue;
        }
        upsample_row(d, &d->comp[0], y, r0, tmp);
        upsample_row(d, &d->comp[1], y, r1, tmp);
        upsample_row(d, &d->comp[2], y, r2, tmp);
        if (!ycc) {
            for (int x = 0; x < w; x++) {
                o[3 * x] = r0[x];
                o[3 * x + 1] = r1[x];
                o[3 * x + 2] = r2[x];
            }
            continue;
        }
        for (int x = 0; x < w; x++) {
            int yy = r0[x], cb = r1[x], cr = r2[x];
            o[3 * x] = clamp255(yy + cr_r[cr]);
            o[3 * x + 1] = clamp255(yy + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
            o[3 * x + 2] = clamp255(yy + cb_b[cb]);
        }
    }
}

static void free_decoder(Decoder *d) {
    for (int i = 0; i < 3; i++) {
        free(d->comp[i].plane);
        free(d->comp[i].coef);
        d->comp[i].plane = NULL;
        d->comp[i].coef = NULL;
    }
}

/* The frame header: width, height and channels (1 or 3). Returns JPEG_OK,
 * JPEG_UNSUPPORTED or JPEG_CORRUPT with a message in err. */
int jpeg_header(const uint8_t *data, long size, int *width, int *height, int *channels, char *err, int errlen) {
    Decoder *d = (Decoder *)calloc(1, sizeof(Decoder));
    if (!d) return JPEG_CORRUPT;
    d->data = data;
    d->size = size;
    d->err = err;
    d->errlen = errlen;
    int code = setjmp(d->fail_jump);
    if (code == 0) {
        parse(d, 1);
        if (!d->frame) fail(d, JPEG_CORRUPT, "no frame header");
        *width = d->width;
        *height = d->height;
        *channels = d->ncomp;
    }
    free(d);
    return code;
}

/* Decode the whole file into out (height x width x channels uint8, the
 * sizes jpeg_header gives). Writes out only when the stream decoded. */
int jpeg_decode(const uint8_t *data, long size, uint8_t *out, int width, int height, int channels, char *err,
                int errlen) {
    Decoder *d = (Decoder *)calloc(1, sizeof(Decoder));
    if (!d) return JPEG_CORRUPT;
    d->data = data;
    d->size = size;
    d->err = err;
    d->errlen = errlen;
    uint8_t *volatile rows = NULL;
    int code = setjmp(d->fail_jump);
    if (code == 0) {
        parse(d, 0);
        if (d->width != width || d->height != height || d->ncomp != channels)
            fail(d, JPEG_CORRUPT, "the frame is %dx%dx%d, the caller expected %dx%dx%d", d->width, d->height,
                 d->ncomp, width, height, channels);
        rows = (uint8_t *)malloc((size_t)5 * width + 8);
        if (!rows) fail(d, JPEG_CORRUPT, "out of memory");
        convert(d, out, rows);
    }
    free(rows);
    free_decoder(d);
    free(d);
    return code;
}

/* ======================================================================= */
/* Encoder                                                                 */
/* ======================================================================= */

static const uint8_t STD_LUMA_Q[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const uint8_t STD_CHROMA_Q[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

static const uint8_t DC_LUMA_BITS[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t DC_CHROMA_BITS[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t AC_LUMA_BITS[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t AC_LUMA_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t AC_CHROMA_BITS[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t AC_CHROMA_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
    uint16_t code[256];
    uint8_t size[256];
} EncTable;

static void build_enc_table(EncTable *t, const uint8_t *bits, const uint8_t *vals) {
    memset(t, 0, sizeof(*t));
    int code = 0, p = 0;
    for (int l = 1; l <= 16; l++) {
        for (int i = 0; i < bits[l]; i++, p++) {
            t->code[vals[p]] = (uint16_t)code++;
            t->size[vals[p]] = (uint8_t)l;
        }
        code <<= 1;
    }
}

typedef struct {
    uint8_t *buf;
    long len, cap;
    uint64_t acc; /* bits not yet written, right-aligned */
    int nbits;
    int oom;
} Writer;

static void put_byte(Writer *w, uint8_t b) {
    if (w->len + 2 > w->cap) {
        long cap = w->cap * 2 + 4096;
        uint8_t *nb = (uint8_t *)realloc(w->buf, (size_t)cap);
        if (!nb) {
            w->oom = 1;
            return;
        }
        w->buf = nb;
        w->cap = cap;
    }
    w->buf[w->len++] = b;
}

static void put_u16(Writer *w, int v) {
    put_byte(w, (uint8_t)(v >> 8));
    put_byte(w, (uint8_t)v);
}

static inline void put_bits(Writer *w, uint32_t code, int size) {
    w->acc = (w->acc << size) | (code & ((1u << size) - 1));
    w->nbits += size;
    while (w->nbits >= 8) {
        uint8_t b = (uint8_t)(w->acc >> (w->nbits - 8));
        put_byte(w, b);
        if (b == 0xFF) put_byte(w, 0); /* byte stuffing */
        w->nbits -= 8;
    }
}

static void flush_bits(Writer *w) {
    if (w->nbits > 0) put_bits(w, 0x7F, 8 - w->nbits); /* pad with 1 bits */
    w->acc = 0;
    w->nbits = 0;
}

/* jpeg_fdct_islow: 8x8 samples less 128 in, coefficients scaled by 8 out. */
static void fdct_islow(int32_t *data) {
    int32_t *p = data;
    for (int r = 0; r < 8; r++, p += 8) {
        int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
        int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[2] = (int32_t)DESCALE(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
        p[6] = (int32_t)DESCALE(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[7] = (int32_t)DESCALE(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
        p[5] = (int32_t)DESCALE(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
        p[3] = (int32_t)DESCALE(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
        p[1] = (int32_t)DESCALE(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
    }
    p = data;
    for (int c = 0; c < 8; c++, p++) {
        int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = (int32_t)DESCALE(tmp10 + tmp11, PASS1_BITS);
        p[32] = (int32_t)DESCALE(tmp10 - tmp11, PASS1_BITS);
        int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[16] = (int32_t)DESCALE(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
        p[48] = (int32_t)DESCALE(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[56] = (int32_t)DESCALE(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
        p[40] = (int32_t)DESCALE(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
        p[24] = (int32_t)DESCALE(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
        p[8] = (int32_t)DESCALE(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
    }
}

static inline int magnitude_bits(int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
        n++;
        a >>= 1;
    }
    return n;
}

/* Forward DCT and quantization (rounded, as libjpeg divides) of the 8x8
 * block at src (stride samples) into coef (zigzag order). */
static void quantize_block(const uint8_t *src, long stride, const uint16_t *q, int16_t *coef) {
    int32_t data[64];
    for (int r = 0; r < 8; r++)
        for (int c = 0; c < 8; c++) data[8 * r + c] = (int32_t)src[r * stride + c] - 128;
    fdct_islow(data);
    for (int k = 0; k < 64; k++) {
        int n = ZIGZAG[k];
        int32_t div = (int32_t)q[n] * 8, v = data[n];
        coef[k] = (int16_t)(v < 0 ? -((-v + div / 2) / div) : (v + div / 2) / div);
    }
}

/* Huffman coding of one block of a sequential scan. */
static void encode_block(Writer *w, const int16_t *coef, int *pred, const EncTable *dc, const EncTable *ac) {
    int diff = coef[0] - *pred;
    *pred = coef[0];
    int nb = magnitude_bits(diff);
    put_bits(w, dc->code[nb], dc->size[nb]);
    if (nb) put_bits(w, (uint32_t)(diff < 0 ? diff - 1 : diff), nb);
    int run = 0;
    for (int k = 1; k < 64; k++) {
        int v = coef[k];
        if (v == 0) {
            run++;
            continue;
        }
        while (run > 15) {
            put_bits(w, ac->code[0xF0], ac->size[0xF0]);
            run -= 16;
        }
        nb = magnitude_bits(v);
        int sym = (run << 4) | nb;
        put_bits(w, ac->code[sym], ac->size[sym]);
        put_bits(w, (uint32_t)(v < 0 ? v - 1 : v), nb);
        run = 0;
    }
    if (run > 0) put_bits(w, ac->code[0x00], ac->size[0x00]);
}

static void write_dht(Writer *w, int cls, int id, const uint8_t *bits, const uint8_t *vals) {
    int n = 0;
    for (int l = 1; l <= 16; l++) n += bits[l];
    put_u16(w, 0xFFC4);
    put_u16(w, 2 + 17 + n);
    put_byte(w, (uint8_t)((cls << 4) | id));
    for (int l = 1; l <= 16; l++) put_byte(w, bits[l]);
    for (int i = 0; i < n; i++) put_byte(w, vals[i]);
}

/* ---- progressive encoding (jcphuff.c, jchuff.c) ---------------------------- */

#define MAX_CORR_BITS 1000 /* correction bits buffered over an end-of-band run */

/* Huffman code lengths from symbol counts by the Annex K.2 procedure, as
 * jchuff.c:jpeg_gen_optimal_table builds them: a pseudo-symbol 256 keeps
 * any code from being all ones, lengths past 16 are folded back, and the
 * symbols are listed by code length. freq is consumed. */
static void optimal_table(long *freq, uint8_t *bits, uint8_t *vals) {
    int codesize[257], others[257], count[64];
    memset(codesize, 0, sizeof(codesize));
    memset(count, 0, sizeof(count));
    for (int i = 0; i < 257; i++) others[i] = -1;
    freq[256] = 1;
    for (;;) {
        int c1 = -1, c2 = -1;
        long v = -1;
        for (int i = 0; i < 257; i++) /* the smallest count, the larger symbol on ties */
            if (freq[i] && (v < 0 || freq[i] <= v)) {
                v = freq[i];
                c1 = i;
            }
        v = -1;
        for (int i = 0; i < 257; i++)
            if (freq[i] && (v < 0 || freq[i] <= v) && i != c1) {
                v = freq[i];
                c2 = i;
            }
        if (c2 < 0) break;
        freq[c1] += freq[c2];
        freq[c2] = 0;
        codesize[c1]++;
        while (others[c1] >= 0) {
            c1 = others[c1];
            codesize[c1]++;
        }
        others[c1] = c2;
        codesize[c2]++;
        while (others[c2] >= 0) {
            c2 = others[c2];
            codesize[c2]++;
        }
    }
    for (int i = 0; i < 257; i++)
        if (codesize[i]) count[codesize[i] < 63 ? codesize[i] : 63]++;
    for (int i = 63; i > 16; i--) {
        while (count[i] > 0) {
            int j = i - 2;
            while (count[j] == 0) j--;
            count[i] -= 2;
            count[i - 1]++;
            count[j + 1] += 2;
            count[j]--;
        }
    }
    int i = 16;
    while (count[i] == 0) i--;
    count[i]--; /* the pseudo-symbol's code goes */
    bits[0] = 0;
    for (int l = 1; l <= 16; l++) bits[l] = (uint8_t)count[l];
    int p = 0;
    for (int l = 1; l < 64; l++)
        for (int j = 0; j < 256; j++)
            if (codesize[j] == l) vals[p++] = (uint8_t)j;
}

typedef struct {
    const int16_t *coef; /* zigzag order, bw blocks a row */
    long bw, nbx, nby;   /* nbx x nby: the blocks a single-component scan covers */
    int h, v, tbl;       /* sampling, Huffman table id */
} EncComp;

typedef struct {
    int ns, comp[3], ss, se, ah, al;
} Scan;

typedef struct {
    Writer *w;
    int gather;        /* count symbols into freq instead of writing codes */
    long freq[2][257];
    EncTable tab[2];
    int tbl;           /* an AC scan's table */
    int eobrun, be;    /* end-of-band run and its buffered correction bits */
    uint8_t corr[MAX_CORR_BITS];
} Prog;

static inline void emit_symbol(Prog *e, int tbl, int sym) {
    if (e->gather)
        e->freq[tbl][sym]++;
    else
        put_bits(e->w, e->tab[tbl].code[sym], e->tab[tbl].size[sym]);
}

static inline void emit_bits(Prog *e, uint32_t v, int n) {
    if (!e->gather) put_bits(e->w, v, n);
}

static void emit_corr(Prog *e, const uint8_t *bits, int n) {
    for (int i = 0; i < n; i++) emit_bits(e, bits[i], 1);
}

static void emit_eobrun(Prog *e) {
    if (e->eobrun == 0) return;
    int nb = 0;
    for (int t = e->eobrun; t >>= 1;) nb++;
    emit_symbol(e, e->tbl, nb << 4);
    if (nb) emit_bits(e, (uint32_t)e->eobrun, nb);
    e->eobrun = 0;
    emit_corr(e, e->corr, e->be);
    e->be = 0;
}

static void enc_dc_first(Prog *e, const int16_t *blk, int *pred, int tbl, int al) {
    int v = blk[0] >> al; /* arithmetic shift, as libjpeg's IRIGHT_SHIFT */
    int diff = v - *pred;
    *pred = v;
    int nb = magnitude_bits(diff);
    emit_symbol(e, tbl, nb);
    if (nb) emit_bits(e, (uint32_t)(diff < 0 ? diff - 1 : diff), nb);
}

static void enc_ac_first(Prog *e, const int16_t *blk, int ss, int se, int al) {
    int r = 0;
    for (int k = ss; k <= se; k++) {
        int v = blk[k];
        int mag = (v < 0 ? -v : v) >> al; /* the point transform rounds toward zero */
        if (mag == 0) {
            r++;
            continue;
        }
        emit_eobrun(e);
        while (r > 15) {
            emit_symbol(e, e->tbl, 0xF0);
            r -= 16;
        }
        int nb = magnitude_bits(mag);
        emit_symbol(e, e->tbl, (r << 4) + nb);
        emit_bits(e, (uint32_t)(v < 0 ? ~mag : mag), nb);
        r = 0;
    }
    if (r > 0 && ++e->eobrun == 0x7FFF) emit_eobrun(e);
}

static void enc_ac_refine(Prog *e, const int16_t *blk, int ss, int se, int al) {
    int mag[64], eob = 0;
    for (int k = ss; k <= se; k++) {
        int v = blk[k];
        mag[k] = (v < 0 ? -v : v) >> al;
        if (mag[k] == 1) eob = k; /* the last coefficient that becomes nonzero in this scan */
    }
    int r = 0, br = 0;
    uint8_t *buf = e->corr + e->be; /* this block's correction bits, after the run's */
    for (int k = ss; k <= se; k++) {
        if (mag[k] == 0) {
            r++;
            continue;
        }
        while (r > 15 && k <= eob) { /* ZRLs, unless they fold into an end of band */
            emit_eobrun(e);
            emit_symbol(e, e->tbl, 0xF0);
            r -= 16;
            emit_corr(e, buf, br);
            buf = e->corr;
            br = 0;
        }
        if (mag[k] > 1) { /* already nonzero: its next bit, sent with the next symbol */
            buf[br++] = (uint8_t)(mag[k] & 1);
            continue;
        }
        emit_eobrun(e);
        emit_symbol(e, e->tbl, (r << 4) + 1);
        emit_bits(e, blk[k] < 0 ? 0 : 1, 1);
        emit_corr(e, buf, br);
        buf = e->corr;
        br = 0;
        r = 0;
    }
    if (r > 0 || br > 0) {
        e->eobrun++;
        e->be += br;
        if (e->eobrun == 0x7FFF || e->be > MAX_CORR_BITS - 64 + 1) emit_eobrun(e);
    }
}

/* One pass over a progressive scan's blocks: counting (e->gather) or
 * writing, with restart markers every restart_interval MCUs. */
static void scan_pass(Prog *e, const Scan *sc, const EncComp *comps, long mcux, long mcuy, int restart_interval) {
    int pred[3] = {0, 0, 0};
    e->eobrun = e->be = 0;
    const EncComp *c0 = &comps[sc->comp[0]];
    long nx = sc->ns == 1 ? c0->nbx : mcux, ny = sc->ns == 1 ? c0->nby : mcuy;
    long count = 0;
    int rst = 0;
    for (long my = 0; my < ny; my++) {
        for (long mx = 0; mx < nx; mx++) {
            if (restart_interval && count > 0 && count % restart_interval == 0) {
                emit_eobrun(e);
                if (!e->gather) {
                    flush_bits(e->w);
                    put_u16(e->w, 0xFFD0 + rst);
                }
                rst = (rst + 1) & 7;
                pred[0] = pred[1] = pred[2] = 0;
            }
            for (int i = 0; i < sc->ns; i++) {
                const EncComp *c = &comps[sc->comp[i]];
                int bh = sc->ns == 1 ? 1 : c->h, bv = sc->ns == 1 ? 1 : c->v;
                for (int v = 0; v < bv; v++) {
                    for (int h = 0; h < bh; h++) {
                        const int16_t *blk = c->coef + 64 * ((my * bv + v) * c->bw + mx * bh + h);
                        if (sc->ss == 0 && sc->ah == 0)
                            enc_dc_first(e, blk, &pred[i], c->tbl, sc->al);
                        else if (sc->ss == 0)
                            emit_bits(e, (uint32_t)(blk[0] >> sc->al), 1); /* DC refinement: bit al */
                        else if (sc->ah == 0)
                            enc_ac_first(e, blk, sc->ss, sc->se, sc->al);
                        else
                            enc_ac_refine(e, blk, sc->ss, sc->se, sc->al);
                    }
                }
            }
            count++;
        }
    }
    emit_eobrun(e);
}

/* libjpeg's jpeg_simple_progression script: 10 scans for YCbCr, 6 for grey. */
static int simple_progression(int channels, Scan *out) {
    static const Scan YCC[10] = {
        {3, {0, 1, 2}, 0, 0, 0, 1}, {1, {0}, 1, 5, 0, 2},  {1, {2}, 1, 63, 0, 1}, {1, {1}, 1, 63, 0, 1},
        {1, {0}, 6, 63, 0, 2},      {1, {0}, 1, 63, 2, 1}, {3, {0, 1, 2}, 0, 0, 1, 0}, {1, {2}, 1, 63, 1, 0},
        {1, {1}, 1, 63, 1, 0},      {1, {0}, 1, 63, 1, 0}};
    static const Scan GREY[6] = {{1, {0}, 0, 0, 0, 1}, {1, {0}, 1, 5, 0, 2},  {1, {0}, 6, 63, 0, 2},
                                 {1, {0}, 1, 63, 2, 1}, {1, {0}, 0, 0, 1, 0}, {1, {0}, 1, 63, 1, 0}};
    int n = channels == 3 ? 10 : 6;
    memcpy(out, channels == 3 ? YCC : GREY, (size_t)n * sizeof(Scan));
    return n;
}

/* Every scan of a progressive file: per scan, a counting pass, the
 * optimal Huffman tables of the tables it uses (DHT), its SOS and its
 * entropy-coded data. Returns 0, or -1 when out of memory. */
static int encode_progressive(Writer *w, const EncComp *comps, int channels, long mcux, long mcuy, int restart_interval) {
    Scan script[10];
    int nscans = simple_progression(channels, script);
    Prog *e = (Prog *)calloc(1, sizeof(Prog));
    if (!e) return -1;
    e->w = w;
    for (int s = 0; s < nscans; s++) {
        const Scan *sc = &script[s];
        int dc = sc->ss == 0;
        e->tbl = comps[sc->comp[0]].tbl;
        if (!(dc && sc->ah)) { /* a DC refinement scan codes raw bits, no table */
            memset(e->freq, 0, sizeof(e->freq));
            e->gather = 1;
            scan_pass(e, sc, comps, mcux, mcuy, restart_interval);
            for (int t = 0; t < 2; t++) {
                int used = 0;
                for (int i = 0; i < sc->ns; i++) used |= comps[sc->comp[i]].tbl == t;
                if (!used) continue;
                uint8_t bits[17], vals[256];
                optimal_table(e->freq[t], bits, vals);
                build_enc_table(&e->tab[t], bits, vals);
                write_dht(w, dc ? 0 : 1, t, bits, vals);
            }
        }
        put_u16(w, 0xFFDA);
        put_u16(w, 6 + 2 * sc->ns);
        put_byte(w, (uint8_t)sc->ns);
        for (int i = 0; i < sc->ns; i++) {
            int t = comps[sc->comp[i]].tbl;
            put_byte(w, (uint8_t)(sc->comp[i] + 1));
            put_byte(w, (uint8_t)(dc ? t << 4 : t));
        }
        put_byte(w, (uint8_t)sc->ss);
        put_byte(w, (uint8_t)sc->se);
        put_byte(w, (uint8_t)((sc->ah << 4) | sc->al));
        e->gather = 0;
        scan_pass(e, sc, comps, mcux, mcuy, restart_interval);
        flush_bits(w);
        if (w->oom) break;
    }
    free(e);
    return w->oom ? -1 : 0;
}

/* Encode an (height, width, channels) uint8 image, channels 1 or 3, luma
 * sampled hs x vs (1x1, 2x1, 2x2 or 1x2) against chroma 1x1, at libjpeg
 * quality 1..100, with a restart marker every restart_interval MCUs (0:
 * none), as a baseline file or (progressive != 0) a progressive one with
 * libjpeg's simple progression and optimized Huffman tables; both carry the
 * same quantized coefficients. Returns a malloc'd buffer (free with
 * jpeg_free) and its size, or NULL. */
uint8_t *jpeg_encode(const uint8_t *img, int width, int height, int channels, int quality, int hs, int vs,
                     int restart_interval, int progressive, long *out_size) {
    *out_size = 0;
    if (width < 1 || height < 1 || width > 65535 || height > 65535 || (channels != 1 && channels != 3)) return NULL;
    if (channels == 1) hs = vs = 1;
    if (hs < 1 || hs > 2 || vs < 1 || vs > 2 || restart_interval < 0 || restart_interval > 65535) return NULL;
    if (quality < 1) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    uint16_t qt[2][64];
    for (int i = 0; i < 64; i++) {
        long a = ((long)STD_LUMA_Q[i] * scale + 50) / 100, b = ((long)STD_CHROMA_Q[i] * scale + 50) / 100;
        qt[0][i] = (uint16_t)(a < 1 ? 1 : a > 255 ? 255 : a);
        qt[1][i] = (uint16_t)(b < 1 ? 1 : b > 255 ? 255 : b);
    }

    /* Colour conversion (jccolor.c) into planes padded to whole MCUs by
     * replicating the last column and row, then chroma downsampling with
     * libjpeg's alternating biases (jcsample.c). */
    int mcux = (width + 8 * hs - 1) / (8 * hs), mcuy = (height + 8 * vs - 1) / (8 * vs);
    long pw = (long)mcux * 8 * hs, ph = (long)mcuy * 8 * vs;
    long cw = pw / hs, ch = ph / vs;
    uint8_t *planes[3] = {NULL, NULL, NULL};
    uint8_t *full_c[2] = {NULL, NULL};
    int16_t *coef[3] = {NULL, NULL, NULL};
    Writer w = {0};
    uint8_t *result = NULL;
    planes[0] = (uint8_t *)malloc((size_t)(pw * ph));
    if (!planes[0]) goto done;
    if (channels == 3) {
        full_c[0] = (uint8_t *)malloc((size_t)(pw * ph));
        full_c[1] = (uint8_t *)malloc((size_t)(pw * ph));
        planes[1] = (uint8_t *)malloc((size_t)(cw * ch));
        planes[2] = (uint8_t *)malloc((size_t)(cw * ch));
        if (!full_c[0] || !full_c[1] || !planes[1] || !planes[2]) goto done;
    }
    {
        const int32_t CBCR_OFFSET = (int32_t)128 << SCALEBITS;
        for (long y = 0; y < ph; y++) {
            const uint8_t *row = img + (long)(y < height ? y : height - 1) * width * channels;
            for (long x = 0; x < pw; x++) {
                const uint8_t *px = row + (long)(x < width ? x : width - 1) * channels;
                long o = y * pw + x;
                if (channels == 1) {
                    planes[0][o] = px[0];
                    continue;
                }
                int32_t r = px[0], g = px[1], b = px[2];
                planes[0][o] = (uint8_t)((FIX16(0.29900) * r + FIX16(0.58700) * g + FIX16(0.11400) * b + ONE_HALF)
                                         >> SCALEBITS);
                full_c[0][o] = (uint8_t)((-FIX16(0.16874) * r - FIX16(0.33126) * g + FIX16(0.50000) * b + CBCR_OFFSET
                                          + ONE_HALF - 1) >> SCALEBITS);
                full_c[1][o] = (uint8_t)((FIX16(0.50000) * r - FIX16(0.41869) * g - FIX16(0.08131) * b + CBCR_OFFSET
                                          + ONE_HALF - 1) >> SCALEBITS);
            }
        }
        if (channels == 3) {
            for (int k = 0; k < 2; k++) {
                for (long y = 0; y < ch; y++) {
                    const uint8_t *r0 = full_c[k] + y * vs * pw, *r1 = r0 + (vs == 2 ? pw : 0);
                    uint8_t *o = planes[1 + k] + y * cw;
                    for (long x = 0; x < cw; x++) {
                        if (hs == 1 && vs == 1) {
                            o[x] = r0[x];
                        } else if (hs == 2 && vs == 1) {
                            o[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + (x & 1)) >> 1);
                        } else if (hs == 1 && vs == 2) {
                            o[x] = (uint8_t)((r0[x] + r1[x] + 1) >> 1);
                        } else {
                            o[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + (x & 1 ? 2 : 1))
                                             >> 2);
                        }
                    }
                }
            }
        }
    }

    /* Every block's quantized coefficients. */
    EncComp comps[3];
    for (int c = 0; c < channels; c++) {
        long plw = c ? cw : pw, plh = c ? ch : ph;
        long dw = c ? (width + hs - 1) / hs : width, dh = c ? (height + vs - 1) / vs : height;
        coef[c] = (int16_t *)malloc((size_t)(plw / 8) * (plh / 8) * 64 * sizeof(int16_t));
        if (!coef[c]) goto done;
        for (long by = 0; by < plh / 8; by++)
            for (long bx = 0; bx < plw / 8; bx++)
                quantize_block(planes[c] + by * 8 * plw + bx * 8, plw, qt[c ? 1 : 0], coef[c] + 64 * (by * (plw / 8) + bx));
        comps[c] = (EncComp){coef[c], plw / 8, (dw + 7) / 8, (dh + 7) / 8, c ? 1 : hs, c ? 1 : vs, c ? 1 : 0};
    }

    w.cap = pw * ph / 4 + 4096;
    w.buf = (uint8_t *)malloc((size_t)w.cap);
    if (!w.buf) goto done;
    put_u16(&w, 0xFFD8);
    static const uint8_t JFIF[16] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1};
    for (int i = 0; i < 16; i++) put_byte(&w, JFIF[i]);
    put_byte(&w, 0);
    put_byte(&w, 0);
    int ntab = channels == 3 ? 2 : 1;
    put_u16(&w, 0xFFDB);
    put_u16(&w, 2 + 65 * ntab);
    for (int t = 0; t < ntab; t++) {
        put_byte(&w, (uint8_t)t);
        for (int k = 0; k < 64; k++) put_byte(&w, (uint8_t)qt[t][ZIGZAG[k]]);
    }
    put_u16(&w, progressive ? 0xFFC2 : 0xFFC0);
    put_u16(&w, 8 + 3 * channels);
    put_byte(&w, 8);
    put_u16(&w, height);
    put_u16(&w, width);
    put_byte(&w, (uint8_t)channels);
    for (int c = 0; c < channels; c++) {
        put_byte(&w, (uint8_t)(c + 1));
        put_byte(&w, c == 0 ? (uint8_t)((hs << 4) | vs) : 0x11);
        put_byte(&w, c == 0 ? 0 : 1);
    }
    if (!progressive) {
        write_dht(&w, 0, 0, DC_LUMA_BITS, DC_VALS);
        write_dht(&w, 1, 0, AC_LUMA_BITS, AC_LUMA_VALS);
        if (channels == 3) {
            write_dht(&w, 0, 1, DC_CHROMA_BITS, DC_VALS);
            write_dht(&w, 1, 1, AC_CHROMA_BITS, AC_CHROMA_VALS);
        }
    }
    if (restart_interval) {
        put_u16(&w, 0xFFDD);
        put_u16(&w, 4);
        put_u16(&w, restart_interval);
    }
    if (progressive) {
        if (encode_progressive(&w, comps, channels, mcux, mcuy, restart_interval)) goto done;
    } else {
        EncTable dc_t[2], ac_t[2];
        build_enc_table(&dc_t[0], DC_LUMA_BITS, DC_VALS);
        build_enc_table(&dc_t[1], DC_CHROMA_BITS, DC_VALS);
        build_enc_table(&ac_t[0], AC_LUMA_BITS, AC_LUMA_VALS);
        build_enc_table(&ac_t[1], AC_CHROMA_BITS, AC_CHROMA_VALS);
        put_u16(&w, 0xFFDA);
        put_u16(&w, 6 + 2 * channels);
        put_byte(&w, (uint8_t)channels);
        for (int c = 0; c < channels; c++) {
            put_byte(&w, (uint8_t)(c + 1));
            put_byte(&w, c == 0 ? 0x00 : 0x11);
        }
        put_byte(&w, 0);
        put_byte(&w, 63);
        put_byte(&w, 0);
        int pred[3] = {0, 0, 0};
        long count = 0;
        int rst = 0;
        for (long my = 0; my < mcuy; my++) {
            for (long mx = 0; mx < mcux; mx++) {
                if (restart_interval && count > 0 && count % restart_interval == 0) {
                    flush_bits(&w);
                    put_u16(&w, 0xFFD0 + rst);
                    rst = (rst + 1) & 7;
                    pred[0] = pred[1] = pred[2] = 0;
                }
                for (int v = 0; v < vs; v++)
                    for (int h = 0; h < hs; h++)
                        encode_block(&w, coef[0] + 64 * ((my * vs + v) * comps[0].bw + mx * hs + h), &pred[0],
                                     &dc_t[0], &ac_t[0]);
                for (int c = 1; c < channels; c++)
                    encode_block(&w, coef[c] + 64 * (my * comps[c].bw + mx), &pred[c], &dc_t[1], &ac_t[1]);
                count++;
            }
            if (w.oom) goto done;
        }
        flush_bits(&w);
    }
    put_u16(&w, 0xFFD9);
    if (w.oom) goto done;
    result = w.buf;
    w.buf = NULL;
    *out_size = w.len;
done:
    free(w.buf);
    for (int i = 0; i < 3; i++) {
        free(planes[i]);
        free(coef[i]);
    }
    free(full_c[0]);
    free(full_c[1]);
    return result;
}

void jpeg_free(void *p) { free(p); }

/* ======================================================================= */
/* GIF LZW                                                                 */
/* ======================================================================= */

#define LZW_HASH_BITS 14 /* open addressing, at most 4096 - 258 of 16384 slots used */

typedef struct {
    uint8_t *out;
    long len, cap;
    uint32_t acc;
    int nbits;
    uint8_t block[256];
    int blen;
} LzwWriter;

static void lzw_flush_block(LzwWriter *w) {
    if (w->blen == 0) return;
    if (w->len + 1 + w->blen <= w->cap) {
        w->out[w->len] = (uint8_t)w->blen;
        memcpy(w->out + w->len + 1, w->block, (size_t)w->blen);
    }
    w->len += 1 + w->blen;
    w->blen = 0;
}

static inline void lzw_put(LzwWriter *w, int code, int width) {
    w->acc |= (uint32_t)code << w->nbits; /* GIF packs codes from the low bits */
    w->nbits += width;
    while (w->nbits >= 8) {
        w->block[w->blen++] = (uint8_t)w->acc;
        if (w->blen == 255) lzw_flush_block(w);
        w->acc >>= 8;
        w->nbits -= 8;
    }
}

/* LZW-code n 8-bit palette indices as GIF image data: the minimum code
 * size byte (8), the codes in sub-blocks of at most 255 bytes, and the
 * zero-length terminator. Returns the bytes written, or -(bytes needed)
 * when cap is too small. */
long gif_lzw(const uint8_t *idx, long n, uint8_t *out, long cap) {
    const int min_size = 8, clear = 1 << min_size, eoi = clear + 1;
    const uint32_t slots = 1u << LZW_HASH_BITS, mask = slots - 1;
    int32_t *keys = (int32_t *)malloc(slots * sizeof(int32_t));
    int16_t *codes = (int16_t *)malloc(slots * sizeof(int16_t));
    if (!keys || !codes) {
        free(keys);
        free(codes);
        return 0;
    }
    LzwWriter w = {out, 0, cap, 0, 0, {0}, 0};
    if (cap > 0) out[0] = (uint8_t)min_size;
    w.len = 1;
    int width = min_size + 1, next = eoi + 1;
    memset(keys, 0xFF, slots * sizeof(int32_t)); /* -1: empty */
    lzw_put(&w, clear, width);
    if (n > 0) {
        int prefix = idx[0];
        for (long i = 1; i < n; i++) {
            int c = idx[i];
            int32_t key = (prefix << 8) | c;
            uint32_t h = ((uint32_t)key * 2654435761u) >> (32 - LZW_HASH_BITS);
            while (keys[h] != -1 && keys[h] != key) h = (h + 1) & mask;
            if (keys[h] == key) {
                prefix = codes[h];
                continue;
            }
            lzw_put(&w, prefix, width);
            if (next < 4096) {
                keys[h] = key;
                codes[h] = (int16_t)next++;
                if (next > (1 << width) && width < 12) width++;
            } else {
                lzw_put(&w, clear, width);
                memset(keys, 0xFF, slots * sizeof(int32_t));
                next = eoi + 1;
                width = min_size + 1;
            }
            prefix = c;
        }
        lzw_put(&w, prefix, width);
        if (next >= (1 << width) && width < 12) width++;
    }
    lzw_put(&w, eoi, width);
    if (w.nbits > 0) lzw_put(&w, 0, 8 - w.nbits);
    lzw_flush_block(&w);
    if (w.len + 1 <= cap) out[w.len] = 0;
    w.len += 1;
    free(keys);
    free(codes);
    return w.len <= cap ? w.len : -w.len;
}
