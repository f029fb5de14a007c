/* COLMAP binary model parsing in one pass over the file's bytes.
 *
 * The port's copy of dogs_tpu/native/colmap_fast.c, built with
 * gcc -O3 -shared -fPIC at first use (dogs_tpu_torch/data/native.py) and
 * loaded with ctypes. Large scenes carry points3D.bin files of millions of
 * points with variable-length observation tracks, which a loop in Python
 * walks slowly; this scanner fills caller-provided arrays instead.
 *
 * Layout per point (COLMAP spec):
 *   u64 id | 3 x f64 xyz | 3 x u8 rgb | f64 error |
 *   u64 track_len | track_len x (i32 image_id, i32 point2D_idx)
 * Layout per image:
 *   i32 id | 4 x f64 qvec | 3 x f64 tvec | i32 camera_id | name '\0' |
 *   u64 n_pts | n_pts x (f64 x, f64 y, i64 point3D_id)
 *
 * Both parsers return the record count, or -1 when the file ends inside a
 * record or a length field points past its end. Track and observation
 * lengths are checked against the bytes left before they are used, so a
 * corrupt length cannot overflow the offset.
 */

#include <stdint.h>
#include <string.h>

long parse_points3d(
    const unsigned char *buf,
    long len,
    long capacity,
    double *xyz,        /* capacity x 3 */
    unsigned char *rgb, /* capacity x 3 */
    double *error       /* capacity */
) {
    if (len < 8) return -1;
    uint64_t n;
    memcpy(&n, buf, 8);
    long off = 8;
    long count = 0;
    for (uint64_t i = 0; i < n; i++) {
        /* id(8) + xyz(24) + rgb(3) + error(8) + track_len(8) = 51 bytes */
        if (len - off < 51) return -1;
        if (count < capacity) {
            memcpy(&xyz[count * 3], buf + off + 8, 24);
            memcpy(&rgb[count * 3], buf + off + 32, 3);
            memcpy(&error[count], buf + off + 35, 8);
        }
        uint64_t track_len;
        memcpy(&track_len, buf + off + 43, 8);
        off += 51;
        if (track_len > (uint64_t)(len - off) / 8) return -1;
        off += (long)track_len * 8;
        count++;
    }
    return count;
}

/* images.bin: fills qvec (n x 4), tvec (n x 3), camera_id (n), image_id
 * (n), and writes the names into name_buf (name_cap bytes), each ended by
 * '\0'. */
long parse_images(
    const unsigned char *buf,
    long len,
    long capacity,
    double *qvec,
    double *tvec,
    int32_t *camera_id,
    int32_t *image_id,
    char *name_buf,
    long name_cap
) {
    if (len < 8) return -1;
    uint64_t n;
    memcpy(&n, buf, 8);
    long off = 8;
    long name_off = 0;
    long count = 0;
    for (uint64_t i = 0; i < n; i++) {
        if (len - off < 64) return -1;
        if (count < capacity) {
            memcpy(&image_id[count], buf + off, 4);
            memcpy(&qvec[count * 4], buf + off + 4, 32);
            memcpy(&tvec[count * 3], buf + off + 36, 24);
            memcpy(&camera_id[count], buf + off + 60, 4);
        }
        off += 64;
        long start = off;
        while (off < len && buf[off] != 0) off++;
        if (off >= len) return -1;
        long nlen = off - start;
        if (count < capacity) {
            if (name_off + nlen + 1 > name_cap) return -1;
            memcpy(name_buf + name_off, buf + start, nlen);
            name_buf[name_off + nlen] = 0;
            name_off += nlen + 1;
        }
        off++; /* the '\0' */
        if (len - off < 8) return -1;
        uint64_t n_pts;
        memcpy(&n_pts, buf + off, 8);
        off += 8;
        if (n_pts > (uint64_t)(len - off) / 24) return -1;
        off += (long)n_pts * 24;
        count++;
    }
    return count;
}
