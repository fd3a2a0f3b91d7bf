/* CRC32C (Castagnoli) for TFRecord I/O, with a plain C interface bound
 * through ctypes (mtlx_torch/data/tfrecord.py). The port's copy of
 * mtlx/data/_crc32c.c: the same slicing-by-8 tables, without the CPython
 * module around them. Built at first use by mtlx_torch/kernels/build.py.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h> /* memcpy */

static uint32_t table[8][256];

__attribute__((constructor)) static void init_tables(void) {
    const uint32_t poly = 0x82F63B78u;
    for (int n = 0; n < 256; n++) {
        uint32_t c = (uint32_t)n;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
        table[0][n] = c;
    }
    for (int n = 0; n < 256; n++) {
        uint32_t c = table[0][n];
        for (int k = 1; k < 8; k++) {
            c = table[0][c & 0xFF] ^ (c >> 8);
            table[k][n] = c;
        }
    }
}

/* crc32c of buf[0:len] continuing from `value` (0 to start) */
uint32_t mtlx_crc32c(const unsigned char *buf, size_t len, uint32_t value) {
    uint32_t crc = value ^ 0xFFFFFFFFu;
    while (len >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, buf, 4);
        memcpy(&hi, buf + 4, 4);
        lo ^= crc;
        crc = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^
              table[5][(lo >> 16) & 0xFF] ^ table[4][lo >> 24] ^
              table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
              table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
    while (len-- > 0)
        crc = table[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}
