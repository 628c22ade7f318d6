/* PNG row unfiltering for the port's host runtime, with a plain C interface
 * that `native/build.py` loads with ctypes (libc only, no Python.h).
 *
 * The caller parses the chunks and inflates the image data with Python's
 * zlib (`utils/improc.py::decode_png_bytes`); what is left is undoing the
 * five row filters of the PNG specification (None, Sub, Up, Average,
 * Paeth). Sub, Average and Paeth depend on the pixels to their left in the
 * same row, so they run here and not in numpy.
 *
 *   metro_png_unfilter(raw, raw_len, h, w, bpp, out)
 *       raw: h rows of 1 filter byte + w * bpp bytes (8-bit samples, no
 *       interlace); out: h * w * bpp bytes.
 *       -> 0, 1 for a filter byte above 4 (out is then partly written),
 *          2 if raw_len is not h * (1 + w * bpp).
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

int metro_png_unfilter(const uint8_t *raw, size_t raw_len, int h, int w, int bpp,
                       uint8_t *out) {
  const size_t stride = (size_t)w * (size_t)bpp;
  if (h < 0 || w < 0 || bpp < 1 || raw_len != (size_t)h * (stride + 1)) return 2;
  for (int y = 0; y < h; y++) {
    const uint8_t *src = raw + (size_t)y * (stride + 1);
    const uint8_t filter = src[0];
    src++;
    uint8_t *row = out + (size_t)y * stride;
    const uint8_t *up = y ? row - stride : NULL; /* the row above, unfiltered */
    size_t i = 0;
    switch (filter) {
      case 0: /* None */
        for (; i < stride; i++) row[i] = src[i];
        break;
      case 1: /* Sub */
        for (; i < (size_t)bpp && i < stride; i++) row[i] = src[i];
        for (; i < stride; i++) row[i] = (uint8_t)(src[i] + row[i - bpp]);
        break;
      case 2: /* Up */
        for (; i < stride; i++) row[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3: /* Average */
        for (; i < stride; i++) {
          int left = i >= (size_t)bpp ? row[i - bpp] : 0;
          int above = up ? up[i] : 0;
          row[i] = (uint8_t)(src[i] + ((left + above) >> 1));
        }
        break;
      case 4: /* Paeth */
        for (; i < stride; i++) {
          int left = i >= (size_t)bpp ? row[i - bpp] : 0;
          int above = up ? up[i] : 0;
          int corner = (up && i >= (size_t)bpp) ? up[i - bpp] : 0;
          row[i] = (uint8_t)(src[i] + paeth(left, above, corner));
        }
        break;
      default:
        return 1;
    }
  }
  return 0;
}
