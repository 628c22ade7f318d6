/* Image resize for the port's host runtime: OpenCV's INTER_AREA and
 * INTER_LINEAR (`cv::resize`, `imgproc/src/resize.cpp`) without cv2, with a
 * plain C interface that `native/build.py` loads with ctypes (libm only).
 *
 * The VOC occluder bank and the background bank of the reference are cut to
 * size with cv2.resize, so the port follows cv2's branches and arithmetic
 * one for one, in cv2's order of operations:
 *
 *   - the scales are 1 / (dst / src) in double, as cv2 computes them; a
 *     scale within DBL_EPSILON of an integer on both axes is "integer";
 *   - INTER_LINEAR at an integer scale of 2 on both axes is INTER_AREA;
 *   - INTER_AREA with both axes shrinking sums areas: at integer scales
 *     over whole blocks (at 2x2, as cv2's vector paths do, for uint8
 *     (a + b + c + d + 2) >> 2 and for float32 of 1 or 4 channels
 *     ((a + b) + (c + d)) * 0.25 outside a row's last width % 4 values;
 *     otherwise the block summed in order, then for uint8 round-half-even
 *     of sum * (1/area) in float), else through cv2's table of source cells
 *     and float weights, each row's weighted sum added in the table's order;
 *   - INTER_AREA where an axis grows takes the linear branch, for both
 *     axes, with cv2's area-mode coefficients;
 *   - the linear branch on uint8 weighs in 11-bit fixed point and rounds
 *     the vertical sum as cv2's VResizeLinear does; in area mode, and on
 *     float32 sources one pixel high or wide, it weighs in float,
 *     a * (1 - f) + b * f; on other float32 sources (cv2 5.0's float path)
 *     the fractions come from src / dst in double and each pass is
 *     fmaf(b - a, f, a). Columns past the last pair of source pixels
 *     repeat the last one; rows are clamped to the image, their weights
 *     left as they are.
 *
 * uint8 results equal cv2 5.0's on every branch, float32 area results too.
 * Float32 linear results differ from cv2's by one float32 ulp at some
 * pixels of the clamped edge columns of 3- and 4-channel images, which
 * cv2's vector code rounds once more or less. The library is built with
 * -ffp-contract=off: a product and a sum fused into an FMA would round
 * where cv2's float code does not (the one fused step is the explicit
 * fmaf).
 *
 *   metro_resize(src, sh, sw, cn, is_f32, dst, dh, dw, interp)
 *       src: sh x sw x cn (cn 1, 3 or 4) uint8 or float32 (is_f32), dense;
 *       dst: dh x dw x cn of the same type; interp 0 area, 1 linear
 *       -> 0, 1 for a bad argument, 2 if memory ran out.
 */
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum { INTERP_AREA = 0, INTERP_LINEAR = 1 };
#define COEF_BITS 11
#define COEF_SCALE (1 << COEF_BITS)

/* cv2's cvRound (round half to even), cvFloor and cvCeil */
static int round_d(double v) { return (int)lrint(v); }
static int round_f(float v) { return (int)lrintf(v); }
static int floor_d(double v) {
  int i = (int)v;
  return i - (i > v);
}
static int floor_f(float v) {
  int i = (int)v;
  return i - (i > v);
}
static int ceil_d(double v) {
  int i = (int)v;
  return i + (i < v);
}
static uint8_t sat_u8(float v) { /* saturate_cast<uchar>(float) */
  int i = round_f(v);
  return (uint8_t)(i < 0 ? 0 : i > 255 ? 255 : i);
}
static short sat_s16(float v) {
  int i = round_f(v);
  return (short)(i < -32768 ? -32768 : i > 32767 ? 32767 : i);
}

/* ------------------------------------------------ area, integer scales */

static int area_fast(const void *src, int sw, int cn, int is_f32, void *dst, int dh,
                     int dw, int kx, int ky) {
  const int area = kx * ky, width = dw * cn;
  const float scale = 1.f / (float)area;
  const size_t step = (size_t)sw * cn;
  int *ofs = malloc(sizeof(int) * (size_t)area);
  if (!ofs) return 2;
  for (int sy = 0, k = 0; sy < ky; sy++)
    for (int sx = 0; sx < kx; sx++) ofs[k++] = (int)(sy * step + (size_t)sx * cn);
  for (int dy = 0; dy < dh; dy++) {
    const size_t row = (size_t)dy * ky * step;
    for (int j = 0; j < width; j++) {
      const size_t x = (size_t)kx * (j - j % cn) + j % cn; /* cv2's xofs */
      if (is_f32 && kx == 2 && ky == 2 && (cn == 1 || cn == 4) && j < width - width % 4) {
        /* cv2's 4-lane vector path: the pairs summed first */
        const float *s = (const float *)src + row + x;
        ((float *)dst)[(size_t)dy * width + j] = ((s[0] + s[cn]) + (s[step] + s[step + cn])) * 0.25f;
      } else if (is_f32) {
        const float *s = (const float *)src + row + x;
        float sum = 0;
        int k = 0;
        for (; k <= area - 4; k += 4) sum += s[ofs[k]] + s[ofs[k + 1]] + s[ofs[k + 2]] + s[ofs[k + 3]];
        for (; k < area; k++) sum += s[ofs[k]];
        ((float *)dst)[(size_t)dy * width + j] = sum * scale;
      } else {
        const uint8_t *s = (const uint8_t *)src + row + x;
        uint8_t *d = (uint8_t *)dst + (size_t)dy * width + j;
        if (kx == 2 && ky == 2) {
          *d = (uint8_t)((s[0] + s[cn] + s[step] + s[step + cn] + 2) >> 2);
        } else {
          int sum = 0;
          for (int k = 0; k < area; k++) sum += s[ofs[k]];
          *d = sat_u8((float)sum * scale);
        }
      }
    }
  }
  free(ofs);
  return 0;
}

/* ------------------------------------------------ area, any shrink */

typedef struct {
  int si, di;
  float alpha;
} decim_t;

/* cv2's computeResizeAreaTab: the source cells of each output cell and
 * their weights, in order of output cell */
static int area_tab(int ssize, int dsize, int cn, double scale, decim_t *tab) {
  int k = 0;
  for (int dx = 0; dx < dsize; dx++) {
    double fsx1 = dx * scale;
    double fsx2 = fsx1 + scale;
    double cell = scale < ssize - fsx1 ? scale : ssize - fsx1;
    int sx1 = ceil_d(fsx1), sx2 = floor_d(fsx2);
    sx2 = sx2 < ssize - 1 ? sx2 : ssize - 1;
    sx1 = sx1 < sx2 ? sx1 : sx2;
    if (sx1 - fsx1 > 1e-3) {
      tab[k].di = dx * cn;
      tab[k].si = (sx1 - 1) * cn;
      tab[k++].alpha = (float)((sx1 - fsx1) / cell);
    }
    for (int sx = sx1; sx < sx2; sx++) {
      tab[k].di = dx * cn;
      tab[k].si = sx * cn;
      tab[k++].alpha = (float)(1.0 / cell);
    }
    if (fsx2 - sx2 > 1e-3) {
      double part = fsx2 - sx2 < 1. ? fsx2 - sx2 : 1.;
      tab[k].di = dx * cn;
      tab[k].si = sx2 * cn;
      tab[k++].alpha = (float)((part < cell ? part : cell) / cell);
    }
  }
  return k;
}

static int area_general(const void *src, int sh, int sw, int cn, int is_f32, void *dst,
                        int dh, int dw, double scale_x, double scale_y) {
  const int width = dw * cn;
  decim_t *xtab = malloc(sizeof(decim_t) * ((size_t)sw + sh) * 2);
  float *buf = malloc(sizeof(float) * (size_t)width * 2);
  if (!xtab || !buf) {
    free(xtab);
    free(buf);
    return 2;
  }
  decim_t *ytab = xtab + (size_t)sw * 2;
  float *sum = buf + width;
  const int nx = area_tab(sw, dw, cn, scale_x, xtab);
  const int ny = area_tab(sh, dh, 1, scale_y, ytab);
  int prev_dy = ytab[0].di;
  for (int j = 0; j < width; j++) sum[j] = 0;
  for (int t = 0; t < ny; t++) {
    const float beta = ytab[t].alpha;
    const int dy = ytab[t].di;
    const size_t row = (size_t)ytab[t].si * sw * cn;
    for (int j = 0; j < width; j++) buf[j] = 0;
    for (int k = 0; k < nx; k++) {
      const int si = xtab[k].si, di = xtab[k].di;
      const float alpha = xtab[k].alpha;
      for (int c = 0; c < cn; c++) {
        const float s = is_f32 ? ((const float *)src)[row + si + c]
                               : (float)((const uint8_t *)src)[row + si + c];
        buf[di + c] += s * alpha;
      }
    }
    if (dy != prev_dy) {
      for (int j = 0; j < width; j++) {
        if (is_f32)
          ((float *)dst)[(size_t)prev_dy * width + j] = sum[j];
        else
          ((uint8_t *)dst)[(size_t)prev_dy * width + j] = sat_u8(sum[j]);
        sum[j] = beta * buf[j];
      }
      prev_dy = dy;
    } else {
      for (int j = 0; j < width; j++) sum[j] += beta * buf[j];
    }
  }
  for (int j = 0; j < width; j++) {
    if (is_f32)
      ((float *)dst)[(size_t)prev_dy * width + j] = sum[j];
    else
      ((uint8_t *)dst)[(size_t)prev_dy * width + j] = sat_u8(sum[j]);
  }
  free(xtab);
  free(buf);
  return 0;
}

/* ------------------------------------------------ linear (and area growing) */

/* one output coordinate's source index and fraction, as cv2 computes them:
 * in area mode from the scale and its inverse; otherwise in float from
 * 1 / (dst / src), or on cv2's float path (`lerp`) in double from src / dst */
static void linear_coord(int d, int n_src, int n_dst, double scale, double inv_scale,
                         int area_mode, int lerp, int *s, float *f) {
  if (area_mode) {
    *s = floor_d(d * scale);
    float fx = (float)((d + 1) - (*s + 1) * inv_scale);
    *f = fx <= 0 ? 0.f : fx - floor_f(fx);
  } else if (lerp) {
    double fx = (d + 0.5) * ((double)n_src / n_dst) - 0.5;
    *s = floor_d(fx);
    *f = (float)(fx - *s);
  } else {
    float fx = (float)((d + 0.5) * scale - 0.5);
    *s = floor_f(fx);
    *f = fx - *s;
  }
}

/* one source row through the horizontal pass into `out` (dw * cn sums) */
static void hresize(const void *src, int sy, int sw, int cn, int is_f32, int lerp,
                    const int *xofs, const float *alpha, const short *ialpha, int dw, int xmax,
                    void *out) {
  const size_t row = (size_t)sy * sw * cn;
  for (int dx = 0; dx < dw; dx++) {
    const int sx = xofs[dx];
    for (int c = 0; c < cn; c++) {
      const size_t i = row + (size_t)sx * cn + c;
      const int j = dx * cn + c;
      if (is_f32) {
        const float *s = (const float *)src;
        if (dx >= xmax)
          ((float *)out)[j] = s[i] * 1.f;
        else if (lerp)
          ((float *)out)[j] = fmaf(s[i + cn] - s[i], alpha[2 * dx + 1], s[i]);
        else
          ((float *)out)[j] = s[i] * alpha[2 * dx] + s[i + cn] * alpha[2 * dx + 1];
      } else {
        const uint8_t *s = (const uint8_t *)src;
        ((int *)out)[j] = dx < xmax ? s[i] * ialpha[2 * dx] + s[i + cn] * ialpha[2 * dx + 1]
                                    : s[i] * COEF_SCALE;
      }
    }
  }
}

static int clip_row(int y, int h) { return y < 0 ? 0 : y >= h ? h - 1 : y; }

static int linear(const void *src, int sh, int sw, int cn, int is_f32, void *dst, int dh,
                  int dw, double scale_x, double scale_y, double inv_x, double inv_y,
                  int area_mode) {
  const int width = dw * cn, lerp = is_f32 && !area_mode && sh > 1 && sw > 1;
  int *xofs = malloc(sizeof(int) * (size_t)dw);
  float *alpha = malloc(sizeof(float) * (size_t)dw * 2);
  short *ialpha = malloc(sizeof(short) * (size_t)dw * 2);
  void *rows = malloc((size_t)width * 2 * 4); /* two rows of int or float sums */
  if (!xofs || !alpha || !ialpha || !rows) {
    free(xofs);
    free(alpha);
    free(ialpha);
    free(rows);
    return 2;
  }
  int xmax = dw;
  for (int dx = 0; dx < dw; dx++) {
    int sx;
    float fx;
    linear_coord(dx, sw, dw, scale_x, inv_x, area_mode, lerp, &sx, &fx);
    if (sx < 0) fx = 0, sx = 0;
    if (sx + 1 >= sw) {
      xmax = xmax < dx ? xmax : dx;
      fx = 0, sx = sw - 1;
    }
    xofs[dx] = sx;
    alpha[2 * dx] = 1.f - fx;
    alpha[2 * dx + 1] = fx;
    ialpha[2 * dx] = sat_s16((1.f - fx) * COEF_SCALE);
    ialpha[2 * dx + 1] = sat_s16(fx * COEF_SCALE);
  }
  void *r[2] = {rows, (char *)rows + (size_t)width * 4};
  int have[2] = {-1, -1};
  for (int dy = 0; dy < dh; dy++) {
    int sy;
    float fy;
    linear_coord(dy, sh, dh, scale_y, inv_y, area_mode, lerp, &sy, &fy);
    const int want[2] = {clip_row(sy, sh), clip_row(sy + 1, sh)};
    for (int k = 0; k < 2; k++) {
      if (have[k] == want[k]) continue;
      if (k == 0 && have[1] == want[0]) { /* the row moves up: swap buffers */
        void *t = r[0];
        r[0] = r[1], r[1] = t;
        have[0] = have[1], have[1] = -1;
        continue;
      }
      hresize(src, want[k], sw, cn, is_f32, lerp, xofs, alpha, ialpha, dw, xmax, r[k]);
      have[k] = want[k];
    }
    if (is_f32) {
      const float b0 = 1.f - fy, b1 = fy;
      const float *s0 = r[0], *s1 = r[1];
      float *d = (float *)dst + (size_t)dy * width;
      for (int j = 0; j < width; j++)
        d[j] = lerp ? fmaf(s1[j] - s0[j], fy, s0[j]) : s0[j] * b0 + s1[j] * b1;
    } else {
      const int b0 = sat_s16((1.f - fy) * COEF_SCALE), b1 = sat_s16(fy * COEF_SCALE);
      const int *s0 = r[0], *s1 = r[1];
      uint8_t *d = (uint8_t *)dst + (size_t)dy * width;
      for (int j = 0; j < width; j++)
        d[j] = (uint8_t)((((b0 * (s0[j] >> 4)) >> 16) + ((b1 * (s1[j] >> 4)) >> 16) + 2) >> 2);
    }
  }
  free(xofs);
  free(alpha);
  free(ialpha);
  free(rows);
  return 0;
}

int metro_resize(const void *src, int sh, int sw, int cn, int is_f32, void *dst, int dh,
                 int dw, int interp) {
  if (sh < 1 || sw < 1 || dh < 1 || dw < 1 || !(cn == 1 || cn == 3 || cn == 4) ||
      (interp != INTERP_AREA && interp != INTERP_LINEAR))
    return 1;
  if (sh == dh && sw == dw) {
    memcpy(dst, src, (size_t)sh * sw * cn * (is_f32 ? 4 : 1));
    return 0;
  }
  const double inv_x = (double)dw / sw, inv_y = (double)dh / sh;
  const double scale_x = 1. / inv_x, scale_y = 1. / inv_y;
  const int kx = round_d(scale_x), ky = round_d(scale_y);
  const int integer = fabs(scale_x - kx) < DBL_EPSILON && fabs(scale_y - ky) < DBL_EPSILON;
  if (interp == INTERP_LINEAR && integer && kx == 2 && ky == 2) interp = INTERP_AREA;
  if (interp == INTERP_AREA && scale_x >= 1 && scale_y >= 1) {
    if (integer) return area_fast(src, sw, cn, is_f32, dst, dh, dw, kx, ky);
    return area_general(src, sh, sw, cn, is_f32, dst, dh, dw, scale_x, scale_y);
  }
  return linear(src, sh, sw, cn, is_f32, dst, dh, dw, scale_x, scale_y, inv_x, inv_y,
                interp == INTERP_AREA);
}
