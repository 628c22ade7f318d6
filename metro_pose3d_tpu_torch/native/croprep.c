/* Host crop engine of the port: the per-example virtual-camera algebra of
 * `pipeline/crops.py::prepare_example` (`metro_crop_params`) and the
 * source-tile copy with integer area decimation (`metro_extract_tile`), in
 * C with a plain interface that `native/build.py` loads with ctypes.
 *
 * The port's copy of the JAX package's `native/croprep.c` (`crop_params`)
 * and of `extract_tile` from its `native/jpegdec.c`, without Python.h:
 * buffers come in as pointers that the Python side has checked, and each
 * entry point returns 0 or an error code. ctypes releases the interpreter
 * lock for the call, so loader threads run these in parallel.
 *
 * Same operation ORDER as the numpy code of `pipeline/crops.py`, so the
 * engines agree to ~1e-12 relative in float64; the library is built with
 * -ffp-contract=off, so no product and sum fuse into an FMA that the numpy
 * code does not make. This library needs no libjpeg.
 */
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------ small algebra */

/* out = a @ b for row-major 3x3 */
static void mat3_mul(const double *a, const double *b, double *out) {
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++)
      out[i * 3 + j] = a[i * 3 + 0] * b[0 * 3 + j] + a[i * 3 + 1] * b[1 * 3 + j] +
                       a[i * 3 + 2] * b[2 * 3 + j];
}

/* out = a @ b^T for row-major 3x3 */
static void mat3_mul_bt(const double *a, const double *b, double *out) {
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++)
      out[i * 3 + j] = a[i * 3 + 0] * b[j * 3 + 0] + a[i * 3 + 1] * b[j * 3 + 1] +
                       a[i * 3 + 2] * b[j * 3 + 2];
}

/* general 3x3 inverse via adjugate (K is triangular but keep it general) */
static int mat3_inv(const double *m, double *out) {
  double c00 = m[4] * m[8] - m[5] * m[7];
  double c01 = m[5] * m[6] - m[3] * m[8];
  double c02 = m[3] * m[7] - m[4] * m[6];
  double det = m[0] * c00 + m[1] * c01 + m[2] * c02;
  if (det == 0.0 || !isfinite(det)) return -1;
  double inv = 1.0 / det;
  out[0] = c00 * inv;
  out[1] = (m[2] * m[7] - m[1] * m[8]) * inv;
  out[2] = (m[1] * m[5] - m[2] * m[4]) * inv;
  out[3] = c01 * inv;
  out[4] = (m[0] * m[8] - m[2] * m[6]) * inv;
  out[5] = (m[2] * m[3] - m[0] * m[5]) * inv;
  out[6] = c02 * inv;
  out[7] = (m[1] * m[6] - m[0] * m[7]) * inv;
  out[8] = (m[0] * m[4] - m[1] * m[3]) * inv;
  return 0;
}

/* ------------------------------------------------------------- camera model */

/* OpenCV-model distortion of one normalized point (geom/camera.py
 * distort_points). Exact identity when all coefficients are zero. */
static void distort_pt(double x, double y, const double *d, double *xd,
                       double *yd) {
  double k1 = d[0], k2 = d[1], p1 = d[2], p2 = d[3], k3 = d[4];
  double r2 = x * x + y * y;
  double radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3));
  *xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x);
  *yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y;
}

/* Fixed-point inverse, 10 iterations (geom/camera.py undistort_points);
 * short-circuits exactly like the numpy version when dist == 0. */
static void undistort_pt(double *x, double *y, const double *d) {
  if (d[0] == 0 && d[1] == 0 && d[2] == 0 && d[3] == 0 && d[4] == 0) return;
  double k1 = d[0], k2 = d[1], p1 = d[2], p2 = d[3], k3 = d[4];
  double xd = *x, yd = *y, xx = *x, yy = *y;
  for (int i = 0; i < 10; i++) {
    double r2 = xx * xx + yy * yy;
    double radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3));
    double dx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx);
    double dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy;
    xx = (xd - dx) / radial;
    yy = (yd - dy) / radial;
  }
  *x = xx;
  *y = yy;
}

/* camera_to_image: project one camera-frame point (geom/camera.py:77) */
static void cam_to_img(const double *K, const double *d, double px, double py,
                       double pz, double *ox, double *oy) {
  double xn = px / pz, yn = py / pz;
  double xd, yd;
  distort_pt(xn, yn, d, &xd, &yd);
  *ox = K[0] * xd + K[1] * yd + K[2];
  *oy = K[4] * yd + K[5];
}

/* image_to_camera at depth 1: normalized ray (geom/camera.py:93) */
static void img_to_ray(const double *K, const double *d, double px, double py,
                       double *ox, double *oy) {
  double y = (py - K[5]) / K[4];
  double x = (px - K[2] - K[1] * y) / K[0];
  undistort_pt(&x, &y, d);
  *ox = x;
  *oy = y;
}

/* reproject_image_points for one pixel (geom/camera.py:236): src pixel ->
 * world ray -> dst pixel; exact for shared optical center. */
static void reproject_pt(const double *Ks, const double *Rs, const double *ds,
                         const double *Kd, const double *Rd, const double *dd,
                         double px, double py, double *ox, double *oy) {
  double x, y;
  img_to_ray(Ks, ds, px, py, &x, &y);
  double w0 = x * Rs[0] + y * Rs[3] + Rs[6];
  double w1 = x * Rs[1] + y * Rs[4] + Rs[7];
  double w2 = x * Rs[2] + y * Rs[5] + Rs[8];
  double c0 = w0 * Rd[0] + w1 * Rd[1] + w2 * Rd[2];
  double c1 = w0 * Rd[3] + w1 * Rd[4] + w2 * Rd[5];
  double c2 = w0 * Rd[6] + w1 * Rd[7] + w2 * Rd[8];
  cam_to_img(Kd, dd, c0, c1, c2, ox, oy);
}

/* x rounded to float32 and back. Through a volatile: GCC 12's basic-block
 * vectorizer (-O2 and above, without AVX) folds the two (double)(float)
 * round trips of the rebase below into nothing. */
static double round_f32(double x) {
  volatile float f = (float)x;
  return f;
}

static double nan_to_num(double v) {
  if (isnan(v)) return 0.0;
  if (isinf(v)) return v > 0 ? DBL_MAX : -DBL_MAX;
  return v;
}

/* --------------------------------------------------------------- the engine */

/* Output layout (doubles), NBASE = 40 then GT blocks of J each:
 *   [0:9]   warp H   = M @ inv(K_crop)
 *   [9:13]  warp K rebased to tile coords (f32-rounded pre-rebase, matching
 *           rebase_warp_params operating on get_warp_params' f32 output)
 *   [13:18] source distortion
 *   [18:27] crop intrinsics K
 *   [27:36] rot_to_orig = R_src @ R_crop^T (= warp M)
 *   [36:40] warp K UNREBASED (frame mode / prepare_inference_crop_params)
 *   [40 : 40+3J]           coords3d (crop camera frame, mm)
 *   [40+3J : 40+5J]        coords2d (crop pixels)
 *   [40+5J : 40+6J]        joint_validity (3D)
 *   [40+6J : 40+7J]        joint_validity_2d
 * roi: x0, y0, x1, y1 of the source region and the decimation factor.
 *
 * cam: K (9), R (9), t (3), dist (5), world_up (3), row-major doubles.
 * mode 0: `coords` holds J world points [J,3]; mode 1: J image points
 * [J,2] (2D-only data); mode 2: no ground truth (inference).
 * Returns 0, METRO_EARGS for bad sizes, METRO_ESINGULAR for a singular
 * crop K, METRO_ENOMEM when the flip's scratch cannot be allocated. */
#define NBASE 40
#define METRO_EARGS 1
#define METRO_ESINGULAR 2
#define METRO_ENOMEM 3

int metro_crop_params(const double *cam, const double *bbox, int proc_side, int tile_side,
                      int img_w, int img_h, double box_expansion, double shift_x,
                      double shift_y, double scale, double rot_rad, int flip, int mode, int J,
                      const double *coords, const uint8_t *valid_in, const int32_t *mirror,
                      double *out, int *roi) {
  if (J < 0 || proc_side < 1 || tile_side < 1 || mode < 0 || mode > 2) return METRO_EARGS;
  const double *Ko = cam;      /* original K, row-major 3x3 */
  const double *Ro = cam + 9;  /* original R */
  const double *t = cam + 18;  /* optical center (world) */
  const double *dist = cam + 21; /* k1 k2 p1 p2 k3 */
  const double *up = cam + 26; /* world_up */
  memset(out, 0, (size_t)(NBASE + 7 * J) * sizeof(double));

  /* ---- step 1: box -> square (+ shift), boxes.expand_to_square ------- */
  double side = (bbox[2] > bbox[3] ? bbox[2] : bbox[3]) * box_expansion;
  double cx0 = bbox[0] + bbox[2] / 2.0, cy0 = bbox[1] + bbox[3] / 2.0;
  /* box_around twice, matching crops.make_crop_camera order */
  double bx0 = cx0 - side / 2.0, by0 = cy0 - side / 2.0;
  double bcx = (bx0 + side / 2.0) + shift_x * side;
  double bcy = (by0 + side / 2.0) + shift_y * side;
  double box_x = bcx - side / 2.0, box_y = bcy - side / 2.0;

  /* ---- crop camera state: copy of the original, undistorted ---------- */
  double Kc[9], Rc[9];
  memcpy(Kc, Ko, sizeof(Kc));
  memcpy(Rc, Ro, sizeof(Rc));
  const double dist0[5] = {0, 0, 0, 0, 0};

  /* ---- step 2: turn_towards(image_to_world(box center, depth 1000)) -- */
  {
    double rx, ry;
    img_to_ray(Ko, dist, bcx, bcy, &rx, &ry);
    double pc0 = rx * 1000.0, pc1 = ry * 1000.0, pc2 = 1000.0;
    double cw0 = pc0 * Ro[0] + pc1 * Ro[3] + pc2 * Ro[6] + t[0];
    double cw1 = pc0 * Ro[1] + pc1 * Ro[4] + pc2 * Ro[7] + t[1];
    double cw2 = pc0 * Ro[2] + pc1 * Ro[5] + pc2 * Ro[8] + t[2];
    double z0 = cw0 - t[0], z1 = cw1 - t[1], z2 = cw2 - t[2];
    double zn = sqrt(z0 * z0 + z1 * z1 + z2 * z2);
    z0 /= zn; z1 /= zn; z2 /= zn;
    double d0 = -up[0], d1 = -up[1], d2 = -up[2];
    double dz = d0 * z0 + d1 * z1 + d2 * z2;
    double y0 = d0 - dz * z0, y1 = d1 - dz * z1, y2 = d2 - dz * z2;
    double yn = sqrt(y0 * y0 + y1 * y1 + y2 * y2);
    if (yn < 1e-8) { /* looking straight up/down: previous y as tiebreak */
      double rz = Rc[3] * z0 + Rc[4] * z1 + Rc[5] * z2;
      y0 = Rc[3] - rz * z0; y1 = Rc[4] - rz * z1; y2 = Rc[5] - rz * z2;
      yn = sqrt(y0 * y0 + y1 * y1 + y2 * y2);
    }
    y0 /= yn; y1 /= yn; y2 /= yn;
    double x0 = y1 * z2 - y2 * z1;
    double x1 = y2 * z0 - y0 * z2;
    double x2 = y0 * z1 - y1 * z0;
    Rc[0] = x0; Rc[1] = x1; Rc[2] = x2;
    Rc[3] = y0; Rc[4] = y1; Rc[5] = y2;
    Rc[6] = z0; Rc[7] = z1; Rc[8] = z2;
  }

  /* ---- square_pixels, flip, rotate ------------------------------------ */
  {
    double f = (Kc[0] + Kc[4]) / 2.0;
    Kc[0] = f;
    Kc[4] = f;
  }
  if (flip) {
    Rc[0] = -Rc[0]; Rc[1] = -Rc[1]; Rc[2] = -Rc[2];
    Kc[1] = -Kc[1];
  }
  if (rot_rad != 0.0) {
    double c = cos(rot_rad), s = sin(rot_rad);
    double rot[9] = {c, s, 0.0, -s, c, 0.0, 0.0, 0.0, 1.0};
    double tmp[9];
    mat3_mul(rot, Rc, tmp);
    memcpy(Rc, tmp, sizeof(tmp));
  }

  /* ---- zoom so the box boundary fits the output ----------------------- */
  {
    /* 16 boundary points: edges TL->TR->BR->BL, t = 0,.25,.5,.75 */
    double cxs[4] = {box_x, box_x + side, box_x + side, box_x};
    double cys[4] = {box_y, box_y, box_y + side, box_y + side};
    double half_extent = 0.0;
    double ppx = Kc[2], ppy = Kc[5];
    for (int e = 0; e < 4; e++) {
      double ax = cxs[e], ay = cys[e];
      double bx = cxs[(e + 1) % 4], by = cys[(e + 1) % 4];
      for (int k = 0; k < 4; k++) {
        double tt = 0.25 * k;
        double px = ax + (bx - ax) * tt, py = ay + (by - ay) * tt;
        double ox, oy;
        reproject_pt(Ko, Ro, dist, Kc, Rc, dist0, px, py, &ox, &oy);
        double dx = fabs(ox - ppx), dy = fabs(oy - ppy);
        if (dx > half_extent) half_extent = dx;
        if (dy > half_extent) half_extent = dy;
      }
    }
    double zf = scale * (proc_side / 2.0) / (half_extent > 1e-6 ? half_extent : 1e-6);
    Kc[0] *= zf;
    Kc[4] *= zf;
    Kc[2] = (proc_side - 1) / 2.0;
    Kc[5] = (proc_side - 1) / 2.0;
  }

  /* ---- source ROI: reproject the 5x5 crop grid into the source ------- */
  int x0i, y0i, x1i, y1i, factor;
  {
    double lox = INFINITY, loy = INFINITY, hix = -INFINITY, hiy = -INFINITY;
    double step = (proc_side - 1) / 4.0;
    for (int gx = 0; gx < 5; gx++)
      for (int gy = 0; gy < 5; gy++) {
        double ox, oy;
        reproject_pt(Kc, Rc, dist0, Ko, Ro, dist, gx * step, gy * step, &ox, &oy);
        if (ox < lox) lox = ox;
        if (ox > hix) hix = ox;
        if (oy < loy) loy = oy;
        if (oy > hiy) hiy = oy;
      }
    double lx = floor(lox) - 2.0, ly = floor(loy) - 2.0;
    double hx = ceil(hix) + 3.0, hy = ceil(hiy) + 3.0;
    if (lx < 0) lx = 0;
    if (ly < 0) ly = 0;
    if (hx > img_w) hx = img_w;
    if (hy > img_h) hy = img_h;
    double roi_w = hx - lx, roi_h = hy - ly;
    if (roi_w < 1) roi_w = 1;
    if (roi_h < 1) roi_h = 1;
    double m = roi_w > roi_h ? roi_w : roi_h;
    factor = (int)ceil(m / tile_side);
    if (factor < 1) factor = 1;
    x0i = (int)lx;
    y0i = (int)ly;
    x1i = (int)hx;
    y1i = (int)hy;
  }

  /* ---- warp params (geom/camera.get_warp_params + tile rebase) -------- */
  {
    double M[9], Kinv[9], H[9];
    mat3_mul_bt(Ro, Rc, M);
    if (mat3_inv(Kc, Kinv) != 0) return METRO_ESINGULAR;
    mat3_mul(M, Kinv, H);
    memcpy(out + 0, H, sizeof(H));
    /* K rounds through f32 before the rebase, matching
     * rebase_warp_params(get_warp_params(...)) on the f32 dict */
    double fx = round_f32(Ko[0]), fy = round_f32(Ko[4]);
    double cxp = round_f32(Ko[2]), cyp = round_f32(Ko[5]);
    out[9] = fx / factor;
    out[10] = fy / factor;
    out[11] = (cxp - x0i) / factor;
    out[12] = (cyp - y0i) / factor;
    memcpy(out + 13, dist, 5 * sizeof(double));
    memcpy(out + 18, Kc, sizeof(Kc));
    memcpy(out + 27, M, sizeof(M));
    out[36] = Ko[0];
    out[37] = Ko[4];
    out[38] = Ko[2];
    out[39] = Ko[5];
  }

  /* ---- ground truth --------------------------------------------------- */
  double *c3 = out + NBASE;
  double *c2 = c3 + (size_t)J * 3;
  double *v3 = c2 + (size_t)J * 2;
  double *v2 = v3 + J;
  if (mode == 0) {
    for (int j = 0; j < J; j++) {
      const double *p = coords + (size_t)j * 3;
      int wfinite = isfinite(p[0]) && isfinite(p[1]) && isfinite(p[2]);
      double q0 = p[0] - t[0], q1 = p[1] - t[1], q2 = p[2] - t[2];
      double a = q0 * Rc[0] + q1 * Rc[1] + q2 * Rc[2];
      double b = q0 * Rc[3] + q1 * Rc[4] + q2 * Rc[5];
      double c = q0 * Rc[6] + q1 * Rc[7] + q2 * Rc[8];
      double ix, iy;
      cam_to_img(Kc, dist0, a, b, c, &ix, &iy);
      int v2ok = valid_in[j] && isfinite(ix) && isfinite(iy) && ix >= -0.5 &&
                 ix <= proc_side - 0.5 && iy >= -0.5 && iy <= proc_side - 0.5;
      c3[j * 3 + 0] = nan_to_num(a);
      c3[j * 3 + 1] = nan_to_num(b);
      c3[j * 3 + 2] = nan_to_num(c);
      c2[j * 2 + 0] = nan_to_num(ix);
      c2[j * 2 + 1] = nan_to_num(iy);
      v3[j] = (valid_in[j] && wfinite) ? 1.0 : 0.0;
      v2[j] = v2ok ? 1.0 : 0.0;
    }
  } else if (mode == 1) {
    for (int j = 0; j < J; j++) {
      const double *p = coords + (size_t)j * 2;
      double ix, iy;
      reproject_pt(Ko, Ro, dist, Kc, Rc, dist0, p[0], p[1], &ix, &iy);
      int v2ok = valid_in[j] && isfinite(ix) && isfinite(iy) && ix >= -0.5 &&
                 ix <= proc_side - 0.5 && iy >= -0.5 && iy <= proc_side - 0.5;
      c2[j * 2 + 0] = nan_to_num(ix);
      c2[j * 2 + 1] = nan_to_num(iy);
      v2[j] = v2ok ? 1.0 : 0.0;
    }
  }
  if (flip && J > 0 && mode != 2) {
    double *tmp = (double *)malloc((size_t)J * 7 * sizeof(double));
    if (!tmp) return METRO_ENOMEM;
    memcpy(tmp, c3, (size_t)J * 7 * sizeof(double));
    double *t3 = tmp, *t2 = tmp + (size_t)J * 3, *tv3 = t2 + (size_t)J * 2, *tv2 = tv3 + J;
    for (int j = 0; j < J; j++) {
      int m = mirror[j];
      if (m < 0 || m >= J) m = j;
      c3[j * 3 + 0] = t3[m * 3 + 0];
      c3[j * 3 + 1] = t3[m * 3 + 1];
      c3[j * 3 + 2] = t3[m * 3 + 2];
      c2[j * 2 + 0] = t2[m * 2 + 0];
      c2[j * 2 + 1] = t2[m * 2 + 1];
      v3[j] = tv3[m];
      v2[j] = tv2[m];
    }
    free(tmp);
  }
  roi[0] = x0i;
  roi[1] = y0i;
  roi[2] = x1i;
  roi[3] = y1i;
  roi[4] = factor;
  return 0;
}

/* --------------------------------------------------------- tile extraction */

/* ROI slice + integer-factor box (AREA) decimation + zero pad into a fixed
 * tile_side x tile_side x ch tile `dst` (the host half of
 * pipeline/crops.py's extract_source_tile); ch = 1 serves mask tiles.
 * Returns 0, or METRO_EARGS for a ROI outside the image or a bad factor. */
int metro_extract_tile(const uint8_t *src, int h, int w, int x0, int y0, int x1, int y1,
                       int factor, int tile_side, int ch, uint8_t *dst) {
  if (ch < 1 || ch > 4 || x0 < 0 || y0 < 0 || x1 > w || y1 > h || x1 < x0 || y1 < y0 ||
      factor < 1 || tile_side < 1)
    return METRO_EARGS;
  const size_t tbytes = (size_t)tile_side * tile_side * ch;
  memset(dst, 0, tbytes);
  const int roi_w = x1 - x0, roi_h = y1 - y0;
  int out_w = roi_w / factor, out_h = roi_h / factor;
  if (factor == 1) {
    out_w = roi_w;
    out_h = roi_h;
  } else {
    if (out_w < 1 && roi_w > 0) out_w = 1;
    if (out_h < 1 && roi_h > 0) out_h = 1;
  }
  if (out_w > tile_side) out_w = tile_side;
  if (out_h > tile_side) out_h = tile_side;
  /* Effective block side per axis: a clamped ROI dimension smaller than
   * `factor` forced its output dim to 1 above; average only the by x bx
   * pixels that exist inside the ROI (as the numpy engine's truncated
   * slice does) and never read past y1/x1. */
  const int by = (out_h > 0 && roi_h < factor) ? roi_h : factor;
  const int bx = (out_w > 0 && roi_w < factor) ? roi_w : factor;
  const int f2 = by * bx;
  if (factor == 1) {
    for (int oy = 0; oy < out_h; oy++)
      memcpy(dst + (size_t)oy * tile_side * ch, src + ((size_t)(y0 + oy) * w + x0) * ch,
             (size_t)out_w * ch);
    return 0;
  }
  if (factor <= 16) {
    /* three vectorizable passes: (1) vertical u8->u16 row sums, (2)
     * horizontal group sums with a contiguous destination, (3) rounding
     * division, the common block sizes spelled out so the compiler emits
     * vector magic multiplies. Same integer sums and rounding as the
     * f x f loop below (byte-exact); u16 holds f*f*255 <= 65280. */
    const size_t row_elems = (size_t)out_w * bx * ch;
    const int n_res = out_w * ch;
    uint16_t *tmp = (uint16_t *)malloc((row_elems + (size_t)n_res) * sizeof(uint16_t));
    if (tmp) { /* without scratch memory, the scratch-free loop below */
      uint16_t *res = tmp + row_elems;
      const int fc = bx * ch;
      for (int oy = 0; oy < out_h; oy++) {
        memset(tmp, 0, row_elems * sizeof(uint16_t));
        for (int fy = 0; fy < by; fy++) {
          const uint8_t *restrict p = src + ((size_t)(y0 + oy * factor + fy) * w + x0) * ch;
          uint16_t *restrict a = tmp;
          for (size_t i = 0; i < row_elems; i++) a[i] += p[i];
        }
        memset(res, 0, (size_t)n_res * sizeof(uint16_t));
        for (int fx = 0; fx < bx; fx++) {
          const uint16_t *restrict s = tmp + (size_t)fx * ch;
          uint16_t *restrict r = res;
          for (int ox = 0; ox < out_w; ox++)
            for (int c = 0; c < ch; c++) r[ox * ch + c] += s[ox * fc + c];
        }
        uint8_t *restrict drow = dst + (size_t)oy * tile_side * ch;
        const uint16_t *restrict q = res;
        switch (f2) {
          case 4:
            for (int j = 0; j < n_res; j++) drow[j] = (uint8_t)((q[j] + 2) / 4);
            break;
          case 9:
            for (int j = 0; j < n_res; j++) drow[j] = (uint8_t)((q[j] + 4) / 9);
            break;
          case 16:
            for (int j = 0; j < n_res; j++) drow[j] = (uint8_t)((q[j] + 8) / 16);
            break;
          default:
            for (int j = 0; j < n_res; j++) drow[j] = (uint8_t)((q[j] + f2 / 2) / f2);
        }
      }
      free(tmp);
      return 0;
    }
  }
  for (int oy = 0; oy < out_h; oy++) {
    uint8_t *drow = dst + (size_t)oy * tile_side * ch;
    for (int ox = 0; ox < out_w; ox++) {
      unsigned int acc[4] = {0, 0, 0, 0};
      for (int fy = 0; fy < by; fy++) {
        const uint8_t *p = src + ((size_t)(y0 + oy * factor + fy) * w + x0 + ox * factor) * ch;
        for (int fx = 0; fx < bx; fx++) {
          for (int c = 0; c < ch; c++) acc[c] += p[c];
          p += ch;
        }
      }
      for (int c = 0; c < ch; c++) drow[ox * ch + c] = (uint8_t)((acc[c] + f2 / 2) / f2);
    }
  }
  return 0;
}
