/* JPEG decoding for the port's host runtime, against the system libjpeg,
 * with a plain C interface that `native/build.py` loads with ctypes.
 *
 * The port's copy of `decode_jpeg` and `decode_jpeg_batch` from the JAX
 * package's `native/jpegdec.c`, without Python.h: the caller reads the
 * size with `metro_jpeg_dims`, allocates the RGB8 array and passes it in.
 * This is a library of its own, built only when a JPEG is read, so that
 * the crop engine (croprep.c) never needs libjpeg.
 *
 *   metro_jpeg_dims(data, len, &h, &w)            -> 0, or 1 if not a JPEG
 *   metro_decode_jpeg(data, len, out, h, w)        -> 0, or 1 if corrupt
 *   metro_decode_jpeg_gray(data, len, out, h, w)   the same, one channel
 *       (libjpeg's JCS_GRAYSCALE output: the luma of a colour JPEG, as
 *       cv2.imread(..., IMREAD_GRAYSCALE) reads it); out is h*w bytes
 *   metro_decode_jpeg_batch(datas, lens, outs, hs, ws, n, threads, status)
 *       decodes n JPEGs on up to `threads` pthreads; status[i] as above.
 */
#include <stddef.h>
#include <stdint.h>
#include <stdio.h> /* before jpeglib.h, which uses size_t and FILE */

#include <jpeglib.h>
#include <pthread.h>
#include <setjmp.h>

struct error_mgr {
  struct jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void error_exit(j_common_ptr cinfo) {
  struct error_mgr *err = (struct error_mgr *)cinfo->err;
  longjmp(err->setjmp_buffer, 1);
}

static void silent(j_common_ptr cinfo) { (void)cinfo; }

int metro_jpeg_dims(const uint8_t *data, size_t len, int *out_h, int *out_w) {
  struct jpeg_decompress_struct cinfo;
  struct error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  *out_h = (int)cinfo.output_height;
  *out_w = (int)cinfo.output_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

/* Decode one JPEG from memory into `out` (h*w*channels bytes, h and w from
 * metro_jpeg_dims) in the colour space `space`: JCS_RGB (3 channels) or
 * JCS_GRAYSCALE (1). Pure C: safe on any thread. */
static int decode(const uint8_t *data, size_t len, uint8_t *out, int h, int w,
                  J_COLOR_SPACE space, int channels) {
  struct jpeg_decompress_struct cinfo;
  struct error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = space;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != w || (int)cinfo.output_height != h ||
      cinfo.output_components != channels) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  const size_t stride = (size_t)w * (size_t)channels;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t *row = out + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int metro_decode_jpeg(const uint8_t *data, size_t len, uint8_t *out, int h, int w) {
  return decode(data, len, out, h, w, JCS_RGB, 3);
}

int metro_decode_jpeg_gray(const uint8_t *data, size_t len, uint8_t *out, int h, int w) {
  return decode(data, len, out, h, w, JCS_GRAYSCALE, 1);
}

/* ------------------------------------------------- threaded batch decode */

typedef struct {
  const uint8_t *const *datas;
  const size_t *lens;
  uint8_t *const *outs;
  const int *hs, *ws;
  int *status;
  int n;
  int next; /* guarded by lock */
  pthread_mutex_t lock;
} batch_t;

static void *worker(void *arg) {
  batch_t *b = (batch_t *)arg;
  for (;;) {
    pthread_mutex_lock(&b->lock);
    int i = b->next++;
    pthread_mutex_unlock(&b->lock);
    if (i >= b->n) break;
    b->status[i] = metro_decode_jpeg(b->datas[i], b->lens[i], b->outs[i], b->hs[i], b->ws[i]);
  }
  return NULL;
}

int metro_decode_jpeg_batch(const uint8_t *const *datas, const size_t *lens,
                            uint8_t *const *outs, const int *hs, const int *ws, int n,
                            int threads, int *status) {
  if (n <= 0) return 0;
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  if (threads > 64) threads = 64;
  batch_t batch = {datas, lens, outs, hs, ws, status, n, 0, PTHREAD_MUTEX_INITIALIZER};
  pthread_t tids[64];
  int started = 0;
  for (; started < threads; started++)
    if (pthread_create(&tids[started], NULL, worker, &batch)) break;
  if (started == 0) worker(&batch); /* no thread could start: decode here */
  for (int i = 0; i < started; i++) pthread_join(tids[i], NULL);
  return 0;
}
