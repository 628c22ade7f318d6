/* JPEG decoding on the GPU through nvJPEG, for the port's host runtime on a
 * machine without libjpeg, with a plain C interface that `native/build.py`
 * builds with nvcc at first use and loads with ctypes.
 *
 * It is not a kernel of the port (it replaces no TPU kernel and enters no
 * device path): it takes the place of `jpegdec.c` where libjpeg is missing,
 * and gives the caller's numpy buffer the decoded pixels. It lives outside
 * `csrc/`, so the kernel library never links nvJPEG. It makes its own CUDA
 * runtime calls (the runtime is linked statically, as in the kernel
 * library), so the Python side imports no torch.
 *
 * nvJPEG's default (hybrid) backend decodes baseline, progressive and
 * restart-interval JPEGs; the Huffman pass runs on the host, the IDCT, the
 * chroma upsampling (interpolated, as libjpeg's) and the colour conversion
 * on the card, into device memory that the library owns.
 * Each decode then copies the frame to the host on its own stream and waits
 * for it. One nvjpegHandle_t serves the process; each caller takes a
 * context (nvjpegJpegState_t, stream, device buffer) from a free list and
 * gives it back, so threads that decode at the same time never share one,
 * and the list holds as many contexts as callers were ever concurrent.
 * Nothing is freed before the process ends: the CUDA runtime may already be
 * gone when static destructors run.
 *
 *   metro_nvjpeg_init()                          -> 0, or a code below
 *   metro_nvjpeg_version(&major, &minor, &patch) -> 0, or a code below
 *   metro_nvjpeg_dims(data, len, &h, &w, &components)
 *   metro_nvjpeg_decode(data, len, out, h, w, gray)
 *       out: h * w * 3 bytes (NVJPEG_OUTPUT_RGBI: RGB interleaved; a
 *       one-component JPEG's luma is replicated) or, with gray, h * w
 *       bytes (NVJPEG_OUTPUT_Y: the luma plane, as libjpeg's
 *       JCS_GRAYSCALE output gives it); h, w must be the image's.
 *   Codes: 0 done; 1 a JPEG nvJPEG refuses (bad or unsupported data, or
 *   h, w not the image's); 2 no CUDA device; 100 + nvjpegStatus_t for
 *   another nvJPEG failure; 1000 + cudaError_t for a CUDA failure.
 */
#include <cuda_runtime.h>
#include <library_types.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

enum { OK = 0, REFUSED = 1, NO_DEVICE = 2, NVJPEG_FAULT = 100, CUDA_FAULT = 1000 };

struct Context {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char *buf = nullptr;  // device memory, `cap` bytes
  size_t cap = 0;
};

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;
int g_init = -1;  // not tried yet; then the code of the first attempt
std::vector<Context *> g_free;

int from_nvjpeg(nvjpegStatus_t s) {
  if (s == NVJPEG_STATUS_SUCCESS) return OK;
  if (s == NVJPEG_STATUS_BAD_JPEG || s == NVJPEG_STATUS_JPEG_NOT_SUPPORTED) return REFUSED;
  return NVJPEG_FAULT + (int)s;
}

int from_cuda(cudaError_t e) { return e == cudaSuccess ? OK : CUDA_FAULT + (int)e; }

int init() {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_init >= 0) return g_init;
  int n = 0;
  if (cudaGetDeviceCount(&n) != cudaSuccess || n < 1) {
    cudaGetLastError();  // clear the sticky error of a machine without a card
    return g_init = NO_DEVICE;
  }
  // interpolated chroma upsampling, as libjpeg's default "fancy"
  // upsampling: nvJPEG's own default replicates each chroma sample, which
  // put 4:2:0 and 4:2:2 colour up to 89 levels from libjpeg's at chroma
  // edges, and within 4 with the flag (chip_smoke.py phase 22, nvJPEG 12.4)
  return g_init = from_nvjpeg(nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr,
                                             NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION,
                                             &g_handle));
}

Context *acquire(int *code) {
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!g_free.empty()) {
      Context *c = g_free.back();
      g_free.pop_back();
      return c;
    }
  }
  Context *c = new Context();
  *code = from_nvjpeg(nvjpegJpegStateCreate(g_handle, &c->state));
  if (*code == OK) *code = from_cuda(cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking));
  if (*code != OK) {
    if (c->state) nvjpegJpegStateDestroy(c->state);
    delete c;
    return nullptr;
  }
  return c;
}

void release(Context *c) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_free.push_back(c);
}

int image_info(const unsigned char *data, size_t len, int *h, int *w, int *components) {
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t subsampling;
  int code = from_nvjpeg(
      nvjpegGetImageInfo(g_handle, data, len, components, &subsampling, widths, heights));
  if (code == OK) *h = heights[0], *w = widths[0];
  return code;
}

int decode(Context *c, const unsigned char *data, size_t len, unsigned char *out, int h,
           int w, int gray) {
  int ih = 0, iw = 0, components = 0;
  int code = image_info(data, len, &ih, &iw, &components);
  if (code != OK) return code;
  if (ih != h || iw != w) return REFUSED;
  const size_t pitch = (size_t)w * (gray ? 1 : 3), bytes = pitch * (size_t)h;
  if (bytes > c->cap) {
    if (c->buf) cudaFree(c->buf);
    c->buf = nullptr, c->cap = 0;
    code = from_cuda(cudaMalloc(&c->buf, bytes));
    if (code != OK) return code;
    c->cap = bytes;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof img);
  img.channel[0] = c->buf;
  img.pitch[0] = pitch;
  code = from_nvjpeg(nvjpegDecode(g_handle, c->state, data, len,
                                  gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &img, c->stream));
  if (code == OK)
    code = from_cuda(cudaMemcpyAsync(out, c->buf, bytes, cudaMemcpyDeviceToHost, c->stream));
  const int synced = from_cuda(cudaStreamSynchronize(c->stream));
  return code != OK ? code : synced;
}

}  // namespace

extern "C" {

int metro_nvjpeg_init() { return init(); }

int metro_nvjpeg_version(int *major, int *minor, int *patch) {
  int code = from_nvjpeg(nvjpegGetProperty(MAJOR_VERSION, major));
  if (code == OK) code = from_nvjpeg(nvjpegGetProperty(MINOR_VERSION, minor));
  if (code == OK) code = from_nvjpeg(nvjpegGetProperty(PATCH_LEVEL, patch));
  return code;
}

int metro_nvjpeg_dims(const unsigned char *data, size_t len, int *h, int *w, int *components) {
  int code = init();
  return code != OK ? code : image_info(data, len, h, w, components);
}

int metro_nvjpeg_decode(const unsigned char *data, size_t len, unsigned char *out, int h, int w,
                        int gray) {
  int code = init();
  if (code != OK) return code;
  Context *c = acquire(&code);
  if (c == nullptr) return code;
  code = decode(c, data, len, out, h, w, gray);
  release(c);
  return code;
}

}  // extern "C"
