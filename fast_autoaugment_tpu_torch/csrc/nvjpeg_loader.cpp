// The native loader's C interface (native/faa_loader.cpp) built on nvJPEG,
// for a host whose CUDA toolkit has nvJPEG but which has no libjpeg.
//
//   faa_decode_resize_batch(paths, n, boxes, target, out, threads)
//   faa_gather_u8(src, index, n, item_bytes, out, threads)
//   faa_image_size(path, width, height)
//
// have the signatures and the results of faa_loader.cpp's, except the
// decode, and a failure of the card (below): each worker thread reads a
// file, decodes it on the card with
// nvJPEG, copies the result back to pinned host memory, and crops and
// resizes it on the host with a copy of faa_loader.cpp's resize_box_bilinear
// and its triangle taps.  A 4:4:4, 4:2:2, 4:2:0 or greyscale JPEG (nearly
// every photograph) is decoded to its Y, Cb and Cr planes, and the chroma is
// upsampled and converted to RGB on the host as libjpeg does it, so that
// only the inverse DCT departs from libjpeg's pixels; other samplings take
// nvJPEG's own RGB conversion.  A file that cannot be read or parsed, or
// that nvJPEG refuses as a bad or unsupported bitstream, is zero-filled and
// counted, as there.  A failure of the card (no decoder context, a device or
// pinned allocation, a copy, a synchronization, or nvJPEG failing for any
// other reason) is not a property of the file: faa_decode_resize_batch then
// returns -1, and faa_last_error() (on the calling thread) says what failed
// first.
//
// Each worker holds a decoder context (an nvJPEG state, a non-blocking
// stream, a device and a pinned host buffer that only grow) checked out of
// a process-wide pool for one call, so concurrent calls from several host
// threads never share one.  Device buffers come from the stream-ordered
// allocator (cudaMallocAsync), which does not synchronize the device: a
// decode may run while another thread captures a CUDA graph.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include "jpeg_ycc.h"

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// the crop and resize: a copy of native/faa_loader.cpp:99-190
// ---------------------------------------------------------------------------

struct FilterTaps {
  std::vector<int> first;      // first source index per output pixel
  std::vector<int> count;      // tap count per output pixel
  std::vector<float> weights;  // taps, max_count stride
  int max_count = 0;
};

FilterTaps build_triangle_taps(float in0, float in1, int in_size, int out_size) {
  FilterTaps taps;
  const float scale = (in1 - in0) / out_size;
  const float support = std::max(1.0f, scale);  // triangle filter support
  taps.max_count = int(std::ceil(support)) * 2 + 1;
  taps.first.resize(out_size);
  taps.count.resize(out_size);
  taps.weights.assign(size_t(out_size) * taps.max_count, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    const float center = in0 + (i + 0.5f) * scale;
    int lo = std::max(int(std::floor(center - support + 0.5f)), 0);
    int hi = std::min(int(std::floor(center + support + 0.5f)), in_size);
    hi = std::max(hi, lo + 1);
    float total = 0.0f;
    float* w = taps.weights.data() + size_t(i) * taps.max_count;
    for (int j = lo; j < hi; ++j) {
      const float x = std::fabs((j + 0.5f - center) / support);
      const float weight = x < 1.0f ? 1.0f - x : 0.0f;
      w[j - lo] = weight;
      total += weight;
    }
    if (total > 0.0f) {
      for (int j = 0; j < hi - lo; ++j) w[j] /= total;
    }
    taps.first[i] = lo;
    taps.count[i] = hi - lo;
  }
  return taps;
}

void resize_box_bilinear(const uint8_t* src, int src_w, int src_h, float x0,
                         float y0, float x1, float y1, int target,
                         uint8_t* out) {
  const FilterTaps tx = build_triangle_taps(x0, x1, src_w, target);
  const FilterTaps ty = build_triangle_taps(y0, y1, src_h, target);

  int row_lo = src_h, row_hi = 0;
  for (int oy = 0; oy < target; ++oy) {
    row_lo = std::min(row_lo, ty.first[oy]);
    row_hi = std::max(row_hi, ty.first[oy] + ty.count[oy]);
  }

  std::vector<float> tmp(size_t(row_hi - row_lo) * target * 3);
  for (int y = row_lo; y < row_hi; ++y) {
    const uint8_t* row = src + size_t(y) * src_w * 3;
    float* trow = tmp.data() + size_t(y - row_lo) * target * 3;
    for (int ox = 0; ox < target; ++ox) {
      const float* w = tx.weights.data() + size_t(ox) * tx.max_count;
      float acc[3] = {0, 0, 0};
      const int lo = tx.first[ox];
      for (int j = 0; j < tx.count[ox]; ++j) {
        const uint8_t* px = row + size_t(lo + j) * 3;
        acc[0] += w[j] * px[0];
        acc[1] += w[j] * px[1];
        acc[2] += w[j] * px[2];
      }
      trow[ox * 3 + 0] = acc[0];
      trow[ox * 3 + 1] = acc[1];
      trow[ox * 3 + 2] = acc[2];
    }
  }
  for (int oy = 0; oy < target; ++oy) {
    const float* w = ty.weights.data() + size_t(oy) * ty.max_count;
    const int lo = ty.first[oy] - row_lo;
    for (int ox = 0; ox < target; ++ox) {
      float acc[3] = {0, 0, 0};
      for (int j = 0; j < ty.count[oy]; ++j) {
        const float* px = tmp.data() + (size_t(lo + j) * target + ox) * 3;
        acc[0] += w[j] * px[0];
        acc[1] += w[j] * px[1];
        acc[2] += w[j] * px[2];
      }
      uint8_t* dst = out + (size_t(oy) * target + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        dst[c] = uint8_t(std::lround(std::clamp(acc[c], 0.0f, 255.0f)));
      }
    }
  }
}

void parallel_for(int n, int threads, const std::function<void(int)>& fn) {
  if (threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  const int workers = std::min(threads, n);
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// nvJPEG decoding
// ---------------------------------------------------------------------------

bool read_file(const char* path, std::vector<unsigned char>* data) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return false;
  bool ok = std::fseek(fh, 0, SEEK_END) == 0;
  const long size = ok ? std::ftell(fh) : -1;
  ok = ok && size > 0 && std::fseek(fh, 0, SEEK_SET) == 0;
  if (ok) {
    data->resize(size_t(size));
    ok = std::fread(data->data(), 1, size_t(size), fh) == size_t(size);
  }
  std::fclose(fh);
  return ok;
}

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;

// what became of one image
enum class Outcome { kDecoded, kBadFile, kDeviceError };

// the first failure of the card in one faa_decode_resize_batch call
struct CardError {
  std::mutex mu;
  std::string what;

  Outcome set(const std::string& failed) {
    std::lock_guard<std::mutex> lock(mu);
    if (what.empty()) what = failed;
    return Outcome::kDeviceError;
  }

  Outcome set(const char* call, cudaError_t code) {
    return set(std::string(call) + " failed: " + cudaGetErrorString(code));
  }
};

// the calling thread's last call's CardError, for faa_last_error()
thread_local std::string t_last_error;

// the process-wide nvJPEG handle (thread-safe by nvJPEG's contract), or
// nullptr when it cannot be made
nvjpegHandle_t handle() {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_handle == nullptr) {
    nvjpegHandle_t h = nullptr;
    if (nvjpegCreateSimple(&h) != NVJPEG_STATUS_SUCCESS) return nullptr;
    g_handle = h;
  }
  return g_handle;
}

struct Decoder {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  size_t dev_bytes = 0;
  uint8_t* host = nullptr;  // pinned
  size_t host_bytes = 0;
  std::vector<unsigned char> file;
  std::vector<uint8_t> rgb, up_cb, up_cr;  // the decoded image, upsampled chroma
};

std::vector<Decoder*> g_free;  // idle decoders, guarded by g_mu

Decoder* acquire() {
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!g_free.empty()) {
      Decoder* d = g_free.back();
      g_free.pop_back();
      return d;
    }
  }
  nvjpegHandle_t h = handle();
  if (h == nullptr) return nullptr;
  Decoder* d = new Decoder();
  if (cudaStreamCreateWithFlags(&d->stream, cudaStreamNonBlocking) != cudaSuccess ||
      nvjpegJpegStateCreate(h, &d->state) != NVJPEG_STATUS_SUCCESS) {
    if (d->stream != nullptr) cudaStreamDestroy(d->stream);
    delete d;
    return nullptr;
  }
  return d;
}

void release(Decoder* d) {
  if (d == nullptr) return;
  std::lock_guard<std::mutex> lock(g_mu);
  g_free.push_back(d);
}

// grow a stream-ordered device buffer to `bytes`
bool reserve_device(Decoder* d, size_t bytes) {
  if (d->dev_bytes >= bytes) return true;
  if (d->dev != nullptr) cudaFreeAsync(d->dev, d->stream);
  d->dev = nullptr;
  d->dev_bytes = 0;
  if (cudaMallocAsync(reinterpret_cast<void**>(&d->dev), bytes, d->stream) != cudaSuccess) {
    d->dev = nullptr;
    return false;
  }
  d->dev_bytes = bytes;
  return true;
}

// grow the pinned host buffer to `bytes`
bool reserve_host(Decoder* d, size_t bytes) {
  if (d->host_bytes >= bytes) return true;
  if (d->host != nullptr) cudaFreeHost(d->host);
  d->host = nullptr;
  d->host_bytes = 0;
  if (cudaMallocHost(reinterpret_cast<void**>(&d->host), bytes) != cudaSuccess) {
    d->host = nullptr;
    return false;
  }
  d->host_bytes = bytes;
  return true;
}

// decode `data` to interleaved RGB in d->rgb.
// 4:4:4, 4:2:2 (h2v1), 4:2:0 (h2v2) and greyscale JPEGs decode to planes
// (NVJPEG_OUTPUT_YUV / _Y) that are upsampled and converted as libjpeg does;
// other samplings take nvJPEG's own RGB conversion (NVJPEG_OUTPUT_RGBI).
Outcome decode(Decoder* d, const std::vector<unsigned char>& data, int* width, int* height,
               CardError* err) {
  nvjpegHandle_t h = handle();
  if (h == nullptr) return err->set("nvjpegCreateSimple failed");
  int ncomp = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  if (nvjpegGetImageInfo(h, data.data(), data.size(), &ncomp, &subsampling, widths,
                         heights) != NVJPEG_STATUS_SUCCESS) {
    return Outcome::kBadFile;  // the header is parsed on the host
  }
  const int w = widths[0], hgt = heights[0];
  if (w <= 0 || hgt <= 0) return Outcome::kBadFile;
  const bool grey = subsampling == NVJPEG_CSS_GRAY;
  const bool planar = grey || (ncomp == 3 && (subsampling == NVJPEG_CSS_444 ||
                                              subsampling == NVJPEG_CSS_422 ||
                                              subsampling == NVJPEG_CSS_420));
  const int cw = planar && !grey ? widths[1] : 0, ch = planar && !grey ? heights[1] : 0;
  if (planar && !grey && (cw <= 0 || ch <= 0 || widths[2] != cw || heights[2] != ch)) {
    return Outcome::kBadFile;
  }
  const size_t luma = size_t(w) * hgt, chroma = size_t(cw) * ch;
  const size_t bytes = planar ? luma + 2 * chroma : luma * 3;
  if (!reserve_device(d, bytes)) {
    return err->set("cudaMallocAsync of " + std::to_string(bytes) + " bytes failed");
  }
  if (!reserve_host(d, bytes)) {
    return err->set("cudaMallocHost of " + std::to_string(bytes) + " bytes failed");
  }
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  nvjpegOutputFormat_t format = NVJPEG_OUTPUT_RGBI;
  if (planar) {
    format = grey ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV;
    image.channel[0] = d->dev;
    image.pitch[0] = size_t(w);
    if (!grey) {
      image.channel[1] = d->dev + luma;
      image.pitch[1] = size_t(cw);
      image.channel[2] = d->dev + luma + chroma;
      image.pitch[2] = size_t(cw);
    }
  } else {
    image.channel[0] = d->dev;
    image.pitch[0] = size_t(w) * 3;
  }
  const nvjpegStatus_t status =
      nvjpegDecode(h, d->state, data.data(), data.size(), format, &image, d->stream);
  if (status != NVJPEG_STATUS_SUCCESS) {
    const cudaError_t sync = cudaStreamSynchronize(d->stream);
    if (sync != cudaSuccess) return err->set("cudaStreamSynchronize", sync);
    if (status == NVJPEG_STATUS_BAD_JPEG || status == NVJPEG_STATUS_JPEG_NOT_SUPPORTED) {
      return Outcome::kBadFile;
    }
    return err->set("nvjpegDecode failed: status " + std::to_string(int(status)));
  }
  const cudaError_t copy =
      cudaMemcpyAsync(d->host, d->dev, bytes, cudaMemcpyDeviceToHost, d->stream);
  if (copy != cudaSuccess) {
    cudaStreamSynchronize(d->stream);
    return err->set("cudaMemcpyAsync", copy);
  }
  const cudaError_t sync = cudaStreamSynchronize(d->stream);
  if (sync != cudaSuccess) return err->set("cudaStreamSynchronize", sync);
  d->rgb.resize(luma * 3);
  if (!planar) {
    std::memcpy(d->rgb.data(), d->host, luma * 3);
  } else if (grey) {
    for (size_t i = 0; i < luma; ++i) {
      d->rgb[3 * i] = d->rgb[3 * i + 1] = d->rgb[3 * i + 2] = d->host[i];
    }
  } else {
    const uint8_t* cb = d->host + luma;
    const uint8_t* cr = cb + chroma;
    if (subsampling == NVJPEG_CSS_444) {
      faa_jpeg::ycc_to_rgb(d->host, cb, cr, w, hgt, cw, d->rgb.data());
    } else {
      const bool v2 = subsampling == NVJPEG_CSS_420;
      const int uw = 2 * cw, uh = v2 ? 2 * ch : ch;
      if (uw < w || uh < hgt) return Outcome::kBadFile;
      d->up_cb.resize(size_t(uw) * uh);
      d->up_cr.resize(size_t(uw) * uh);
      if (v2) {
        faa_jpeg::upsample_h2v2(cb, cw, ch, d->up_cb.data());
        faa_jpeg::upsample_h2v2(cr, cw, ch, d->up_cr.data());
      } else {
        faa_jpeg::upsample_h2v1(cb, cw, ch, d->up_cb.data());
        faa_jpeg::upsample_h2v1(cr, cw, ch, d->up_cr.data());
      }
      faa_jpeg::ycc_to_rgb(d->host, d->up_cb.data(), d->up_cr.data(), w, hgt, uw,
                           d->rgb.data());
    }
  }
  *width = w;
  *height = hgt;
  return Outcome::kDecoded;
}

}  // namespace

extern "C" {

int faa_decode_resize_batch(const char** paths, int n, const float* boxes,
                            int target, uint8_t* out, int threads) {
  CardError err;
  std::atomic<int> failures{0};
  std::atomic<bool> device_failed{false};
  const size_t item = size_t(target) * target * 3;
  const int workers = std::max(1, std::min(threads, n));
  std::vector<Decoder*> decoders(workers, nullptr);
  for (int t = 0; t < workers; ++t) decoders[t] = acquire();
  // worker t decodes images t, t + workers, ... with its own decoder
  parallel_for(workers, workers, [&](int t) {
    Decoder* d = decoders[t];
    for (int i = t; i < n; i += workers) {
      uint8_t* dst = out + size_t(i) * item;
      int w = 0, h = 0;
      Outcome outcome = Outcome::kBadFile;
      if (d == nullptr) {
        outcome = err.set("no nvJPEG decoder context (its stream or state could not be made)");
      } else if (read_file(paths[i], &d->file)) {
        outcome = decode(d, d->file, &w, &h, &err);
      }
      if (outcome != Outcome::kDecoded) {
        std::memset(dst, 0, item);
        if (outcome == Outcome::kDeviceError) {
          device_failed.store(true);
        } else {
          failures.fetch_add(1);
        }
        continue;
      }
      float x0 = 0, y0 = 0, x1 = float(w), y1 = float(h);
      if (boxes) {
        x0 = boxes[i * 4 + 0];
        y0 = boxes[i * 4 + 1];
        x1 = boxes[i * 4 + 2];
        y1 = boxes[i * 4 + 3];
      }
      resize_box_bilinear(d->rgb.data(), w, h, x0, y0, x1, y1, target, dst);
    }
  });
  for (Decoder* d : decoders) release(d);
  t_last_error = err.what;
  return device_failed.load() ? -1 : failures.load();
}

// what failed first on the card in this thread's last faa_decode_resize_batch
// call that returned -1
const char* faa_last_error() { return t_last_error.c_str(); }

void faa_gather_u8(const uint8_t* src, const int64_t* index, int n,
                   int64_t item_bytes, uint8_t* out, int threads) {
  parallel_for(n, threads, [&](int i) {
    std::memcpy(out + size_t(i) * item_bytes,
                src + size_t(index[i]) * item_bytes, size_t(item_bytes));
  });
}

int faa_image_size(const char* path, int* width, int* height) {
  nvjpegHandle_t h = handle();
  std::vector<unsigned char> data;
  if (h == nullptr || !read_file(path, &data)) return 1;
  int ncomp = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  if (nvjpegGetImageInfo(h, data.data(), data.size(), &ncomp, &subsampling, widths,
                         heights) != NVJPEG_STATUS_SUCCESS) {
    return 1;
  }
  *width = widths[0];
  *height = heights[0];
  return 0;
}

}  // extern "C"
