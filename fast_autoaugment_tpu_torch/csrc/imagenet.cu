/*
 * ImageNet train stack kernel for NVIDIA Hopper (sm_90a).
 *
 * Replaces fast_autoaugment_tpu/ops/preprocess_imagenet.py:191
 * imagenet_train_batch after the policy: _train_one (:168) with
 * _color_jitter (:136) and _lighting (:161).  Per image [H, W, 3]:
 *
 *   1. the horizontal flip (img[:, ::-1]);
 *   2. ColorJitter: brightness, contrast and saturation in one of six
 *      orders, each the PIL-exact blend deg + (img - deg) * f, trunc, clip
 *      (ops/augment.py:135); contrast blends toward trunc(mean + 0.5) of the
 *      PIL 'L' grey of the image as it stands just before contrast,
 *      saturation toward each pixel's own grey;
 *   3. v * (1/255), the float32 reciprocal XLA multiplies by;
 *   4. + rgb[c], the image's PCA lighting offset (computed in PyTorch);
 *   5. (v - mean[c]) * (1/std[c]);
 *   6. 0 inside the cutout box [c - half, c + half) on the output
 *      coordinates (half = 0: no cutout).
 *
 * It reads uint8 or float32 (integral values in [0, 255]: the batch itself,
 * or the augmentation kernel's output) and writes float32 NHWC, the
 * channels_last layout the model's convolutions read.
 *
 * Two launches.  The contrast mean is a reduction over the whole image of
 * the grey values as they stand before contrast, which depends on the
 * drawn order (after brightness and/or saturation when those come first).
 * Those two ops are per pixel, so the first kernel (grey_sum_kernel)
 * recomputes them: a grid of (tiles of 1024 pixels, images), each block
 * writing the integer grey sum of its tile to partial[image, tile].  The
 * second kernel (imagenet_stack_kernel), one thread per pixel on a grid of
 * (tiles of 256 pixels, images), first sums its image's partials in the
 * first warp (integers: the order of the sum does not matter), then runs
 * the whole per-pixel chain.  A grid over tiles of every image keeps all
 * SMs busy at any batch size, where one block per image would leave them
 * idle at small batches; no atomics, so no buffer needs zeroing.
 *
 * Bound: bytes.  The function reads the input once and writes the output
 * once (N*H*W*3 * (sizeof(in) + 4) bytes); the first kernel reads the
 * input a second time, so the kernels move that plus N*H*W*3*sizeof(in).
 * About 20 float operations per element, far below the card's rate.
 *
 * Rounding: every product, difference and sum is an explicit
 * round-to-nearest intrinsic in the reference's order, and the file is
 * built with --fmad=false, so the compiler contracts no multiply-add.  The
 * contrast mean uses the augmentation kernel's formula
 * trunc(float(sum) / (H*W) + 0.5) on the exact integer sum.
 */

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumPixels = 1024;  // pixels per block of the grey-sum pass
constexpr int BRIGHTNESS = 0, CONTRAST = 1, SATURATION = 2;

// the branch table of _color_jitter (preprocess_imagenet.py:152)
__constant__ int kOrders[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                                  {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};

struct Norm {
  float scale;
  float mean[3];
  float rstd[3];
};

__device__ __forceinline__ float clip255(float x) {
  return fminf(fmaxf(x, 0.0f), 255.0f);
}

// PIL Image.blend + uint8 store: deg + (img - deg) * f, trunc, clip
__device__ __forceinline__ float blend(float deg, float img, float f) {
  return clip255(truncf(__fadd_rn(deg, __fmul_rn(__fsub_rn(img, deg), f))));
}

// PIL 'L' conversion of one RGB pixel
__device__ __forceinline__ int gray_u8(const float* v) {
  return ((int)clip255(v[0]) * 19595 + (int)clip255(v[1]) * 38470 +
          (int)clip255(v[2]) * 7471 + 0x8000) >> 16;
}

__device__ __forceinline__ float load(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ float load(const float* p) { return *p; }

// one ColorJitter op on one pixel; `mean` is used by contrast only
__device__ __forceinline__ void jitter(int op, float* v, float f, float mean) {
  if (op == BRIGHTNESS) {
    for (int c = 0; c < 3; ++c) v[c] = blend(0.0f, clip255(v[c]), f);
  } else if (op == CONTRAST) {
    for (int c = 0; c < 3; ++c) v[c] = blend(mean, clip255(v[c]), f);
  } else {
    const float g = (float)gray_u8(v);
    for (int c = 0; c < 3; ++c) v[c] = blend(g, clip255(v[c]), f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grey_sum_kernel(const T* __restrict__ in, const int* __restrict__ ints,
                const float* __restrict__ floats, long long* __restrict__ partial,
                int HW, int tiles) {
  const int n = blockIdx.y, tile = blockIdx.x;
  const int order = ints[4 * n + 1];
  const float* f = floats + 6 * n;
  int local = 0;
  for (int k = 0; k < kSumPixels / kThreads; ++k) {
    const int p = tile * kSumPixels + k * kThreads + threadIdx.x;
    if (p >= HW) break;
    const T* px = in + ((long long)n * HW + p) * 3;
    float v[3] = {load(px), load(px + 1), load(px + 2)};
    for (int j = 0; j < 3; ++j) {  // the ops before contrast, in order
      const int op = kOrders[order][j];
      if (op == CONTRAST) break;
      jitter(op, v, f[op], 0.0f);
    }
    local += gray_u8(v);
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  __shared__ int warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    partial[(long long)n * tiles + tile] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
imagenet_stack_kernel(const T* __restrict__ in, float* __restrict__ out,
                      const int* __restrict__ ints, const float* __restrict__ floats,
                      const long long* __restrict__ partial, int H, int W, int tiles,
                      int half, Norm norm) {
  const int n = blockIdx.y;
  const int HW = H * W;
  __shared__ float mean_s;
  if (threadIdx.x < 32) {
    long long s = 0;
    for (int t = threadIdx.x; t < tiles; t += 32) s += partial[(long long)n * tiles + t];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0)
      mean_s = truncf(__fadd_rn(__fdiv_rn(__ll2float_rn(s), (float)HW), 0.5f));
  }
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int* d = ints + 4 * n;
  const int flip = d[0], order = d[1], cy = d[2], cx = d[3];
  const float* f = floats + 6 * n;
  const int y = p / W, x = p - y * W;
  const int xs = flip ? W - 1 - x : x;
  const T* px = in + ((long long)n * HW + (long long)y * W + xs) * 3;
  float v[3] = {load(px), load(px + 1), load(px + 2)};
  for (int j = 0; j < 3; ++j) {
    const int op = kOrders[order][j];
    jitter(op, v, f[op], mean_s);
  }
  const bool cut = y >= cy - half && y < cy + half && x >= cx - half && x < cx + half;
  float* o = out + ((long long)n * HW + p) * 3;
  for (int c = 0; c < 3; ++c) {
    const float lit = __fadd_rn(__fmul_rn(v[c], norm.scale), f[3 + c]);
    const float r = __fmul_rn(__fsub_rn(lit, norm.mean[c]), norm.rstd[c]);
    o[c] = cut ? 0.0f : r;
  }
}

template <typename T>
cudaError_t launch(const void* src, float* dst, const int* ints, const float* floats,
                   long long* partial, int batch, int H, int W, int half, Norm norm,
                   cudaStream_t stream) {
  const T* in = static_cast<const T*>(src);
  const int HW = H * W;
  const int tiles = (HW + kSumPixels - 1) / kSumPixels;
  grey_sum_kernel<T><<<dim3(tiles, batch), kThreads, 0, stream>>>(in, ints, floats, partial,
                                                                  HW, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (HW + kThreads - 1) / kThreads;
  imagenet_stack_kernel<T><<<dim3(blocks, batch), kThreads, 0, stream>>>(
      in, dst, ints, floats, partial, H, W, tiles, half, norm);
  return cudaGetLastError();
}

}  // namespace

// tiles of the partial-sum buffer the caller allocates: [batch, tiles] int64
extern "C" int faa_imagenet_tiles(int height, int width) {
  return (height * width + kSumPixels - 1) / kSumPixels;
}

extern "C" int faa_imagenet_stack(const void* src, int src_is_u8, float* dst, const int* ints,
                                  const float* floats, long long* partial, int batch,
                                  int height, int width, int half, float scale, float m0,
                                  float m1, float m2, float r0, float r1, float r2,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;  // gridDim.y
  const Norm norm = {scale, {m0, m1, m2}, {r0, r1, r2}};
  cudaStream_t s = (cudaStream_t)stream;
  err = src_is_u8 ? launch<uint8_t>(src, dst, ints, floats, partial, batch, height, width,
                                    half, norm, s)
                  : launch<float>(src, dst, ints, floats, partial, batch, height, width,
                                  half, norm, s);
  return (int)err;
}

extern "C" const char* faa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
