/*
 * Policy augmentation kernel for NVIDIA Hopper (sm_90a).
 *
 * Replaces fast_autoaugment_tpu/ops/augment.py:409-572 (apply_op,
 * apply_subpolicy, apply_policy, apply_policy_batch,
 * apply_policy_batch_grouped), with the ops it dispatches fused in:
 * _warp_affine_nearest (:150), _histogram256 / equalize / auto_contrast
 * (:168, :254, :230), _smooth_degenerate / sharpness and the _blend family
 * (:313, :329, :135), and the pointwise ops (:250-365).  XLA evaluates all
 * 19 op branches for every image and keeps one; here each block reads its
 * image's op id and runs that op only.
 *
 * One launch applies one op slot to a batch: block b takes image b and the
 * record of (b, slot) that fast_autoaugment_tpu_torch/ops/augment.py
 * slot_records() built (op id, gate, value, 2x3 affine map, cutout box).
 * A gated-off slot copies the image through.
 *
 * Bound: bytes.  A slot reads the batch once and writes it once,
 * 2*B*H*W*3*4 bytes, plus re-reads that the caches serve (the 3x3
 * stencil's neighbours, the second pass of the histogram ops).  The
 * arithmetic is a few dozen float ops per pixel, far below the card's
 * rate.  The design moves no more than that: the threads of a block walk
 * the image's pixels in order, so neighbouring threads touch neighbouring
 * addresses, and shared memory holds only the per-channel histograms or
 * LUTs (3x256 int), the min/max and the grey sum.  Each pixel is read
 * from global memory, so any H x W works without tiling.  The slots are
 * not fused: keeping the image on chip across slots would halve the
 * traffic, and one block per image leaves SMs idle at small batches.
 *
 * Rounding: the ops are held bitwise against PIL-exact references, so
 * every float multiply and add is an explicit round-to-nearest intrinsic
 * in the reference's order, and the file is built with --fmad=false so that
 * the compiler contracts no multiply-add into a fused one.
 */

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRec = 16;  // floats per (image, slot) record

enum Op {
  SHEAR_X, SHEAR_Y, TRANSLATE_X, TRANSLATE_Y, ROTATE, AUTO_CONTRAST, INVERT,
  EQUALIZE, SOLARIZE, POSTERIZE, CONTRAST, COLOR, BRIGHTNESS, SHARPNESS,
  CUTOUT, CUTOUT_ABS, POSTERIZE2, TRANSLATE_X_ABS, TRANSLATE_Y_ABS
};

__device__ __forceinline__ float clip255(float x) {
  return fminf(fmaxf(x, 0.0f), 255.0f);
}

__device__ __forceinline__ int to_int(float x) { return (int)clip255(x); }

// PIL Image.blend + uint8 store: deg + (img - deg) * f, trunc, clip
__device__ __forceinline__ float blend(float deg, float img, float f) {
  return clip255(truncf(__fadd_rn(deg, __fmul_rn(__fsub_rn(img, deg), f))));
}

// PIL 'L' conversion of one RGB pixel
__device__ __forceinline__ int gray_u8(const float* px) {
  return (to_int(px[0]) * 19595 + to_int(px[1]) * 38470 +
          to_int(px[2]) * 7471 + 0x8000) >> 16;
}

__device__ void copy_image(const float* in, float* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = in[i];
}

// src = floor(A (x+.5, y+.5) + t), zero outside the image
__device__ void warp_affine(const float* in, float* out, const float* m,
                            int H, int W) {
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m10 = m[3], m11 = m[4], m12 = m[5];
  for (int p = threadIdx.x; p < H * W; p += blockDim.x) {
    const int y = p / W, x = p - y * W;
    const float xs = __fadd_rn((float)x, 0.5f), ys = __fadd_rn((float)y, 0.5f);
    const float fx = floorf(__fadd_rn(__fadd_rn(__fmul_rn(m00, xs),
                                                __fmul_rn(m01, ys)), m02));
    const float fy = floorf(__fadd_rn(__fadd_rn(__fmul_rn(m10, xs),
                                                __fmul_rn(m11, ys)), m12));
    float* o = out + 3 * p;
    if (fx >= 0.0f && fx < (float)W && fy >= 0.0f && fy < (float)H) {
      const float* s = in + 3 * ((int)fy * W + (int)fx);
      o[0] = s[0]; o[1] = s[1]; o[2] = s[2];
    } else {
      o[0] = 0.0f; o[1] = 0.0f; o[2] = 0.0f;
    }
  }
}

// PIL autocontrast(cutoff=0) as the exact rational (i - lo) * 255 // (hi - lo)
__device__ void auto_contrast(const float* in, float* out, int HW,
                              int* lo, int* hi) {
  if (threadIdx.x < 3) { lo[threadIdx.x] = 255; hi[threadIdx.x] = 0; }
  __syncthreads();
  int l[3] = {255, 255, 255}, h[3] = {0, 0, 0};
  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    for (int c = 0; c < 3; ++c) {
      const int i = to_int(in[3 * p + c]);
      l[c] = min(l[c], i);
      h[c] = max(h[c], i);
    }
  }
  for (int c = 0; c < 3; ++c) { atomicMin(&lo[c], l[c]); atomicMax(&hi[c], h[c]); }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * HW; i += blockDim.x) {
    const int c = i % 3, v = to_int(in[i]), a = lo[c], b = hi[c];
    const int r = (b <= a) ? v : min(max((v - a) * 255 / max(b - a, 1), 0), 255);
    out[i] = (float)r;
  }
}

// PIL equalize: per-channel histogram -> integer LUT -> gather
__device__ void equalize(const float* in, float* out, int HW, int (*lut)[256]) {
  for (int i = threadIdx.x; i < 3 * 256; i += blockDim.x) lut[i / 256][i % 256] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * HW; i += blockDim.x)
    atomicAdd(&lut[i % 3][to_int(in[i])], 1);
  __syncthreads();
  if (threadIdx.x < 3) {
    int* hst = lut[threadIdx.x];
    int total = 0, nonzero = 0, last = 0;
    for (int i = 0; i < 256; ++i) {
      total += hst[i];
      if (hst[i] > 0) { ++nonzero; last = i; }
    }
    const int step = (total - hst[last]) / 255;
    if (nonzero <= 1 || step == 0) {
      for (int i = 0; i < 256; ++i) hst[i] = i;
    } else {
      int csum = 0;  // exclusive prefix sum
      for (int i = 0; i < 256; ++i) {
        const int count = hst[i];
        hst[i] = min(max((step / 2 + csum) / step, 0), 255);
        csum += count;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * HW; i += blockDim.x)
    out[i] = (float)lut[i % 3][to_int(in[i])];
}

// blend toward the rounded mean of the PIL 'L' image
__device__ void contrast(const float* in, float* out, int HW, float f,
                         unsigned long long* gray_sum) {
  if (threadIdx.x == 0) *gray_sum = 0ull;
  __syncthreads();
  unsigned long long local = 0ull;
  for (int p = threadIdx.x; p < HW; p += blockDim.x) local += gray_u8(in + 3 * p);
  atomicAdd(gray_sum, local);
  __syncthreads();
  const float mean = truncf(__fadd_rn(
      __fdiv_rn(__ull2float_rn(*gray_sum), (float)HW), 0.5f));
  for (int i = threadIdx.x; i < 3 * HW; i += blockDim.x)
    out[i] = blend(mean, clip255(in[i]), f);
}

// blend toward PIL SMOOTH ([[1,1,1],[1,5,1],[1,1,1]]/13, border copied)
__device__ void sharpness(const float* in, float* out, int H, int W, float f) {
  const float k1 = __fdiv_rn(1.0f, 13.0f), k5 = __fdiv_rn(5.0f, 13.0f);
  for (int p = threadIdx.x; p < H * W; p += blockDim.x) {
    const int y = p / W, x = p - y * W;
    const bool border = y == 0 || y == H - 1 || x == 0 || x == W - 1;
    for (int c = 0; c < 3; ++c) {
      const float xc = clip255(in[3 * p + c]);
      float deg = xc;
      if (!border) {
        float acc = 0.0f;  // taps in the reference's order: dy outer, dx inner
        for (int dy = 0; dy < 3; ++dy)
          for (int dx = 0; dx < 3; ++dx) {
            const float k = (dy == 1 && dx == 1) ? k5 : k1;
            acc = __fadd_rn(acc, __fmul_rn(k, in[3 * ((y + dy - 1) * W + x + dx - 1) + c]));
          }
        deg = clip255(truncf(__fadd_rn(acc, 0.5f)));
      }
      out[3 * p + c] = blend(deg, xc, f);
    }
  }
}

__global__ void __launch_bounds__(kThreads) augment_slot_kernel(
    const float* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ records, int slot, int num_op, int H, int W) {
  __shared__ int lut[3][256];
  __shared__ int lo[3], hi[3];
  __shared__ unsigned long long gray_sum;

  const int HW = H * W;
  const size_t base = (size_t)blockIdx.x * HW * 3;
  const float* in = src + base;
  float* out = dst + base;
  const float* rec = records + ((size_t)blockIdx.x * num_op + slot) * kRec;
  const int op = (int)rec[0];
  const float v = rec[2];

  // every branch below is uniform across the block (one record per block),
  // so the __syncthreads() inside the reductions are reached by all threads
  if (!(rec[1] > 0.0f)) {  // gate off: the image passes through
    copy_image(in, out, 3 * HW);
    return;
  }
  switch (op) {
    case SHEAR_X: case SHEAR_Y: case TRANSLATE_X: case TRANSLATE_Y:
    case ROTATE: case TRANSLATE_X_ABS: case TRANSLATE_Y_ABS:
      warp_affine(in, out, rec + 3, H, W);
      break;
    case AUTO_CONTRAST:
      auto_contrast(in, out, HW, lo, hi);
      break;
    case INVERT:
      for (int i = threadIdx.x; i < 3 * HW; i += blockDim.x)
        out[i] = __fsub_rn(255.0f, clip255(in[i]));
      break;
    case EQUALIZE:
      equalize(in, out, HW, lut);
      break;
    case SOLARIZE:
      for (int i = threadIdx.x; i < 3 * HW; i += blockDim.x) {
        const float xc = clip255(in[i]);
        out[i] = xc < v ? xc : __fsub_rn(255.0f, xc);
      }
      break;
    case POSTERIZE: case POSTERIZE2: {
      const int shift = 8 - (int)truncf(v);
      const int mask = (shift >= 0 && shift < 32) ? (int)((0xFFu << shift) & 0xFFu) : 0;
      for (int i = threadIdx.x; i < 3 * HW; i += blockDim.x)
        out[i] = (float)(to_int(in[i]) & mask);
      break;
    }
    case CONTRAST:
      contrast(in, out, HW, v, &gray_sum);
      break;
    case COLOR:
      for (int p = threadIdx.x; p < HW; p += blockDim.x) {
        const float deg = (float)gray_u8(in + 3 * p);
        for (int c = 0; c < 3; ++c)
          out[3 * p + c] = blend(deg, clip255(in[3 * p + c]), v);
      }
      break;
    case BRIGHTNESS:
      for (int i = threadIdx.x; i < 3 * HW; i += blockDim.x)
        out[i] = blend(0.0f, clip255(in[i]), v);
      break;
    case SHARPNESS:
      sharpness(in, out, H, W, v);
      break;
    case CUTOUT: case CUTOUT_ABS: {
      if (!(rec[13] > 0.0f)) {
        copy_image(in, out, 3 * HW);
        break;
      }
      const float x0 = rec[9], y0 = rec[10], x1 = rec[11], y1 = rec[12];
      const float fill[3] = {125.0f, 123.0f, 114.0f};
      for (int p = threadIdx.x; p < HW; p += blockDim.x) {
        const int y = p / W, x = p - y * W;
        const bool inside = (float)x >= x0 && (float)x <= x1 &&
                            (float)y >= y0 && (float)y <= y1;
        for (int c = 0; c < 3; ++c) out[3 * p + c] = inside ? fill[c] : in[3 * p + c];
      }
      break;
    }
    default:  // op ids are validated on the host; never reached
      copy_image(in, out, 3 * HW);
  }
}

}  // namespace

extern "C" int faa_augment_slot(const float* src, float* dst, const float* records,
                                int slot, int num_op, int batch, int height,
                                int width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return 0;
  augment_slot_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      src, dst, records, slot, num_op, height, width);
  return (int)cudaGetLastError();
}

extern "C" const char* faa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
