/*
 * CIFAR train/eval stack kernel for NVIDIA Hopper (sm_90a).
 *
 * Replaces fast_autoaugment_tpu/ops/preprocess.py:109 cifar_train_batch
 * after the policy (random_crop_with_pad :58, random_hflip :69,
 * normalize :51, cutout_default :73) and :145 cifar_eval_batch (the same
 * kernel with the crop centred, no flip and no cutout).  XLA fuses these
 * into one elementwise pass over the batch; so does this kernel.
 *
 * One thread per output element (image n, row y, column x, channel c), in
 * NHWC order, so neighbouring threads write neighbouring addresses and the
 * output is the channels_last layout the model's convolutions read.  Per
 * image the thread reads its draws (oy, ox, flip, cy, cx) from an [N, 5]
 * int32 tensor and computes:
 *
 *   1. xs = W-1-x when the flip bit is set, else x (the flip follows the
 *      crop, preprocess.py:101-102);
 *   2. the source pixel (y + oy - pad, xs + ox - pad), or 0 outside the
 *      image -- the zero fill is *before* normalization, so a pad pixel
 *      comes out as -mean/std;
 *   3. (v * scale - mean[c]) * rstd[c] with scale = 1/255 and rstd = 1/std
 *      as float32, each product and difference rounded on its own: the
 *      form XLA compiles `(img / 255 - mean) / std` into (a multiplication
 *      by reciprocals), which the CPU reference matches bitwise;
 *   4. 0 where |y - cy| and |x - cx| both fall in the half-open box
 *      [c - half, c + half) on the output coordinates (after the flip),
 *      clipped at the borders by construction; half = 0 zeroes nothing.
 *
 * Bound: bytes.  Each output element reads one input element (a gather
 * within the image, served by L1/L2) and its image's 20 bytes of draws,
 * and does three float operations: 2 x N*H*W*3*4 bytes move, far below
 * the card's float32 rate.  Built with --fmad=false: a contracted
 * multiply-add would round (v * scale - mean) once instead of twice.
 */

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Norm {
  float scale;
  float mean[3];
  float rstd[3];
};

__global__ void __launch_bounds__(kThreads)
cifar_stack_kernel(const float* __restrict__ in, float* __restrict__ out,
                   const int* __restrict__ draws, long long total, int H,
                   int W, int pad, int half, Norm norm) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % 3);
  const long long p = i / 3;
  const int x = (int)(p % W);
  const long long q = p / W;
  const int y = (int)(q % H);
  const long long n = q / H;
  const int* d = draws + 5 * n;
  const int oy = d[0], ox = d[1], flip = d[2], cy = d[3], cx = d[4];
  const int xs = flip ? W - 1 - x : x;
  const int sy = y + oy - pad, sx = xs + ox - pad;
  float v = 0.0f;
  if (sy >= 0 && sy < H && sx >= 0 && sx < W)
    v = in[((n * H + sy) * W + sx) * 3 + c];
  float r = __fmul_rn(__fsub_rn(__fmul_rn(v, norm.scale), norm.mean[c]),
                      norm.rstd[c]);
  if (y >= cy - half && y < cy + half && x >= cx - half && x < cx + half)
    r = 0.0f;
  out[i] = r;
}

}  // namespace

extern "C" int faa_cifar_stack(const float* src, float* dst, const int* draws,
                               int batch, int height, int width, int pad,
                               int half, float scale, float m0, float m1,
                               float m2, float r0, float r1, float r2,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return 0;
  const long long total = (long long)batch * height * width * 3;
  const Norm norm = {scale, {m0, m1, m2}, {r0, r1, r2}};
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cifar_stack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      src, dst, draws, total, height, width, pad, half, norm);
  return (int)cudaGetLastError();
}

extern "C" const char* faa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
