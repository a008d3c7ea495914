/*
 * CIFAR train/eval stack kernel for NVIDIA Hopper (sm_90a).
 *
 * Replaces fast_autoaugment_tpu/ops/preprocess.py:109 cifar_train_batch
 * after the policy (random_crop_with_pad :58, random_hflip :69,
 * normalize :51, cutout_default :73) and :145 cifar_eval_batch (the same
 * kernel with the crop centred, no flip and no cutout).  XLA fuses these
 * into one elementwise pass over the batch; so does this kernel.
 *
 * One block per image.  The block reads its image's draws (oy, ox, flip,
 * cy, cx) from an [N, 5] int32 tensor once, stages the source image into
 * shared memory with one bulk copy (cp.async.bulk, completing on an
 * mbarrier; a 32x32 image is 12 KB), and writes the output in NHWC order,
 * the channels_last layout the model's convolutions read, each thread whole
 * 16-byte float4 vectors.  An output element (y, x, c) is:
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
 * Index arithmetic is 32-bit: one division by 3 (a multiply) and one by W
 * per vector, the next three elements by counting.  An image that does not
 * fit in the 48 KB of shared memory a block gets without opting in (the
 * wrapper decides by shape, ops/_kernels.py cifar_plan) is read from global
 * memory by the same code.
 *
 * Bound: bytes.  Each output element reads one input element and does three
 * float operations: 2 x N*H*W*3*4 bytes move, far below the card's float32
 * rate.  Built with --fmad=false: a contracted multiply-add would round
 * (v * scale - mean) once instead of twice.
 */

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeaderBytes = 64;  // mbarrier and the draws, before the image
constexpr int kMaxSmemBytes = 48 * 1024;
constexpr int kErrBadPlan = 100001;

struct Norm {
  float scale;
  float mean[3];
  float rstd[3];
};

struct Draws {
  int oy, ox, flip, cy, cx;
};

// an output element's place in its image
struct Pos {
  int y, x, c;
};

__device__ __forceinline__ Pos pos_of(unsigned e, unsigned W) {
  const unsigned q = e / 3u, y = q / W;
  return {(int)y, (int)(q - y * W), (int)(e - 3u * q)};
}

__device__ __forceinline__ void advance(Pos& p, int W) {
  if (++p.c == 3) {
    p.c = 0;
    if (++p.x == W) { p.x = 0; ++p.y; }
  }
}

__device__ __forceinline__ float stack_value(const float* img, Pos p, int H, int W,
                                             int pad, int half, const Draws& d,
                                             const Norm& norm) {
  const int xs = d.flip ? W - 1 - p.x : p.x;
  const int sy = p.y + d.oy - pad, sx = xs + d.ox - pad;
  float v = 0.0f;
  if (sy >= 0 && sy < H && sx >= 0 && sx < W) v = img[(sy * W + sx) * 3 + p.c];
  // selects, not an index: an indexed parameter array would go to the stack
  const float mean = p.c == 0 ? norm.mean[0] : (p.c == 1 ? norm.mean[1] : norm.mean[2]);
  const float rstd = p.c == 0 ? norm.rstd[0] : (p.c == 1 ? norm.rstd[1] : norm.rstd[2]);
  const float r = __fmul_rn(__fsub_rn(__fmul_rn(v, norm.scale), mean), rstd);
  const bool cut = p.y >= d.cy - half && p.y < d.cy + half && p.x >= d.cx - half &&
                   p.x < d.cx + half;
  return cut ? 0.0f : r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// copy n floats from global `src` to shared `dst`, which lie at the same
// address modulo 16: the aligned body in one bulk copy, head and tail by the
// threads.  Ends with the block synchronised.
__device__ void stage(float* dst, const float* src, int n, unsigned long long* bar) {
  const int head = min(n, (int)(((16u - ((uintptr_t)src & 15u)) & 15u) >> 2));
  const int body = (n - head) & ~3;
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (body > 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(b), "r"(body * 4) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          :: "r"(smem_addr(dst + head)), "l"((unsigned long long)(src + head)),
             "r"(body * 4), "r"(b)
          : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(b) : "memory");
    }
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int i = head + body + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  // labels inside a { } block are local to it, so every inlined copy may reuse them
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}"
      :: "r"(b) : "memory");
  __syncthreads();
}

__host__ __device__ __forceinline__ int staged_floats(int H, int W) {
  return ((H * W * 3 + 3) & ~3) + 4;  // the image, plus slack to match alignment
}

__global__ void __launch_bounds__(kThreads)
cifar_stack_kernel(const float* __restrict__ in, float* __restrict__ out,
                   const int* __restrict__ draws, int H, int W, int pad, int half,
                   int staged, Norm norm) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  int* sd = reinterpret_cast<int*>(smem + 16);
  const int n3 = H * W * 3;
  const float* img = in + (size_t)blockIdx.x * n3;
  if (threadIdx.x < 5) sd[threadIdx.x] = draws[5 * blockIdx.x + threadIdx.x];
  const float* src = img;
  if (staged) {
    float* buf = reinterpret_cast<float*>(smem + kHeaderBytes) +
                 (((uintptr_t)img >> 2) & 3u);
    stage(buf, img, n3, bar);
    src = buf;
  } else {
    __syncthreads();
  }
  const Draws d = {sd[0], sd[1], sd[2], sd[3], sd[4]};
  float* o = out + (size_t)blockIdx.x * n3;
  const int head = min(n3, (int)(((16u - ((uintptr_t)o & 15u)) & 15u) >> 2));
  const int nv = (n3 - head) >> 2;
  float4* o4 = reinterpret_cast<float4*>(o + head);
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    Pos p = pos_of((unsigned)(head + 4 * v), (unsigned)W);
    float4 r;
    r.x = stack_value(src, p, H, W, pad, half, d, norm);
    advance(p, W);
    r.y = stack_value(src, p, H, W, pad, half, d, norm);
    advance(p, W);
    r.z = stack_value(src, p, H, W, pad, half, d, norm);
    advance(p, W);
    r.w = stack_value(src, p, H, W, pad, half, d, norm);
    o4[v] = r;
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    o[i] = stack_value(src, pos_of((unsigned)i, (unsigned)W), H, W, pad, half, d, norm);
  for (int i = head + 4 * nv + threadIdx.x; i < n3; i += blockDim.x)
    o[i] = stack_value(src, pos_of((unsigned)i, (unsigned)W), H, W, pad, half, d, norm);
}

}  // namespace

// `staged` and `smem_bytes` are the wrapper's plan: staged with
// kHeaderBytes + 4 * staged_floats(H, W) bytes, or unstaged with
// kHeaderBytes; any other pair returns kErrBadPlan.
extern "C" int faa_cifar_stack(const float* src, float* dst, const int* draws,
                               int batch, int height, int width, int pad,
                               int half, float scale, float m0, float m1,
                               float m2, float r0, float r1, float r2,
                               int staged, int smem_bytes, int device, void* stream) {
  const long long want = staged ? kHeaderBytes + 4ll * staged_floats(height, width)
                                : kHeaderBytes;
  if (height < 1 || width < 1 || smem_bytes != want || smem_bytes > kMaxSmemBytes ||
      device < 0)
    return kErrBadPlan;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return 0;
  const Norm norm = {scale, {m0, m1, m2}, {r0, r1, r2}};
  cifar_stack_kernel<<<batch, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      src, dst, draws, height, width, pad, half, staged, norm);
  return (int)cudaGetLastError();
}

extern "C" const char* faa_error_string(int code) {
  if (code == kErrBadPlan)
    return "the launch plan does not match the CIFAR stack kernel's layout "
           "(staging or dynamic shared memory)";
  return cudaGetErrorString((cudaError_t)code);
}
