/*
 * ImageNet train stack kernels for NVIDIA Hopper (sm_90a).
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
 * It reads uint8 or float32 (any value: the batch itself, or the
 * augmentation kernel's output) and writes float32 NHWC, the channels_last
 * layout the model's convolutions read.
 *
 * The only dependence across pixels is one integer per image: the grey sum
 * behind the contrast mean, taken over the image as it stands just before
 * contrast (after brightness and/or saturation when those come first).
 * Two kernels, chosen by the wrapper from the image's shape and dtype alone
 * (ops/_kernels.py imagenet_plan):
 *
 * imagenet_cluster_kernel -- one launch, the batch read once and written
 * once.  One thread-block cluster per image (one block when the image fits
 * one); each block owns a band of `rows` image rows (contiguous in NHWC)
 * and stages it into shared memory in the input's own dtype, with kStages
 * bulk copies (cp.async.bulk, each completing on its own mbarrier) so that
 * the threads start on the first rows while the last are in flight.  The
 * threads run the jitter ops that precede contrast on their pixels, write
 * the result back over the staged band (every op ends in an integer in
 * [0, 255], so it fits the band's dtype exactly) and sum its PIL 'L' grey.
 * The block's sum goes into a shared-memory field of its own; after a
 * cluster barrier every warp gathers all blocks' fields through distributed
 * shared memory (an integer sum: the order is free).  A second, split
 * cluster barrier (arrive here, wait before exit) keeps every block's
 * shared memory alive until no block reads it any more.  Then each warp
 * takes steps of kWarpPixels consecutive pixels, each lane every 32nd of
 * them (neighbouring lanes read and write neighbouring words of shared
 * memory): contrast and the ops after it, the scale, lighting,
 * normalization and cutout (the flip is a read within the row), into a
 * scratch of the warp's own, which the warp writes out as consecutive
 * 16-byte vectors, whole lines.  The drawn order is a template parameter,
 * so the per-pixel code carries no branch on it.
 *
 * grey_sum_kernel + imagenet_stack_kernel -- two launches, for images
 * whose band does not fit a block's shared memory even in clusters of 16:
 * a grey-sum pass over tiles of every image (int64 partial per tile), then
 * a per-pixel pass that first sums its image's partials.
 *
 * Bound: bytes.  The function reads the input once and writes the output
 * once (N*H*W*3 * (sizeof(in) + 4) bytes); the cluster kernel moves just
 * that, the two-pass kernels read the input twice.  About 30 float
 * operations per pixel, below the card's float32 rate; with the loads,
 * stores and indexing around them, the instructions each pixel needs are
 * a second limit beside the bytes at 224x224.
 *
 * Rounding: every product, difference and sum is an explicit
 * round-to-nearest intrinsic in the reference's order, and the file is
 * built with --fmad=false, so the compiler contracts no multiply-add.  The
 * trunc and clip that end each blend, the grey's integer conversions and
 * uint8 loads go through 2**23: for 0 <= y < 2**23, y + 2**23 rounded
 * toward zero is 2**23 + trunc(y), exactly, two full-rate float adds in
 * place of a quarter-rate conversion; the results equal truncf and casts
 * in value.  The contrast mean is trunc(float(sum) / (H*W) + 0.5) on the
 * exact integer grey sum, as in the augmentation kernel.
 */

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // the two-pass kernels
constexpr int kMaxThreads = 1024;  // imagenet_cluster_kernel
constexpr int kSumPixels = 1024;   // pixels per block of the grey-sum pass
constexpr int kStages = 4;         // bulk copies (and mbarriers) per band
constexpr int kHeaderBytes = 256;  // Header, before the staged band
constexpr int kWarpPixels = 128;   // pixels of a warp step of the chain
constexpr int kScratchPerThread = 48;  // the chain's per-warp scratch: kWarpPixels x 3 floats
static_assert(kScratchPerThread * 32 == kWarpPixels * 3 * 4, "scratch size");
constexpr int kMaxSmemBytes = 232448;
constexpr int kErrBadPlan = 100001;
constexpr int kErrNotResident = 100002;
constexpr int BRIGHTNESS = 0, CONTRAST = 1, SATURATION = 2;
constexpr float kMagic = 8388608.0f;  // 2**23
constexpr unsigned kMagicBits = 0x4B000000u;

// the branch table of _color_jitter (preprocess_imagenet.py:152)
__constant__ int kOrders[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                                  {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};

// the same table for template arguments
__host__ __device__ constexpr int order_op(int order, int j) {
  constexpr int t[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2}, {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};
  return t[order][j];
}

__host__ __device__ constexpr int contrast_pos(int order) {
  return order_op(order, 0) == CONTRAST ? 0 : (order_op(order, 1) == CONTRAST ? 1 : 2);
}

struct Norm {
  float scale;
  float mean[3];
  float rstd[3];
};

__device__ __forceinline__ float clip255(float x) {
  return fminf(fmaxf(x, 0.0f), 255.0f);
}

// 2**23 + trunc(y) as float bits, for y in [0, 255]: the low byte is trunc(y)
__device__ __forceinline__ unsigned u8_bits(float y) {
  return __float_as_uint(__fadd_rz(y, kMagic));
}

// PIL Image.blend's uint8 store of x: trunc, clip; clip first, then the
// magic-number trunc (the two orders agree in value)
__device__ __forceinline__ float store_u8(float x) {
  return __fsub_rn(__uint_as_float(u8_bits(clip255(x))), kMagic);
}

// PIL 'L' grey of one pixel whose channels are in [0, 255]: the weights sum
// to 65536, so the 2**23 bias of the three bit patterns vanishes mod 2**32
__device__ __forceinline__ unsigned grey(const float* v) {
  return (u8_bits(v[0]) * 19595u + u8_bits(v[1]) * 38470u + u8_bits(v[2]) * 7471u + 0x8000u) >>
         16;
}

__device__ __forceinline__ float u8_to_float(unsigned u) {
  return __fsub_rn(__uint_as_float(kMagicBits | u), kMagic);
}

// one pixel in, channels clipped to [0, 255] (uint8 is in range already;
// CLIP = false skips the clip of float32 values known to be in range)
template <bool CLIP>
__device__ __forceinline__ void load3(const uint8_t* p, float* v) {
  v[0] = u8_to_float(p[0]);
  v[1] = u8_to_float(p[1]);
  v[2] = u8_to_float(p[2]);
}

template <bool CLIP>
__device__ __forceinline__ void load3(const float* p, float* v) {
  for (int c = 0; c < 3; ++c) v[c] = CLIP ? clip255(p[c]) : p[c];
}

// write back a pixel of integers in [0, 255] in the staged dtype, exactly
__device__ __forceinline__ void store3(uint8_t* p, const float* v) {
  for (int c = 0; c < 3; ++c) p[c] = (uint8_t)(u8_bits(v[c]) & 0xFFu);
}

__device__ __forceinline__ void store3(float* p, const float* v) {
  for (int c = 0; c < 3; ++c) p[c] = v[c];
}

// one ColorJitter op on one pixel with channels in [0, 255]; `mean` is
// contrast's only.  Brightness's degenerate is 0, so 0 + (v - 0) * f is
// v * f in value.
template <int OP>
__device__ __forceinline__ void jitter(float* v, float f, float mean) {
  if constexpr (OP == BRIGHTNESS) {
    for (int c = 0; c < 3; ++c) v[c] = store_u8(__fmul_rn(v[c], f));
  } else {
    const float deg =
        OP == CONTRAST ? mean : __fsub_rn(__uint_as_float(kMagicBits + grey(v)), kMagic);
    for (int c = 0; c < 3; ++c) v[c] = store_u8(__fadd_rn(deg, __fmul_rn(__fsub_rn(v[c], deg), f)));
  }
}

__device__ __forceinline__ void jitter(int op, float* v, float f, float mean) {
  if (op == BRIGHTNESS) jitter<BRIGHTNESS>(v, f, mean);
  else if (op == CONTRAST) jitter<CONTRAST>(v, f, mean);
  else jitter<SATURATION>(v, f, mean);
}

// ((v * scale + rgb[c]) - mean[c]) * rstd[c], each operation rounded; 0 in the cutout box
__device__ __forceinline__ void normalize3(const float* v, const float* rgb, const Norm& nm,
                                           bool cut, float* o) {
  for (int c = 0; c < 3; ++c) {
    const float lit = __fadd_rn(__fmul_rn(v[c], nm.scale), rgb[c]);
    const float r = __fmul_rn(__fsub_rn(lit, nm.mean[c]), nm.rstd[c]);
    o[c] = cut ? 0.0f : r;
  }
}

__device__ __forceinline__ float contrast_mean(unsigned long long sum, int HW) {
  return truncf(__fadd_rn(__fdiv_rn(__ull2float_rn(sum), (float)HW), 0.5f));
}

// ------------------------------------------------------ two-pass kernels

template <typename T>
__global__ void __launch_bounds__(kThreads)
grey_sum_kernel(const T* __restrict__ in, const int* __restrict__ ints,
                const float* __restrict__ floats, long long* __restrict__ partial,
                int HW, int tiles) {
  const int n = blockIdx.y, tile = blockIdx.x;
  const int order = ints[4 * n + 1];
  const float* f = floats + 6 * n;
  unsigned local = 0;
  for (int k = 0; k < kSumPixels / kThreads; ++k) {
    const int p = tile * kSumPixels + k * kThreads + threadIdx.x;
    if (p >= HW) break;
    float v[3];
    load3<true>(in + ((long long)n * HW + p) * 3, v);
    for (int j = 0; j < 3; ++j) {  // the ops before contrast, in order
      const int op = kOrders[order][j];
      if (op == CONTRAST) break;
      jitter(op, v, f[op], 0.0f);
    }
    local += grey(v);
  }
  local = __reduce_add_sync(0xffffffffu, local);
  __shared__ unsigned warp_sums[kThreads / 32];
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
    if (threadIdx.x == 0) mean_s = contrast_mean((unsigned long long)s, HW);
  }
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int* d = ints + 4 * n;
  const int flip = d[0], order = d[1], cy = d[2], cx = d[3];
  const float* f = floats + 6 * n;
  const int y = p / W, x = p - y * W;
  const int xs = flip ? W - 1 - x : x;
  float v[3];
  load3<true>(in + ((long long)n * HW + (long long)y * W + xs) * 3, v);
  for (int j = 0; j < 3; ++j) {
    const int op = kOrders[order][j];
    jitter(op, v, f[op], mean_s);
  }
  const bool cut = y >= cy - half && y < cy + half && x >= cx - half && x < cx + half;
  normalize3(v, f + 3, norm, cut, out + ((long long)n * HW + p) * 3);
}

// ------------------------------------------------ imagenet_cluster_kernel

struct Header {
  unsigned long long bar[kStages];  // mbarriers of the staging copies
  unsigned partial;                 // this block's grey sum
  unsigned warp_sums[kMaxThreads / 32];
};
static_assert(sizeof(Header) <= kHeaderBytes, "header outgrew its reservation");

// bytes of shared memory up to the end of the band: the header and a band of
// `rows` rows in the input's dtype, padded to 16 bytes with 16 more of slack
// so that the band can start at the same address mod 16 as its rows in HBM
__host__ __device__ __forceinline__ long long band_end(int rows, int W, int esize) {
  return kHeaderBytes + (((long long)rows * W * 3 * esize + 15) & ~15ll) + 16;
}

// dynamic shared memory of one block: the band of ceil(H / C) rows, then
// each warp's scratch (kScratchPerThread bytes a thread)
__host__ __device__ __forceinline__ long long cluster_smem_bytes(int H, int W, int esize, int C,
                                                                 int threads) {
  return band_end((H + C - 1) / C, W, esize) + (long long)kScratchPerThread * threads;
}

template <typename T>
struct Band {
  T* buf;                // the staged band in shared memory
  float* out;            // the band's first output element
  int W, r0, npix;
  int ready[kStages];    // pixels complete once stages 0..k have landed
};

// one image's draws, as every thread of its cluster uses them
struct Img {
  int flip, y0, y1, x0, x1;  // the cutout box [y0, y1) x [x0, x1)
  float f[3], rgb[3];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  // labels inside a { } block are local to it, so every inlined copy may reuse them
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}"
      :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Start copying n bytes from global `src` to shared `dst`, which lie at the
// same address modulo 16: the aligned body in kStages bulk copies, one per
// mbarrier, the head and tail by the threads.  Ends with the block
// synchronised and `ready` set; the caller waits on each stage's mbarrier
// before it reads that stage's pixels.
__device__ __forceinline__ void stage_band(unsigned char* dst, const unsigned char* src, int n,
                                           Header& hd, int pixel_bytes, int npix,
                                           int* ready) {
  const int head = min(n, (int)((16u - ((uintptr_t)src & 15u)) & 15u));
  const int body = (n - head) & ~15;
  const int piece = ((body / 16 + kStages - 1) / kStages) * 16;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&hd.bar[k]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) {
      const uint32_t b = smem_addr(&hd.bar[k]);
      const int lo = k * piece, size = max(0, min(piece, body - lo));
      if (size > 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(b), "r"(size) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];"
            :: "r"(smem_addr(dst + head + lo)),
               "l"((unsigned long long)(src + head + lo)), "r"(size), "r"(b)
            : "memory");
      } else {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(b) : "memory");
      }
    }
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int i = head + body + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();  // the head and tail are in
  for (int k = 0; k < kStages; ++k)
    ready[k] = k == kStages - 1 ? npix
                                : min(npix, (head + min(body, (k + 1) * piece)) / pixel_bytes);
}

// the ops before contrast on every pixel of the band, written back in
// place, and this thread's share of the grey sum of the result; each stage
// is read once its bulk copy has landed
template <typename T, int ORDER>
__device__ __forceinline__ unsigned grey_phase(const Band<T>& b, const Img& im,
                                               const Header& hd) {
  constexpr int jc = contrast_pos(ORDER);
  unsigned sum = 0;
  int p = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    mbar_wait(smem_addr(&hd.bar[k]), 0);
    for (const int end = b.ready[k]; p < end; p += blockDim.x) {
      T* px = b.buf + 3 * p;
      float v[3];
      load3<true>(px, v);
      if constexpr (jc > 0) jitter<order_op(ORDER, 0)>(v, im.f[order_op(ORDER, 0)], 0.0f);
      if constexpr (jc > 1) jitter<order_op(ORDER, 1)>(v, im.f[order_op(ORDER, 1)], 0.0f);
      sum += grey(v);
      if constexpr (jc > 0) store3(px, v);
    }
  }
  return sum;
}

// output pixel (band row ly, column x): its source pixel (the flip reads
// within the row), contrast and the ops after it, scale, lighting,
// normalization, cutout
template <typename T, int ORDER>
__device__ __forceinline__ void pixel_out(const Band<T>& b, const Img& im, const Norm& nm,
                                          float mean, int ly, int x, float* o) {
  constexpr int jc = contrast_pos(ORDER);
  const int xs = im.flip ? b.W - 1 - x : x;
  float v[3];
  load3<jc == 0>(b.buf + 3 * (ly * b.W + xs), v);  // jc > 0: written back in range
  jitter<CONTRAST>(v, im.f[CONTRAST], mean);
  if constexpr (jc < 1) jitter<order_op(ORDER, 1)>(v, im.f[order_op(ORDER, 1)], 0.0f);
  if constexpr (jc < 2) jitter<order_op(ORDER, 2)>(v, im.f[order_op(ORDER, 2)], 0.0f);
  const int y = b.r0 + ly;
  normalize3(v, im.rgb, nm, y >= im.y0 && y < im.y1 && x >= im.x0 && x < im.x1, o);
}

// contrast and the rest for every pixel of the band, written out through
// the warp's scratch of kWarpPixels pixels: each warp step computes
// kWarpPixels consecutive pixels, lane l taking pixels l, l + 32, l + 64, ...
// of them (so that neighbouring lanes read and write neighbouring words of
// shared memory), and stores their floats as consecutive 16-byte vectors.
// Steps start at pixel pa, the first whose output begins on a 16-byte
// boundary (every fourth pixel after it does too); pixels [0, pa) are stored
// one float at a time.
template <typename T, int ORDER>
__device__ __forceinline__ void chain_phase(const Band<T>& b, const Img& im, const Norm& nm,
                                            float mean, float* scratch) {
  constexpr int kSub = kWarpPixels / 32;  // pixels a lane a step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sc = scratch + 3 * kWarpPixels * warp;
  const int pa = min(b.npix, (int)(((uintptr_t)b.out >> 2) & 3u));
  const int step = kWarpPixels * (blockDim.x >> 5);  // pixels a block step
  const int dly = step / b.W, dx = step - dly * b.W;
  const int sly = 32 / b.W, sx = 32 - sly * b.W;  // from one of a lane's pixels to the next
  int p = pa + kWarpPixels * warp + lane;
  int ly = p / b.W, x = p - ly * b.W;
  for (int base = pa + kWarpPixels * warp; base < b.npix; base += step) {
    int qy = ly, qx = x;
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      if (p + 32 * k < b.npix)
        pixel_out<T, ORDER>(b, im, nm, mean, qy, qx, sc + 3 * (lane + 32 * k));
      qy += sly;
      qx += sx;
      if (qx >= b.W) { qx -= b.W; ++qy; }
    }
    __syncwarp();
    const int n = 3 * min(kWarpPixels, b.npix - base);  // floats of this step
    float* o = b.out + 3 * base;
#pragma unroll
    for (int j = 0; j < 3 * kSub / 4; ++j) {
      const int v = lane + 32 * j;
      if (4 * v + 3 < n) {
        const float4 r = reinterpret_cast<const float4*>(sc)[v];
        // uint8 input: streaming stores, measured faster; float32: plain
        if constexpr (sizeof(T) == 1) __stcs(reinterpret_cast<float4*>(o) + v, r);
        else reinterpret_cast<float4*>(o)[v] = r;
      } else {
        for (int e = 4 * v; e < n && e < 4 * v + 4; ++e) o[e] = sc[e];
      }
    }
    __syncwarp();  // the scratch is read before the next step writes it
    p += step;
    x += dx;
    ly += dly;
    if (x >= b.W) { x -= b.W; ++ly; }
  }
  if ((int)threadIdx.x < pa) {
    float r[3];
    const int q = threadIdx.x;
    pixel_out<T, ORDER>(b, im, nm, mean, q / b.W, q % b.W, r);
    for (int c = 0; c < 3; ++c) b.out[3 * q + c] = r[c];
  }
}

template <typename T, int ORDER>
__device__ __forceinline__ void run_band(const Band<T>& b, const Img& im, const Norm& nm,
                                         Header& hd, float* scratch, int C, int HW) {
  const unsigned sum = __reduce_add_sync(0xffffffffu, grey_phase<T, ORDER>(b, im, hd));
  if ((threadIdx.x & 31) == 0) hd.warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  // a band holds under 2**18 pixels and an image under 2**24, so the sums
  // fit 32 bits
  const unsigned lane = threadIdx.x & 31;
  unsigned total = 0;
  for (unsigned w = lane; w < blockDim.x / 32; w += 32) total += hd.warp_sums[w];
  total = __reduce_add_sync(0xffffffffu, total);
  if (C > 1) {
    if (threadIdx.x == 0) hd.partial = total;
    cluster_arrive();
    cluster_wait();  // every block's partial is in
    const unsigned part =
        lane < (unsigned)C ? *cg::this_cluster().map_shared_rank(&hd.partial, lane) : 0u;
    total = __reduce_add_sync(0xffffffffu, part);
    cluster_arrive();  // this block reads no other block's shared memory after this
  }
  chain_phase<T, ORDER>(b, im, nm, contrast_mean(total, HW), scratch);
  if (C > 1) cluster_wait();  // no block exits while another may still read its partial
}

// one cluster of C blocks per image (grid N * C); block `rank` owns image
// rows [rank * rows, (rank + 1) * rows).  The switch on the order is uniform
// across the cluster, so every block reaches every barrier.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
imagenet_cluster_kernel(const T* __restrict__ in, float* __restrict__ out,
                        const int* __restrict__ ints, const float* __restrict__ floats, int H,
                        int W, int rows, int C, int half, Norm norm) {
  extern __shared__ __align__(16) unsigned char smem[];
  Header& hd = *reinterpret_cast<Header*>(smem);
  const int rank = C == 1 ? 0 : (int)cg::this_cluster().block_rank();
  const int n = blockIdx.x / C;
  Band<T> b;
  b.W = W;
  b.r0 = rank * rows;
  b.npix = max(0, min(H, b.r0 + rows) - b.r0) * W;
  const size_t first = ((size_t)n * H + b.r0) * W * 3;
  const T* src = in + first;
  b.out = out + first;
  b.buf = reinterpret_cast<T*>(smem + kHeaderBytes + ((uintptr_t)src & 15u));
  float* scratch = reinterpret_cast<float*>(smem + band_end(rows, W, (int)sizeof(T)));
  stage_band(reinterpret_cast<unsigned char*>(b.buf), reinterpret_cast<const unsigned char*>(src),
             3 * b.npix * (int)sizeof(T), hd, 3 * (int)sizeof(T), b.npix, b.ready);
  const int* d = ints + 4 * n;
  Img im;
  im.flip = d[0];
  im.y0 = d[2] - half;
  im.y1 = d[2] + half;
  im.x0 = d[3] - half;
  im.x1 = d[3] + half;
  for (int c = 0; c < 3; ++c) {
    im.f[c] = floats[6 * n + c];
    im.rgb[c] = floats[6 * n + 3 + c];
  }
  const int HW = H * W;
  switch (d[1]) {  // orders outside [0, 6) come from no sampler; they take order 5
    case 0: run_band<T, 0>(b, im, norm, hd, scratch, C, HW); break;
    case 1: run_band<T, 1>(b, im, norm, hd, scratch, C, HW); break;
    case 2: run_band<T, 2>(b, im, norm, hd, scratch, C, HW); break;
    case 3: run_band<T, 3>(b, im, norm, hd, scratch, C, HW); break;
    case 4: run_band<T, 4>(b, im, norm, hd, scratch, C, HW); break;
    default: run_band<T, 5>(b, im, norm, hd, scratch, C, HW); break;
  }
}

bool valid_plan(int height, int width, int esize, int cluster, int smem_bytes, int threads,
                int device) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16) &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 && height >= 1 &&
         width >= 1 && smem_bytes <= kMaxSmemBytes &&
         smem_bytes == cluster_smem_bytes(height, width, esize, cluster, threads) &&
         device >= 0 &&
         device < 64;
}

int g_smem_set[2][64];  // dynamic shared memory allowed so far, per dtype and device

// clusters resident at once under the last plan checked, per dtype and device
struct Resident {
  int cluster, smem_bytes, threads, active;
};
Resident g_resident[2][64];

// set the current device, allow the kernel `smem_bytes` of dynamic shared
// memory and clusters of 16, and describe a launch of `blocks` blocks
template <typename T>
cudaError_t prepare(int device, int smem_bytes, int cluster, int threads, unsigned blocks,
                    cudaStream_t stream, cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int& set = g_smem_set[sizeof(T) == 1][device];
  if (smem_bytes > set) {
    err = cudaFuncSetAttribute(imagenet_cluster_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(imagenet_cluster_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    set = smem_bytes;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem_bytes;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int launch_cluster(const void* src, float* dst, const int* ints, const float* floats, int batch,
                   int H, int W, int half, const Norm& norm, int cluster, int smem_bytes,
                   int threads, int device, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = prepare<T>(device, smem_bytes, cluster, threads, (unsigned)batch * cluster,
                               stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 1) {
    Resident& r = g_resident[sizeof(T) == 1][device];
    if (r.cluster != cluster || r.smem_bytes != smem_bytes || r.threads != threads) {
      int active = 0;
      err = cudaOccupancyMaxActiveClusters(&active, imagenet_cluster_kernel<T>, &cfg);
      if (err != cudaSuccess) return (int)err;
      r = {cluster, smem_bytes, threads, active};
    }
    if (r.active < 1) return kErrNotResident;
  } else {
    cfg.numAttrs = 0;  // one block per image: an ordinary launch
  }
  const int rows = (H + cluster - 1) / cluster;
  err = cudaLaunchKernelEx(&cfg, imagenet_cluster_kernel<T>, static_cast<const T*>(src), dst,
                           ints, floats, H, W, rows, cluster, half, norm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_two_pass(const void* src, float* dst, const int* ints, const float* floats,
                    long long* partial, int batch, int H, int W, int half, const Norm& norm,
                    cudaStream_t stream) {
  const T* in = static_cast<const T*>(src);
  const int HW = H * W;
  const int tiles = (HW + kSumPixels - 1) / kSumPixels;
  grey_sum_kernel<T><<<dim3(tiles, batch), kThreads, 0, stream>>>(in, ints, floats, partial,
                                                                  HW, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (HW + kThreads - 1) / kThreads;
  imagenet_stack_kernel<T><<<dim3(blocks, batch), kThreads, 0, stream>>>(
      in, dst, ints, floats, partial, H, W, tiles, half, norm);
  return (int)cudaGetLastError();
}

}  // namespace

// tiles of the two-pass path's partial-sum buffer, which the caller
// allocates: [batch, tiles] int64
extern "C" int faa_imagenet_tiles(int height, int width) {
  return (height * width + kSumPixels - 1) / kSumPixels;
}

// One call of the stack as the wrapper's plan says: cluster > 0 is the
// cluster kernel with clusters of `cluster` blocks of `threads` threads and
// `smem_bytes` of dynamic shared memory (a plan that does not match the
// kernel's layout returns kErrBadPlan, a cluster that cannot be resident
// kErrNotResident); cluster == 0 the two-pass kernels over `partial`.
extern "C" int faa_imagenet_stack(const void* src, int src_is_u8, float* dst, const int* ints,
                                  const float* floats, long long* partial, int batch,
                                  int height, int width, int half, float scale, float m0,
                                  float m1, float m2, float r0, float r1, float r2,
                                  int cluster, int smem_bytes, int threads, int device,
                                  void* stream) {
  const Norm norm = {scale, {m0, m1, m2}, {r0, r1, r2}};
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster > 0) {
    if (!valid_plan(height, width, src_is_u8 ? 1 : 4, cluster, smem_bytes, threads, device))
      return kErrBadPlan;
    if (batch <= 0) return 0;
    return src_is_u8 ? launch_cluster<uint8_t>(src, dst, ints, floats, batch, height, width,
                                                half, norm, cluster, smem_bytes, threads,
                                                device, s)
                     : launch_cluster<float>(src, dst, ints, floats, batch, height, width,
                                             half, norm, cluster, smem_bytes, threads, device,
                                             s);
  }
  if (cluster < 0 || partial == nullptr || height < 1 || width < 1) return kErrBadPlan;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;  // gridDim.y
  return src_is_u8 ? launch_two_pass<uint8_t>(src, dst, ints, floats, partial, batch, height,
                                              width, half, norm, s)
                   : launch_two_pass<float>(src, dst, ints, floats, partial, batch, height,
                                            width, half, norm, s);
}

// Clusters of the plan that the device holds at once (0: the launch would be
// refused).
extern "C" int faa_imagenet_max_active_clusters(int src_is_u8, int height, int width,
                                                int cluster, int smem_bytes, int threads,
                                                int device, int* active) {
  *active = 0;
  if (!valid_plan(height, width, src_is_u8 ? 1 : 4, cluster, smem_bytes, threads, device))
    return kErrBadPlan;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err =
      src_is_u8 ? prepare<uint8_t>(device, smem_bytes, cluster, threads, cluster * 1024u,
                                   nullptr, &attr, &cfg)
                : prepare<float>(device, smem_bytes, cluster, threads, cluster * 1024u, nullptr,
                                 &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  return (int)(src_is_u8
                   ? cudaOccupancyMaxActiveClusters(active, imagenet_cluster_kernel<uint8_t>, &cfg)
                   : cudaOccupancyMaxActiveClusters(active, imagenet_cluster_kernel<float>, &cfg));
}

extern "C" const char* faa_error_string(int code) {
  if (code == kErrBadPlan)
    return "the launch plan does not match the ImageNet stack kernel's layout "
           "(cluster size, threads or dynamic shared memory)";
  if (code == kErrNotResident)
    return "no cluster of the planned size and shared memory can be resident "
           "on this device";
  return cudaGetErrorString((cudaError_t)code);
}
