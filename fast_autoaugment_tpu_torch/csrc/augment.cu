/*
 * Policy augmentation kernels for NVIDIA Hopper (sm_90a).
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
 * The kernels take the policy application's own inputs: the policy
 * [num_sub, num_op, 3], each image's sub-policy index and its draws
 * [num_op, 4] (gate, mirror, cutout x, cutout y), and the ops' range tables.
 * Each block builds the record of a slot (op id, gate, value, 2x3 affine
 * map, cutout box) in shared memory before it runs the slot (slot_record:
 * one thread a record, those of the first three slots side by side while
 * the image is staged), exactly as
 * fast_autoaugment_tpu_torch/ops/augment.py slot_records() does in PyTorch
 * for the plain version; a gated-off slot leaves the image as it is.  A
 * sub-policy index or an op id out of range prints and traps.
 *
 * Bound: bytes.  A call reads the batch once and writes it once,
 * 2*B*H*W*3*4 bytes, plus 4 bytes of sub-policy index and 16 of draws per
 * (image, slot), the policy and the tables; the arithmetic is a few dozen float
 * ops per pixel, far below the card's rate.  Two kernels, chosen by the
 * wrapper from the image's shape alone (ops/_kernels.py augment_plan):
 *
 * augment_kernel -- every op slot in one launch, the image held in shared
 * memory.  One thread-block cluster per image; each block of the cluster
 * owns a band of `rows` image rows (contiguous in NHWC), stages it with
 * one bulk copy (cp.async.bulk, completing on an mbarrier) into one of two
 * float32 band buffers, and the slots ping-pong between the two buffers
 * on chip.  Only the last slot's result goes back to global memory, in
 * 16-byte stores.  So the batch crosses HBM twice whatever the number of
 * slots.  Pointwise ops (Invert, Solarize, Posterize, Brightness, Color,
 * Cutout) work on the block's own band; the affine warps gather each source
 * pixel from the block that holds its row, and Sharpness its halo rows,
 * through distributed shared memory; AutoContrast (min/max), Equalize
 * (3x256 histogram) and Contrast (grey sum) reduce in each block, then
 * across the cluster, and every block applies the same result.  Slots are
 * separated by a cluster barrier.  At 32x32 the cluster is one block (two
 * 12 KB buffers, several blocks per SM); at 224x224 it is 8 or 16 blocks.
 *
 * augment_slot_kernel -- one launch per op slot, one block per image, every
 * pixel read from and written to global memory: the path for images whose
 * bands do not fit the largest cluster's shared memory.
 *
 * Equalize's LUT is an exclusive scan by one warp per channel, with PIL's
 * integer rule.
 *
 * Rounding: the ops are held bitwise against PIL-exact references, so
 * every float multiply and add is an explicit round-to-nearest intrinsic
 * in the reference's order, and the file is built with --fmad=false so that
 * the compiler contracts no multiply-add into a fused one.  Staging is
 * float32, so the kernels take every input the plain version takes.
 */

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // augment_slot_kernel
constexpr int kMaxThreads = 512;  // augment_kernel
constexpr int kRec = 16;          // floats per (image, slot) record
constexpr int kNumOps = 19;
constexpr int kRecords = 3;       // slot records augment_kernel builds before its first slot
// f32(pi / 180): torch rounds the double scalar of v * (np.pi / 180.0) once
constexpr float kDegToRad = (float)(3.14159265358979323846 / 180.0);
constexpr int kScratchBytes = 6400;
constexpr int kMaxSmemBytes = 232448;
constexpr int kErrBadPlan = 100001;
constexpr int kErrNotResident = 100002;

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

__device__ __forceinline__ int posterize_mask(float v) {
  const int shift = 8 - (int)truncf(v);
  return (shift >= 0 && shift < 32) ? (int)((0xFFu << shift) & 0xFFu) : 0;
}

// inverse affine map: src = floor(A (x+.5, y+.5) + t); false outside the image
__device__ __forceinline__ bool warp_source(const float* m, int x, int y, int H,
                                            int W, int* sx, int* sy) {
  const float xs = __fadd_rn((float)x, 0.5f), ys = __fadd_rn((float)y, 0.5f);
  const float fx = floorf(__fadd_rn(__fadd_rn(__fmul_rn(m[0], xs),
                                              __fmul_rn(m[1], ys)), m[2]));
  const float fy = floorf(__fadd_rn(__fadd_rn(__fmul_rn(m[3], xs),
                                              __fmul_rn(m[4], ys)), m[5]));
  if (!(fx >= 0.0f && fx < (float)W && fy >= 0.0f && fy < (float)H)) return false;
  *sx = (int)fx;
  *sy = (int)fy;
  return true;
}

__device__ __forceinline__ float autocontrast_value(int v, int lo, int hi) {
  return (float)((hi <= lo) ? v : min(max((v - lo) * 255 / max(hi - lo, 1), 0), 255));
}

// PIL equalize's LUT from one channel's 256-bin histogram, in place, by one
// whole warp: step = (total - hist[last]) / 255, lut = (step/2 + csum) / step
// with csum the exclusive prefix sum; the identity when at most one bin is
// used or step is 0.  Integer arithmetic, so the order of the sums is free.
__device__ void equalize_lut(int* h) {
  const int lane = threadIdx.x & 31;
  int v[8], sum = 0, nonzero = 0, last = -1;
  for (int j = 0; j < 8; ++j) {
    v[j] = h[lane * 8 + j];
    sum += v[j];
    if (v[j] > 0) { ++nonzero; last = lane * 8 + j; }
  }
  int total = sum, incl = sum;
  for (int o = 16; o > 0; o >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, o);
    nonzero += __shfl_xor_sync(0xffffffffu, nonzero, o);
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  }
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  const int hlast = last >= 0 ? h[last] : 0;
  __syncwarp();  // every lane has read h before any lane writes it
  const int step = (total - hlast) / 255;
  int csum = incl - sum;
  for (int j = 0; j < 8; ++j) {
    const int i = lane * 8 + j;
    if (nonzero <= 1 || step == 0) {
      h[i] = i;
    } else {
      h[i] = min(max((step / 2 + csum) / step, 0), 255);
      csum += v[j];
    }
  }
}

// ------------------------------------------------ the slot records

// what a launch reads besides the images: the policy [num_sub, num_op, 3],
// sub_idx [B], draws [B, num_op, 4], the ops' range tables [kNumOps] (the
// device copies of ops/augment.py _OP_LOW, _OP_HIGH, _OP_MIRROR), and, when
// not null, records [B, num_op, kRec] that receive each slot's record (for
// holding it against slot_records)
struct Inputs {
  const float* policy;
  const int* sub_idx;
  const float* draws;
  const float* low;
  const float* high;
  const unsigned char* mirror;
  float* records;
  int num_sub, num_op;
};

// one (image, slot): the layout of ops/augment.py REC_WIDTH
struct Record {
  int op;
  bool gate, active;
  float v;
  float m[6];    // the inverse affine map (a, b, c, d, e, f)
  float box[4];  // the inclusive cutout box (x0, y0, x1, y1)
};

// torch.clamp(x, min=lo) and torch.clamp(x, max=hi) on the card
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

// image b's sub-policy index; one outside [0, num_sub) prints and traps
__device__ __forceinline__ int checked_sub(const Inputs& in, int b) {
  const int sub = in.sub_idx[b];
  if (sub < 0 || sub >= in.num_sub) {
    printf("augment kernel: sub_idx[%d] = %d is outside [0, %d)\n", b, sub, in.num_sub);
    __trap();
  }
  return sub;
}

// The record of image b's slot `slot`, every product and sum rounded on its
// own in slot_records' order, built by one thread (which writes it to
// in.records when that is set).  A sub-policy index or an op id out of range
// prints and traps.
__device__ Record slot_record(const Inputs& in, int b, int slot, int H, int W) {
  const int sub = checked_sub(in, b);
  const float* row = in.policy + ((size_t)sub * in.num_op + slot) * 3;
  const float* d = in.draws + ((size_t)b * in.num_op + slot) * 4;
  const float op_id = truncf(row[0]);  // .to(torch.int64)
  if (!(op_id >= 0.0f && op_id < (float)kNumOps)) {
    printf("augment kernel: op id %g of sub-policy %d, slot %d is outside [0, %d)\n", row[0],
           sub, slot, kNumOps);
    __trap();
  }
  Record r;
  r.op = (int)op_id;
  // the level -> value map and the mirror sign
  // (fast_autoaugment_tpu/ops/augment.py:416-426 apply_op)
  const float low = in.low[r.op], high = in.high[r.op];
  r.v = __fadd_rn(__fmul_rn(row[2], __fsub_rn(high, low)), low);
  if (in.mirror[r.op] && d[1] > 0.5f) r.v = __fmul_rn(r.v, -1.0f);
  // the gate (:444-447 apply_subpolicy)
  r.gate = d[0] < row[1];
  // the affine rows (:189-227); cx and cy are exact, w / 2.0 and h / 2.0
  const float v = r.v, cx = __fmul_rn((float)W, 0.5f), cy = __fmul_rn((float)H, 0.5f);
  r.m[0] = 1.0f; r.m[1] = 0.0f; r.m[2] = 0.0f;
  r.m[3] = 0.0f; r.m[4] = 1.0f; r.m[5] = 0.0f;
  switch (r.op) {
    case SHEAR_X: r.m[1] = v; break;
    case SHEAR_Y: r.m[3] = v; break;
    case TRANSLATE_X: r.m[2] = __fmul_rn(v, (float)W); break;
    case TRANSLATE_Y: r.m[5] = __fmul_rn(v, (float)H); break;
    case TRANSLATE_X_ABS: r.m[2] = v; break;
    case TRANSLATE_Y_ABS: r.m[5] = v; break;
    case ROTATE: {
      // rad = v * f32(pi / 180); cosf/sinf are libdevice's, as torch.cos/sin
      const float rad = __fmul_rn(v, kDegToRad);
      const float ca = cosf(rad), sa = sinf(rad);
      r.m[0] = ca;
      r.m[1] = -sa;
      r.m[2] = __fadd_rn(__fsub_rn(cx, __fmul_rn(ca, cx)), __fmul_rn(sa, cy));
      r.m[3] = sa;
      r.m[4] = ca;
      r.m[5] = __fsub_rn(__fsub_rn(cy, __fmul_rn(sa, cx)), __fmul_rn(ca, cy));
      break;
    }
    default: break;
  }
  // the Cutout and CutoutAbs box and its active flag (:333-365)
  const bool frac = r.op == CUTOUT;
  const float size = frac ? __fmul_rn(v, (float)W) : v, half = __fmul_rn(size, 0.5f);
  r.box[0] = truncf(clamp_min(__fsub_rn(d[2], half), 0.0f));
  r.box[1] = truncf(clamp_min(__fsub_rn(d[3], half), 0.0f));
  r.box[2] = clamp_max(__fadd_rn(r.box[0], size), (float)W);
  r.box[3] = clamp_max(__fadd_rn(r.box[1], size), (float)H);
  r.active = !(size < 0.0f) && !(frac && v <= 0.0f);
  if (in.records != nullptr) {
    float* o = in.records + ((size_t)b * in.num_op + slot) * kRec;
    o[0] = (float)r.op;
    o[1] = r.gate ? 1.0f : 0.0f;
    o[2] = r.v;
    for (int i = 0; i < 6; ++i) o[3 + i] = r.m[i];
    for (int i = 0; i < 4; ++i) o[9 + i] = r.box[i];
    o[13] = r.active ? 1.0f : 0.0f;
    o[14] = 0.0f;
    o[15] = 0.0f;
  }
  return r;
}

// ------------------------------------------------ augment_slot_kernel

__device__ void copy_image(const float* in, float* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = in[i];
}

__device__ void warp_affine(const float* in, float* out, const float* map,
                            int H, int W) {
  const float m[6] = {map[0], map[1], map[2], map[3], map[4], map[5]};  // in registers
  for (int p = threadIdx.x; p < H * W; p += blockDim.x) {
    const int y = p / W, x = p - y * W;
    float* o = out + 3 * p;
    int sx, sy;
    if (warp_source(m, x, y, H, W, &sx, &sy)) {
      const float* s = in + 3 * (sy * W + sx);
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
    const int c = i % 3;
    out[i] = autocontrast_value(to_int(in[i]), lo[c], hi[c]);
  }
}

// PIL equalize: per-channel histogram -> integer LUT -> gather
__device__ void equalize(const float* in, float* out, int HW, int (*lut)[256]) {
  for (int i = threadIdx.x; i < 3 * 256; i += blockDim.x) lut[i / 256][i % 256] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * HW; i += blockDim.x)
    atomicAdd(&lut[i % 3][to_int(in[i])], 1);
  __syncthreads();
  if (threadIdx.x < 96) equalize_lut(lut[threadIdx.x / 32]);
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

// the SMOOTH filter's value at interior pixel (y, x), channel c, from rows
// y-1, y, y+1 ([[1,1,1],[1,5,1],[1,1,1]]/13 with k1 = 1/13, k5 = 5/13; taps
// in the reference's order, dy outer, dx inner)
__device__ __forceinline__ float smooth(const float* const rows[3], int x, int c, float k1,
                                        float k5) {
  float acc = 0.0f;
  for (int dy = 0; dy < 3; ++dy)
    for (int dx = 0; dx < 3; ++dx) {
      const float k = (dy == 1 && dx == 1) ? k5 : k1;
      acc = __fadd_rn(acc, __fmul_rn(k, rows[dy][3 * (x + dx - 1) + c]));
    }
  return clip255(truncf(__fadd_rn(acc, 0.5f)));
}

// blend toward PIL SMOOTH (border copied)
__device__ void sharpness(const float* in, float* out, int H, int W, float f) {
  const float k1 = __fdiv_rn(1.0f, 13.0f), k5 = __fdiv_rn(5.0f, 13.0f);
  for (int p = threadIdx.x; p < H * W; p += blockDim.x) {
    const int y = p / W, x = p - y * W;
    const bool border = y == 0 || y == H - 1 || x == 0 || x == W - 1;
    const float* rows[3] = {in + 3 * (y - 1) * W, in + 3 * y * W, in + 3 * (y + 1) * W};
    for (int c = 0; c < 3; ++c) {
      const float xc = clip255(in[3 * p + c]);
      out[3 * p + c] = blend(border ? xc : smooth(rows, x, c, k1, k5), xc, f);
    }
  }
}

__global__ void __launch_bounds__(kThreads) augment_slot_kernel(
    const float* __restrict__ src, float* __restrict__ dst, const Inputs inputs, int slot,
    int H, int W) {
  __shared__ int lut[3][256];
  __shared__ int lo[3], hi[3];
  __shared__ unsigned long long gray_sum;
  __shared__ Record rec;

  const int HW = H * W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW * 3;
  const float* in = src + base;
  float* out = dst + base;
  if (threadIdx.x == 0) rec = slot_record(inputs, b, slot, H, W);
  __syncthreads();
  const int op = rec.op;
  const float v = rec.v;

  // every branch below is uniform across the block (one record per block),
  // so the __syncthreads() inside the reductions are reached by all threads
  if (!rec.gate) {  // gate off: the image passes through
    copy_image(in, out, 3 * HW);
    return;
  }
  switch (op) {
    case SHEAR_X: case SHEAR_Y: case TRANSLATE_X: case TRANSLATE_Y:
    case ROTATE: case TRANSLATE_X_ABS: case TRANSLATE_Y_ABS:
      warp_affine(in, out, rec.m, H, W);
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
      const int mask = posterize_mask(v);
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
      if (!rec.active) {
        copy_image(in, out, 3 * HW);
        break;
      }
      const float x0 = rec.box[0], y0 = rec.box[1], x1 = rec.box[2], y1 = rec.box[3];
      const float fill[3] = {125.0f, 123.0f, 114.0f};
      for (int p = threadIdx.x; p < HW; p += blockDim.x) {
        const int y = p / W, x = p - y * W;
        const bool inside = (float)x >= x0 && (float)x <= x1 &&
                            (float)y >= y0 && (float)y <= y1;
        for (int c = 0; c < 3; ++c) out[3 * p + c] = inside ? fill[c] : in[3 * p + c];
      }
      break;
    }
    default:  // slot_record traps on any other op id; never reached
      copy_image(in, out, 3 * HW);
  }
}

// ------------------------------------------------------ augment_kernel

// reductions of one block; the cluster's result is gathered into the g* fields
struct Scratch {
  int hist[3][256];          // this block's histogram
  int lut[3][256];           // the cluster's histogram, then the LUT
  int lo[3], hi[3];          // this block's min / max
  int glo[3], ghi[3];        // the cluster's min / max
  unsigned long long gray;   // this block's grey sum
  unsigned long long ggray;  // the cluster's grey sum
  unsigned long long bar;    // mbarrier of the staging copy
  Record rec[kRecords];      // slot s's record in rec[s % kRecords]
};
static_assert(sizeof(Scratch) <= kScratchBytes, "scratch outgrew its reservation");

// floats of one band buffer: the band, padded to 16 bytes, plus 4 floats of
// slack so that the band can start at the same address modulo 16 as its rows
// in global memory (the bulk copy needs both ends aligned)
__host__ __device__ __forceinline__ int band_floats(int rows, int W) {
  return ((rows * W * 3 + 3) & ~3) + 4;
}

__host__ __device__ __forceinline__ long long augment_smem_bytes(int H, int W, int C) {
  const int rows = (H + C - 1) / C;
  return kScratchBytes + 2ll * 4 * band_floats(rows, W);
}

// where one image's bands are; the same in every block of its cluster
struct Geo {
  int H, W, rows, C, rank;
  int r0, nrows;       // this block's band: image rows [r0, r0 + nrows)
  int off0, off_step;  // band offsets (floats, mod 4): rank r's is off0 + r * off_step
  float* buf[2];       // this block's two band buffers (16-byte aligned)
};

template <class T>
__device__ __forceinline__ T* at_rank(const Geo& g, T* p, int r) {
  return g.C == 1 ? p : cg::this_cluster().map_shared_rank(p, r);
}

// offset (floats) of rank r's band in its buffers: its rows' address mod 16
__device__ __forceinline__ int band_offset(const Geo& g, int r) {
  return (g.off0 + r * g.off_step) & 3;
}

__device__ __forceinline__ float* own_band(const Geo& g, int k) {
  return g.buf[k] + band_offset(g, g.rank);
}

// image row y (0 <= y < H) of buffer k, in the block of the cluster that holds it
__device__ __forceinline__ const float* row_of(const Geo& g, int k, int y) {
  if (g.C == 1) return g.buf[k] + g.off0 + y * g.W * 3;
  const int r = y / g.rows;
  return cg::this_cluster().map_shared_rank(g.buf[k], r) + band_offset(g, r) +
         (y - r * g.rows) * g.W * 3;
}

__device__ __forceinline__ void sync_cluster(const Geo& g) {
  if (g.C == 1) __syncthreads(); else cg::this_cluster().sync();
}

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

// start copying n floats from global `src` to shared `dst`, which lie at
// the same address modulo 16: the aligned body in one bulk copy, head and
// tail by the threads.  stage_wait(bar) completes it.
__device__ __forceinline__ void stage_start(float* dst, const float* src, int n,
                                            unsigned long long* bar) {
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
}

// wait for stage_start's copy; ends with the block synchronised
__device__ __forceinline__ void stage_wait(unsigned long long* bar) {
  mbar_wait(smem_addr(bar), 0);
  __syncthreads();
}

// write n floats from shared `src` to global `dst`: 16-byte stores where the
// two lie at the same address modulo 16 (the rule for a contiguous output)
__device__ __forceinline__ void store_band(float* dst, const float* src, int n) {
  if ((((uintptr_t)dst ^ (uintptr_t)src) & 15u) != 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
    return;
  }
  const int head = min(n, (int)(((16u - ((uintptr_t)dst & 15u)) & 15u) >> 2));
  const int nv = (n - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = s4[i];
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int i = head + 4 * nv + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// the warps: each output pixel of the band gathers its source pixel from
// buffer `cur` of the block that holds the source row
__device__ __forceinline__ void band_warp(const Geo& g, int cur, float* out,
                                          const float* map) {
  // the map in registers: the stores to `out` may alias the record's shared memory
  const float m[6] = {map[0], map[1], map[2], map[3], map[4], map[5]};
  for (int p = threadIdx.x; p < g.nrows * g.W; p += blockDim.x) {
    const int ly = p / g.W, x = p - ly * g.W;
    float* o = out + 3 * p;
    int sx, sy;
    if (warp_source(m, x, g.r0 + ly, g.H, g.W, &sx, &sy)) {
      const float* s = row_of(g, cur, sy) + 3 * sx;
      o[0] = s[0]; o[1] = s[1]; o[2] = s[2];
    } else {
      o[0] = 0.0f; o[1] = 0.0f; o[2] = 0.0f;
    }
  }
}

__device__ __forceinline__ void band_sharpness(const Geo& g, int cur, const float* in,
                                               float* out, float f) {
  const float k1 = __fdiv_rn(1.0f, 13.0f), k5 = __fdiv_rn(5.0f, 13.0f);
  for (int p = threadIdx.x; p < g.nrows * g.W; p += blockDim.x) {
    const int ly = p / g.W, x = p - ly * g.W, y = g.r0 + ly;
    const bool border = y == 0 || y == g.H - 1 || x == 0 || x == g.W - 1;
    const float* rows[3] = {nullptr, in + 3 * ly * g.W, nullptr};
    if (!border) {
      rows[0] = ly > 0 ? rows[1] - 3 * g.W : row_of(g, cur, y - 1);
      rows[2] = ly + 1 < g.nrows ? rows[1] + 3 * g.W : row_of(g, cur, y + 1);
    }
    for (int c = 0; c < 3; ++c) {
      const float xc = clip255(in[3 * p + c]);
      out[3 * p + c] = blend(border ? xc : smooth(rows, x, c, k1, k5), xc, f);
    }
  }
}

__device__ __forceinline__ void band_auto_contrast(const Geo& g, Scratch& s,
                                                   const float* in, float* out) {
  if (threadIdx.x < 3) { s.lo[threadIdx.x] = 255; s.hi[threadIdx.x] = 0; }
  __syncthreads();
  int l[3] = {255, 255, 255}, h[3] = {0, 0, 0};
  for (int p = threadIdx.x; p < g.nrows * g.W; p += blockDim.x)
    for (int c = 0; c < 3; ++c) {
      const int v = to_int(in[3 * p + c]);
      l[c] = min(l[c], v);
      h[c] = max(h[c], v);
    }
  for (int c = 0; c < 3; ++c) {
    l[c] = __reduce_min_sync(0xffffffffu, l[c]);
    h[c] = __reduce_max_sync(0xffffffffu, h[c]);
    if ((threadIdx.x & 31) == 0) { atomicMin(&s.lo[c], l[c]); atomicMax(&s.hi[c], h[c]); }
  }
  sync_cluster(g);  // every block's min and max are in
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    int lo = 255, hi = 0;
    for (int r = 0; r < g.C; ++r) {
      lo = min(lo, at_rank(g, s.lo, r)[c]);
      hi = max(hi, at_rank(g, s.hi, r)[c]);
    }
    s.glo[c] = lo;
    s.ghi[c] = hi;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * 256; i += blockDim.x)
    (&s.lut[0][0])[i] = (int)autocontrast_value(i % 256, s.glo[i / 256], s.ghi[i / 256]);
  __syncthreads();
  for (int i = threadIdx.x; i < g.nrows * g.W * 3; i += blockDim.x)
    out[i] = (float)s.lut[i % 3][to_int(in[i])];
}

__device__ __forceinline__ void band_equalize(const Geo& g, Scratch& s, const float* in,
                                              float* out) {
  int* hist = &s.hist[0][0];
  int* lut = &s.lut[0][0];
  for (int i = threadIdx.x; i < 3 * 256; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < g.nrows * g.W; p += blockDim.x)
    for (int c = 0; c < 3; ++c) atomicAdd(&s.hist[c][to_int(in[3 * p + c])], 1);
  sync_cluster(g);  // every block's histogram is in
  for (int i = threadIdx.x; i < 3 * 256; i += blockDim.x) {
    int sum = 0;
    for (int r = 0; r < g.C; ++r) sum += at_rank(g, hist, r)[i];
    lut[i] = sum;
  }
  __syncthreads();
  if (threadIdx.x < 96) equalize_lut(s.lut[threadIdx.x / 32]);
  __syncthreads();
  for (int i = threadIdx.x; i < g.nrows * g.W * 3; i += blockDim.x)
    out[i] = (float)s.lut[i % 3][to_int(in[i])];
}

__device__ __forceinline__ void band_contrast(const Geo& g, Scratch& s, const float* in,
                                              float* out, float f) {
  if (threadIdx.x == 0) s.gray = 0ull;
  __syncthreads();
  // a band holds under 2**16 pixels (it fits in shared memory): no overflow
  unsigned local = 0u;
  for (int p = threadIdx.x; p < g.nrows * g.W; p += blockDim.x) local += gray_u8(in + 3 * p);
  local = __reduce_add_sync(0xffffffffu, local);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s.gray, (unsigned long long)local);
  sync_cluster(g);  // every block's grey sum is in
  if (threadIdx.x == 0) {
    unsigned long long total = 0ull;
    for (int r = 0; r < g.C; ++r) total += *at_rank(g, &s.gray, r);
    s.ggray = total;
  }
  __syncthreads();
  const float mean = truncf(__fadd_rn(
      __fdiv_rn(__ull2float_rn(s.ggray), (float)(g.H * g.W)), 0.5f));
  for (int i = threadIdx.x; i < g.nrows * g.W * 3; i += blockDim.x)
    out[i] = blend(mean, clip255(in[i]), f);
}

// one cluster of C blocks per image (grid B * C); block `rank` owns image rows
// [rank * rows, (rank + 1) * rows).  Every branch on the record is uniform
// across the cluster, so every block reaches every barrier.
__global__ void __launch_bounds__(kMaxThreads) augment_kernel(
    const float* __restrict__ src, float* __restrict__ dst, const Inputs inputs, int H, int W,
    int rows, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  Scratch& s = *reinterpret_cast<Scratch*>(smem);
  Geo g;
  g.H = H; g.W = W; g.rows = rows; g.C = C;
  g.rank = C == 1 ? 0 : (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / C;
  g.r0 = g.rank * rows;
  g.nrows = max(0, min(H, g.r0 + rows) - g.r0);
  const size_t image = (size_t)b * H * W * 3;
  g.off0 = (int)((((uintptr_t)src >> 2) + image) & 3);
  g.off_step = (rows * W * 3) & 3;
  g.buf[0] = reinterpret_cast<float*>(smem + kScratchBytes);
  g.buf[1] = g.buf[0] + band_floats(rows, W);

  const int n = g.nrows * W * 3;
  const size_t band = image + (size_t)g.r0 * W * 3;
  // while the band is copied, lanes 0-2 of warp 0 build the first three
  // slots' records side by side (each a chain of dependent loads: sub_idx,
  // then the policy row and the draws, then the range tables)
  stage_start(own_band(g, 0), src + band, n, &s.bar);
  Inputs own = inputs;  // every block builds its records; rank 0 writes them out when asked
  if (g.rank != 0) own.records = nullptr;
  if ((int)threadIdx.x < min(inputs.num_op, kRecords))
    s.rec[threadIdx.x] = slot_record(own, b, threadIdx.x, H, W);
  stage_wait(&s.bar);  // the band and the records are in
  sync_cluster(g);  // every band is staged before any block reads another's

  int cur = 0;
  for (int slot = 0; slot < inputs.num_op; ++slot) {
    if (slot >= kRecords) {  // the slots after the third: thread 0 builds each in its turn
      __syncthreads();  // no thread still reads the record this one replaces
      if (threadIdx.x == 0) s.rec[slot % kRecords] = slot_record(own, b, slot, H, W);
      __syncthreads();
    }
    const Record& rec = s.rec[slot % kRecords];
    const int op = rec.op;
    const float v = rec.v;
    if (!rec.gate) continue;  // gate off: the image stays as it is
    if ((op == CUTOUT || op == CUTOUT_ABS) && !rec.active) continue;
    const float* in = own_band(g, cur);
    float* out = own_band(g, cur ^ 1);
    switch (op) {
      case SHEAR_X: case SHEAR_Y: case TRANSLATE_X: case TRANSLATE_Y:
      case ROTATE: case TRANSLATE_X_ABS: case TRANSLATE_Y_ABS:
        band_warp(g, cur, out, rec.m);
        break;
      case AUTO_CONTRAST:
        band_auto_contrast(g, s, in, out);
        break;
      case INVERT:
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          out[i] = __fsub_rn(255.0f, clip255(in[i]));
        break;
      case EQUALIZE:
        band_equalize(g, s, in, out);
        break;
      case SOLARIZE:
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          const float xc = clip255(in[i]);
          out[i] = xc < v ? xc : __fsub_rn(255.0f, xc);
        }
        break;
      case POSTERIZE: case POSTERIZE2: {
        const int mask = posterize_mask(v);
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          out[i] = (float)(to_int(in[i]) & mask);
        break;
      }
      case CONTRAST:
        band_contrast(g, s, in, out, v);
        break;
      case COLOR:
        for (int p = threadIdx.x; p < g.nrows * W; p += blockDim.x) {
          const float deg = (float)gray_u8(in + 3 * p);
          for (int c = 0; c < 3; ++c)
            out[3 * p + c] = blend(deg, clip255(in[3 * p + c]), v);
        }
        break;
      case BRIGHTNESS:
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          out[i] = blend(0.0f, clip255(in[i]), v);
        break;
      case SHARPNESS:
        band_sharpness(g, cur, in, out, v);
        break;
      case CUTOUT: case CUTOUT_ABS: {
        const float x0 = rec.box[0], y0 = rec.box[1], x1 = rec.box[2], y1 = rec.box[3];
        const float fill[3] = {125.0f, 123.0f, 114.0f};
        for (int p = threadIdx.x; p < g.nrows * W; p += blockDim.x) {
          const int ly = p / W, x = p - ly * W, y = g.r0 + ly;
          const bool inside = (float)x >= x0 && (float)x <= x1 &&
                              (float)y >= y0 && (float)y <= y1;
          for (int c = 0; c < 3; ++c) out[3 * p + c] = inside ? fill[c] : in[3 * p + c];
        }
        break;
      }
      default:  // slot_record traps on any other op id; never reached
        for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = in[i];
    }
    cur ^= 1;
    // the slot's output is complete before the next slot reads it, and no
    // block still reads the buffer that the next slot overwrites
    sync_cluster(g);
  }
  store_band(dst + band, own_band(g, cur), n);
}

int g_smem_set[64];  // dynamic shared memory allowed so far, per device

// clusters resident at once under the last plan checked, per device
struct Resident {
  int cluster, smem_bytes, threads, active;
};
Resident g_resident[64];

bool valid_plan(int height, int width, int cluster, int smem_bytes, int threads,
                int device) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
          cluster == 16) &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 && height >= 1 &&
         width >= 1 && smem_bytes <= kMaxSmemBytes &&
         smem_bytes == augment_smem_bytes(height, width, cluster) && device >= 0 &&
         device < 64;
}

// set the current device, allow the kernel `smem_bytes` of dynamic shared
// memory and clusters of 16, and describe a launch of `blocks` blocks
cudaError_t prepare(int device, int smem_bytes, int cluster, int threads, unsigned blocks,
                    cudaStream_t stream, cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (smem_bytes > g_smem_set[device]) {
    err = cudaFuncSetAttribute(augment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(augment_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    g_smem_set[device] = smem_bytes;
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

// The inputs of a launch (Inputs), checked for what the kernels cannot check.
bool valid_inputs(const float* policy, const int* sub_idx, const float* draws, const float* low,
                  const float* high, const unsigned char* mirror, int num_sub, int num_op) {
  return policy && sub_idx && draws && low && high && mirror && num_sub >= 1 && num_op >= 1;
}

}  // namespace

// One launch: every op slot of the policy over `src`: image i goes through
// sub-policy sub_idx[i] of `policy [num_sub, num_op, 3]` with its draws
// `draws [batch, num_op, 4]` and the range tables `low`, `high`, `mirror`
// [19]; `records [batch, num_op, 16]`, when not null, receives the slot
// records.  Clusters of `cluster` blocks of `threads` threads and
// `smem_bytes` of dynamic shared memory (the wrapper's plan; a plan that does
// not match the kernel's layout returns kErrBadPlan, a cluster that cannot be
// resident kErrNotResident).
extern "C" int faa_augment(const float* src, float* dst, const float* policy, const int* sub_idx,
                           const float* draws, const float* low, const float* high,
                           const unsigned char* mirror, float* records, int num_sub, int num_op,
                           int batch, int height, int width, int cluster, int smem_bytes,
                           int threads, int device, void* stream) {
  if (!valid_plan(height, width, cluster, smem_bytes, threads, device) ||
      !valid_inputs(policy, sub_idx, draws, low, high, mirror, num_sub, num_op))
    return kErrBadPlan;
  if (batch <= 0) return 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = prepare(device, smem_bytes, cluster, threads, (unsigned)batch * cluster,
                            (cudaStream_t)stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 1) {
    Resident& r = g_resident[device];
    if (r.cluster != cluster || r.smem_bytes != smem_bytes || r.threads != threads) {
      int active = 0;
      err = cudaOccupancyMaxActiveClusters(&active, augment_kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      r = {cluster, smem_bytes, threads, active};
    }
    if (r.active < 1) return kErrNotResident;
  } else {
    cfg.numAttrs = 0;  // one block per image: an ordinary launch
  }
  const int rows = (height + cluster - 1) / cluster;
  const Inputs inputs{policy, sub_idx, draws, low, high, mirror, records, num_sub, num_op};
  err = cudaLaunchKernelEx(&cfg, augment_kernel, src, dst, inputs, height, width, rows, cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of the plan that the device holds at once (0: the launch would be
// refused).
extern "C" int faa_augment_max_active_clusters(int height, int width, int cluster,
                                               int smem_bytes, int threads, int device,
                                               int* active) {
  *active = 0;
  if (!valid_plan(height, width, cluster, smem_bytes, threads, device)) return kErrBadPlan;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = prepare(device, smem_bytes, cluster, threads, cluster * 1024u, nullptr,
                            &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(active, augment_kernel, &cfg);
}

// One launch of one op slot (the large-image path), with the inputs of
// faa_augment.
extern "C" int faa_augment_slot(const float* src, float* dst, const float* policy,
                                const int* sub_idx, const float* draws, const float* low,
                                const float* high, const unsigned char* mirror, float* records,
                                int slot, int num_sub, int num_op, int batch, int height,
                                int width, int device, void* stream) {
  if (!valid_inputs(policy, sub_idx, draws, low, high, mirror, num_sub, num_op) || slot < 0 ||
      slot >= num_op)
    return kErrBadPlan;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return 0;
  const Inputs inputs{policy, sub_idx, draws, low, high, mirror, records, num_sub, num_op};
  augment_slot_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(src, dst, inputs, slot,
                                                                     height, width);
  return (int)cudaGetLastError();
}

extern "C" const char* faa_error_string(int code) {
  if (code == kErrBadPlan)
    return "the launch plan does not match the augmentation kernel's layout "
           "(cluster size, threads or dynamic shared memory), or an input is missing";
  if (code == kErrNotResident)
    return "no cluster of the planned size and shared memory can be resident "
           "on this device";
  return cudaGetErrorString((cudaError_t)code);
}
