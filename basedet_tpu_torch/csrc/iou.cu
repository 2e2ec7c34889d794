// Pairwise IoU of xyxy f32 boxes for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces basedet_tpu/ops/iou_pallas.py::_iou_kernel (reached via
// box_iou_pallas, kernel #10): out[b, m, n] = IoU(boxes1[b, m], boxes2[b, n]),
// 0 where the union is not positive. The TPU kernel streams 256x256 tiles over
// lane-major (4, N) boxes; here boxes stay row-major (x1, y1, x2, y2).
//
// Layout: boxes1 (B, M, 4), boxes2 (B, N, 4) or one (N, 4) shared by every
// image (b2_batch_stride 0: anchors), out (B, M, N), all contiguous f32, the
// boxes 16-byte aligned. The output is indexed in 64 bits: (2, 100, 268569) is
// already 53.7 M elements.
//
// What bounds it: bytes. The output, M*N f32 per image, is the only large
// array (161 MB at RetinaNet's (2, 100, 201600), 3x the L2), and the callers'
// pairs are almost all empty: a detector's gts are padded with zero boxes (97
// of 100 rows in the synthetic batches) and a real gt meets only the anchors
// near it. A kernel that runs the full arithmetic (~30 instructions with the
// IEEE division) on every element is bound by issue, not by its stores; this
// one spends the arithmetic only where an intersection can be positive:
//   - A warp owns a strip of kCols consecutive n of one image and a chunk of up
//     to 32 rows of boxes1 (a unit). It loads its strip's boxes2 once, with
//     their areas, into registers, and reduces their envelope: the minima of
//     x1 and y1 and the maxima of x2 and y2. Where 32-row chunks would give
//     fewer units than 8 warps an SM (R-CNN sampling's (2, 1100, 100) has one
//     strip an image), the host halves the rows a unit until they do.
//   - Lane i takes row m0 + i of the chunk, its area, and tests the row's box
//     against the envelope. A ballot gives the warp the rows whose box cannot
//     meet any box of the strip; those rows store zeros with no per-element
//     arithmetic. The others are broadcast by shuffles, one row at a time, and
//     every lane computes its kPerLane elements in full. There a zero
//     intersection skips the IEEE division (0 / union is that zero), so that a
//     warp whose lanes all see empty intersections, as most do beside a real
//     gt, runs no division.
//   - Stores go along n, streaming (st.global.cs: the output outlives the L2):
//     16 bytes a lane where N % 4 == 0, so that a warp writes 512 contiguous
//     bytes a row (column 4*lane + k); 4 bytes a lane otherwise, column
//     lane + 32*k, 128 contiguous bytes a store at any alignment of the row.
//   - One unit per warp, 8 warps a block, strips fastest: a block writes 4 KB
//     contiguous per row. Blocks are small (at most 8 x 16 KB of stores), so
//     the hardware scheduler balances the zero and the dense units with no
//     long last wave. A small N (R-CNN sampling's 100 gts) fills 25 of a
//     warp's 32 lanes.
//
// The skip is exact. For a row a and any box b of the strip,
//   d = min(x2a, x2b) - max(x1a, x1b) <= U = min(x2a, max x2) - max(x1a, min x1),
// because min and max are monotone and a correctly rounded subtraction is
// monotone in both operands. If U <= 0 (or its y twin is), every d <= 0, so
// iw = max(d, 0) is a zero and inter is a zero, and out = union > 0 ?
// inter / union : 0 is a zero too. Its sign is the one case that needs care:
// x - y rounds to -0.0 only for (-0.0) - (+0.0), and min and max return one of
// their operands, so d (or ih's difference) is -0.0 only where a coordinate is
// -0.0. There the sign of max(-0.0, 0) decides the result's: a box
// [0, 0, 10, -0.0] against [0, 0, 10, 10] has an ih of max(-0.0, 0), which is
// +0.0 on the H100 (the plain version gives +0.0 there) and -0.0 in PyTorch on
// the CPU (which gives -0.0). So that the skip is exact whatever a max does
// with signed zeros, a row or a strip holding a -0.0 coordinate is never
// skipped: it takes the full arithmetic, which is the plain version's, term
// by term. Where no coordinate is -0.0, no difference is -0.0, every zero
// above is +0.0, and the skip stores +0.0, the plain version's bits (a NaN
// union gives +0.0 on both sides). ops/iou_kernel.py::iou_tile_model is this
// rule on the CPU.
//
// Arithmetic, in the plain version's order (structures/box_ops.py::box_iou;
// built with -fmad=false, IEEE division):
//   iw = max(min(x2a, x2b) - max(x1a, x1b), 0), ih likewise; inter = iw*ih;
//   area = (x2 - x1) * (y2 - y1); union = area_a + area_b - inter;
//   out = union > 0 ? inter / max(union, 1e-12) : 0.
// On finite inputs this gives the plain version's bits: fmaxf(union, 1e-12)
// and clamp(min=1e-12) agree wherever union > 0, a zero inter divided by a
// positive number is that zero, and both sides write 0 elsewhere (a NaN union
// included).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                     // units (warps) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 4;                   // columns per lane
constexpr int kCols = 32 * kPerLane;          // columns per strip
constexpr int kRows = 32;                     // most rows per unit: one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool neg_zero(float v) { return __float_as_uint(v) == 0x80000000u; }

__device__ __forceinline__ bool any_neg_zero(float4 v) {
  return neg_zero(v.x) | neg_zero(v.y) | neg_zero(v.z) | neg_zero(v.w);
}

__device__ __forceinline__ float iou_one(float ax1, float ay1, float ax2, float ay2, float area_a,
                                         float bx1, float by1, float bx2, float by2, float area_b) {
  const float iw = fmaxf(fminf(ax2, bx2) - fmaxf(ax1, bx1), 0.0f);
  const float ih = fmaxf(fminf(ay2, by2) - fmaxf(ay1, by1), 0.0f);
  const float inter = iw * ih;
  const float uni = area_a + area_b - inter;
  const float q = inter != 0.0f ? inter / fmaxf(uni, 1e-12f) : inter;
  return uni > 0.0f ? q : 0.0f;
}

// The strip column of a lane's k-th element: 4 consecutive columns a lane
// (kVec, one 16-byte store), or one column a lane per 32.
template <bool kVec>
__device__ __forceinline__ int column(int lane, int k) {
  return kVec ? 4 * lane + k : lane + 32 * k;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    iou_kernel(const float4* __restrict__ boxes1, const float4* __restrict__ boxes2, int M, int N,
               long long b2_batch_stride, int strips, int rows_per_unit, int chunks, long long units,
               float* __restrict__ out) {
  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= units) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int strip = (int)(unit % strips);
  const long long rest = unit / strips;
  const int m0 = (int)(rest % chunks) * rows_per_unit;
  const long long b = rest / chunks;
  const int n0 = strip * kCols;
  const int cols = min(kCols, N - n0);
  const int rows = min(rows_per_unit, M - m0);

  // This lane's boxes2 and their areas; the strip's envelope and whether any
  // of its coordinates is -0.0.
  float bx1[kPerLane], by1[kPerLane], bx2[kPerLane], by2[kPerLane], area_b[kPerLane];
  float lo_x = INFINITY, lo_y = INFINITY, hi_x = -INFINITY, hi_y = -INFINITY;
  bool neg0 = false;
  const float4* bb = boxes2 + b * b2_batch_stride + n0;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = column<kVec>(lane, k);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < cols) {
      v = __ldg(bb + c);
      lo_x = fminf(lo_x, v.x);
      lo_y = fminf(lo_y, v.y);
      hi_x = fmaxf(hi_x, v.z);
      hi_y = fmaxf(hi_y, v.w);
      neg0 |= any_neg_zero(v);
    }
    bx1[k] = v.x;
    by1[k] = v.y;
    bx2[k] = v.z;
    by2[k] = v.w;
    area_b[k] = (v.z - v.x) * (v.w - v.y);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo_x = fminf(lo_x, __shfl_xor_sync(kFull, lo_x, s));
    lo_y = fminf(lo_y, __shfl_xor_sync(kFull, lo_y, s));
    hi_x = fmaxf(hi_x, __shfl_xor_sync(kFull, hi_x, s));
    hi_y = fmaxf(hi_y, __shfl_xor_sync(kFull, hi_y, s));
  }
  neg0 = __any_sync(kFull, neg0);

  // This lane's row of boxes1, its area, and whether it misses the envelope.
  float ax1 = 0.0f, ay1 = 0.0f, ax2 = 0.0f, ay2 = 0.0f, area_a = 0.0f;
  bool apart = false;
  if (lane < rows) {
    const float4 a = __ldg(boxes1 + b * M + m0 + lane);
    ax1 = a.x;
    ay1 = a.y;
    ax2 = a.z;
    ay2 = a.w;
    area_a = (ax2 - ax1) * (ay2 - ay1);
    apart = !neg0 && !any_neg_zero(a) &&
            (fminf(ax2, hi_x) - fmaxf(ax1, lo_x) <= 0.0f || fminf(ay2, hi_y) - fmaxf(ay1, lo_y) <= 0.0f);
  }
  const unsigned zero_rows = __ballot_sync(kFull, apart);

  float* o = out + (b * M + m0) * (long long)N + n0;
  for (int r = 0; r < rows; ++r, o += N) {
    float v[kPerLane];
    if ((zero_rows >> r) & 1u) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) v[k] = 0.0f;
    } else {
      const float rx1 = __shfl_sync(kFull, ax1, r), ry1 = __shfl_sync(kFull, ay1, r);
      const float rx2 = __shfl_sync(kFull, ax2, r), ry2 = __shfl_sync(kFull, ay2, r);
      const float rarea = __shfl_sync(kFull, area_a, r);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        v[k] = iou_one(rx1, ry1, rx2, ry2, rarea, bx1[k], by1[k], bx2[k], by2[k], area_b[k]);
    }
    if (kVec) {
      if (4 * lane < cols) __stcs(reinterpret_cast<float4*>(o + 4 * lane), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (lane + 32 * k < cols) __stcs(o + lane + 32 * k, v[k]);
    }
  }
}

}  // namespace

extern "C" {

// boxes1 (B, M, 4); boxes2 (B, N, 4) with b2_batch_stride = N * 4, or (N, 4)
// shared with b2_batch_stride = 0; out (B, M, N). All contiguous f32, the
// boxes 16-byte aligned (the wrapper sees to it). Returns the launch's CUDA
// error.
int basedet_box_iou(const void* boxes1, const void* boxes2, int B, int M, int N,
                    long long b2_batch_stride, void* out, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0) return 0;
  if ((uintptr_t)boxes1 % 16 != 0 || (uintptr_t)boxes2 % 16 != 0 || b2_batch_stride % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return (int)cudaGetLastError();
  const int strips = (N + kCols - 1) / kCols;
  int rows_per_unit = kRows;
  while (rows_per_unit > 1 &&
         (long long)B * strips * ((M + rows_per_unit - 1) / rows_per_unit) < (long long)kWarps * sms)
    rows_per_unit /= 2;
  const int chunks = (M + rows_per_unit - 1) / rows_per_unit;
  const long long units = (long long)B * chunks * strips;
  const long long blocks = (units + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = N % 4 == 0 && (uintptr_t)out % 16 == 0;
  const float4* b1 = (const float4*)boxes1;
  const float4* b2 = (const float4*)boxes2;
  if (vec)
    iou_kernel<true><<<(unsigned)blocks, kThreads, 0, stream>>>(b1, b2, M, N, b2_batch_stride / 4, strips,
                                                                 rows_per_unit, chunks, units, (float*)out);
  else
    iou_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(b1, b2, M, N, b2_batch_stride / 4, strips,
                                                                  rows_per_unit, chunks, units, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
