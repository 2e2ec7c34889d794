// Multilevel RoIAlign for Hopper (sm_90a), forward and backward, bound through
// plain C entries.
//
// The forward replaces the two Pallas forwards of the JAX package, which
// compute one function: basedet_tpu/ops/roi_align_window.py::_fwd_kernel_win (Morton-
// clustered windows, reached via pool_rois_window) and
// basedet_tpu/ops/roi_align_pallas.py::_fwd_kernel (the dense separable
// fallback). That function is multilevel_roi_align_batched
// (roi_align_separable.py): bilinear RoIAlign, average, aligned (-0.5 after
// scaling by 1/stride), sampling ratio 2, each RoI pooled from the one FPN
// level its id names. A sample with a coordinate < -1 or > size adds 0 but
// the bin still divides by S*S; coordinates clamp to [0, size-1] and
// hi = min(lo + 1, size - 1).
//
// Layout: features per level as the FPN gives them, NCHW (B, C, H_l, W_l)
// f32, read in place through each level's own strides (any layout works;
// NCHW is the fast one); rois (B, R, 4) xyxy in image coordinates; level ids
// (B, R) int32, computed once by the caller (the plain roi_level_assignment)
// so that the kernel and its plain version agree on the level by
// construction; output (B, R, ph, pw, C) f32, the JAX package's layout,
// which the box head flattens in (h, w, c) order.
//
// What bounds it: bytes (the output, and the feature rows the taps touch),
// and in practice the number of distinct 128-byte lines a warp's load
// touches. The forward (roi_align_fwd_kernel) gives one block a RoI and a
// slab of kSlab channels, in one launch for every level and image:
//   - the RoI's geometry and its 2*ph + 2*pw axis taps are computed once per
//     block, into shared memory, by the functions the backward uses;
//   - a warp takes one channel at a time; its lanes are the 4*pw x taps of a
//     row of samples (bin column j, sample sx, lo or hi corner), so each of
//     its 4*ph loads reads one feature row of one NCHW plane, a run of the
//     RoI's width: no copy of the features to channels-last;
//   - the lerp along x joins lane pairs by shuffles, the lerp along y stays
//     in the lane, and the two x samples of a bin join by a shuffle, in the
//     order of one thread's 16 products before: acc = 0, then for sy, for sx,
//     acc += wy_lo * top + wy_hi * bot;
//   - the block's (ph*pw) x kSlab outputs are staged in shared memory and
//     stored 16 bytes a lane into rows of C floats (a scalar store where C is
//     not a multiple of 4); channels past C in the last slab are skipped.
// pw is at most kMaxPw = 8 (a lane per x tap). The TPU's separable matmuls
// (dense weight matrices to ride the MXU) are not carried over: on this card
// the work is a gather, and the dense form would do ~H x more arithmetic.
//
// Agreement with the plain version: sample coordinates are computed with
// the plain version's operations in its order (compiled with -fmad=false,
// so no FMA contracts them), which keeps lo, hi and the lerp weights
// identical; only the order of the 16 products' sum differs.
//
// The backward (roi_align_bwd_kernel, at the end of the file) replaces the
// two Pallas backwards, basedet_tpu/ops/roi_align_window.py::_bwd_kernel_win
// and basedet_tpu/ops/roi_align_pallas.py::_bwd_kernel: the adjoint of the
// forward in the features,
//   dF_l[b, c, y, x] = sum over the RoIs r of level l and the bins (i, j) of
//                      Py[r, i, y] * Px[r, j, x] * g[b, r, i, j, c],
// and no gradient for the RoIs. It lives in this file so that both
// directions take their taps from the one axis_tap and roi_geometry. What
// bounds it: bytes (g read once, every level's dF written once, 4/5 of them
// the zeros no RoI reaches). It has one writer for each element of dF, in
// one launch for every level and image, and no atomics on values:
//   - a block owns a tile of kTileY rows x kTileX columns of one level of one
//     image and a slab of kBwdLanes channels: warp w takes row w of the tile,
//     lane c channel c of the slab, and a thread keeps the kTileX columns of
//     its (row, channel) in registers; the coarsest level's blocks come first,
//     as its few tiles hold the longest lists;
//   - it reads the image's RoIs a page of kThreads at a time and keeps, in
//     RoI-index order, those of its level whose tap window (rows and columns
//     between the first and the last sample's taps) meets its tile;
//   - it takes them kChunk at a time through two shared-memory stages, one
//     barrier a chunk: g's ph x pw bins for its slab by cp.async, and the
//     weights of the tile's columns (Px restricted, kMaxPw x kTileX) and rows
//     (Py restricted, kTileY x ph), each bin's row of them built by one
//     thread from the RoI's taps, all for the next chunk while this one is
//     summed;
//   - a warp whose row the RoI's window covers forms U[j] = sum_i Py[i, y]
//     g[i, j, c] (the i with a zero weight skipped), then adds sum_j Px[j, x]
//     U[j] to the window's columns, 8 at a time, by fmaf in a fixed order;
//   - the tile goes out once, zeros included, through shared memory in rows
//     of 32 columns, into NCHW-contiguous dF.
// Each element is summed in one order (the RoIs by index, then i, then j),
// so two runs give the same bits. A tile's RoIs pass through its block one
// chunk after another, so a tile that many RoIs cover (512 identical ones)
// takes as long as its list. The TPU kernels' chunked accumulators, window
// clustering, group masks and dense weight matmuls are not carried over.
//
// Both directions also come in bf16 (features, output, g and dF; RoIs stay
// f32), the type the JAX package's Pallas kernels take (roi_align_pallas.py
// sends only bf16 features there), as kernels of their own. They compute as
// roi_align_window.py's _fwd_kernel_win and _bwd_kernel_win do under the bf16
// policy: each axis's weight of a bin on a row, the sum over the bin's
// samples of their lerp terms in _axis_weights's order, is rounded to bf16
// once (merged_taps: the first of the bin's taps on a row carries the row's
// weight, the others 0), every product and sum runs in f32 from the bf16
// values, and each output, and each element of dF, is rounded to bf16 once.
// A new thread mapping changes who computes an element, not the order of its
// f32 operations: every bit is the one the f32 kernels' structure gives.
//
// The bf16 forward (roi_align_fwd_bf16_kernel) gives a block one RoI and a
// slab of kFwdSlab = 16 channels: warp w takes channels 4w..4w+3, lane 8c + j
// channel 4w + c and bin column j. What bounds it is the work a loaded
// element feeds, not the bytes: the f32 structure's lanes each load one
// 2-byte element a tap row, so it ran no faster than f32.
//   - every thread forms the RoI's window (tap_window) from the geometry and
//     the window's feature rows of each channel are copied into shared memory
//     by 16-byte cp.async, aligned down from the window's first column (a row
//     of P4 or P5 at 800x1344 is not 16-byte aligned, and a window starts at
//     any column: a row is staged e0 <= 7 elements early, in room for the
//     worst e0), while the bin's merged taps are formed; where the slab's
//     windows fit at once, a warp waits for its own channels' copies only;
//   - a lane then reads its bin column's 16 corner values a bin from shared
//     memory (each staged element feeds every lane whose taps read it, and
//     every bin row) and sums them in the f32 kernel's order: acc = 0, then
//     for sy, for sx, acc += wy_lo * top + wy_hi * bot;
//   - the 16 channels' windows share kFwdStageBytes; where they do not fit,
//     they are staged a group of channels at a time between block barriers;
//     where not one channel's window fits (32 KB: no RoI of P2-P5 at
//     800x1344 comes near), or the level's x stride is not 1 (channels-last
//     features), the lane reads its corners from global memory instead,
//     element by element;
//   - the outputs are staged in shared memory and stored 16 bytes a lane into
//     rows of C elements (element by element where C % 8 != 0).
//
// The bf16 backward (roi_align_bwd_bf16_kernel) keeps one writer for each
// element of dF, one launch and no atomics, and changes what a block covers:
//   - a tile of kTileY = 8 rows by kTileXb = 16 columns and a slab of
//     kBf16Lanes = 64 channels, so that each tile's RoI list is built 4 times
//     at C = 256, not 8; warp w takes row w, lane c channels 2c and 2c + 1,
//     and a thread keeps 16 columns of two channels in registers;
//   - g's bins for the slab are staged by cp.async 16 bytes a copy (8 or 4
//     where C's rows allow no wider, element by element where C is odd) and
//     read two channels a word (bf16x2);
//   - U[j] = sum_i Py[i, y] g[i, j, c] by fmaf over the bins i in order,
//     skipping zero weights, as before; then sum_j Px[j, x] U[j] by fmaf, j in
//     order, but only over the groups of 8 columns where bin j has a nonzero
//     weight (bin_weights returns them): a skipped group would have added
//     fmaf(0, U, acc) = acc, since acc starts at +0 and never becomes -0.
//     Where some U is not finite (0 * inf is NaN) every group of the window
//     takes every j, as in the f32 kernel, so every output keeps its chain;
//   - the finest level's first tile of each image goes first: the zero-area
//     boxes that pad an RPN's proposals all pool there, and launched last its
//     long list set the kernel's time;
//   - each thread stores its row of each of its channels 8 columns (16 bytes)
//     a store (narrower where the row's alignment or the level's edge asks):
//     no transpose, and a tile no RoI reaches stores its zeros and nothing
//     more than its list scan.
// Tensor cores are not used: they would sum in another order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kSampling = 2;  // axis_tap's sample offsets (0.25, 0.75) assume it
constexpr int kThreads = 256;
constexpr int kSlab = 64;    // forward: channels of a block
constexpr int kMaxPw = 8;    // forward: kSampling * 2 corners * pw lanes <= 32; backward: a column's weights
constexpr int kStagePad = 4; // forward: floats between staged bins, for 16-byte rows off one bank
constexpr int kTileY = kThreads / 32;  // backward: rows of a tile, one warp each
constexpr int kTileX = 32;             // backward: columns of a tile, a thread's accumulators
constexpr int kBwdLanes = 32;          // backward: channels of a block, one lane each
constexpr int kChunk = 4;              // backward: RoIs a shared-memory stage holds
constexpr int kTransposePitch = kTileX + 1;  // backward: floats between staged channels of a row

struct Levels {
  const void* feat[kMaxLevels];  // elements of the kernel's type
  long long stride[kMaxLevels][4];  // forward: elements between neighbours along b, c, y, x
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride, exact (powers of two)
  int n;
};

// The levels of the backward: the geometry of `Levels` (its feature
// pointers unused), where each level's gradient goes, its tiles and its
// first block.
struct LevelsOut {
  Levels in;
  void* grad[kMaxLevels];  // elements of the kernel's type
  int tiles_y[kMaxLevels], tiles_x[kMaxLevels];
  long long first[kMaxLevels], blocks[kMaxLevels];
  long long origin;  // the bf16 backward: blocks of the finest level's first tile, before all others
};

// Row (or column) index pair and weights of one sample along one axis, as
// _axis_weights computes them; the weights already carry 1/S and the
// out-of-range zeroing.
struct Tap {
  int lo, hi;
  float wlo, whi;
};

// One sample along one axis before its weights are formed: its rows, the
// lerp and the sample weight (1/S, or 0 out of range).
struct Sample {
  int lo, hi;
  float lerp, ws;
};

__device__ __forceinline__ Sample axis_sample(float start, float bin, int p, int s,
                                              int size) {
  // (s + 0.5) / kSampling, exact: 0.25 or 0.75
  const float step = __fadd_rn(static_cast<float>(p), s == 0 ? 0.25f : 0.75f);
  const float coord = __fadd_rn(start, __fmul_rn(step, bin));
  const bool oob = coord < -1.f || coord > static_cast<float>(size);
  const float top = static_cast<float>(size - 1);
  const float c = fminf(fmaxf(coord, 0.f), top);  // NaN -> 0: never out of bounds
  const float lo = floorf(c);
  const float hi = fminf(__fadd_rn(lo, 1.f), top);
  Sample u;
  u.lo = static_cast<int>(lo);
  u.hi = static_cast<int>(hi);
  u.lerp = __fsub_rn(c, lo);
  u.ws = oob ? 0.f : 1.f / kSampling;
  return u;
}

__device__ __forceinline__ Tap axis_tap(float start, float bin, int p, int s,
                                        int size) {
  const Sample u = axis_sample(start, bin, p, s, size);
  Tap t;
  t.lo = u.lo;
  t.hi = u.hi;
  t.wlo = __fmul_rn(__fsub_rn(1.f, u.lerp), u.ws);
  t.whi = __fmul_rn(u.lerp, u.ws);
  return t;
}

// A sample's weight on row y, ((y == lo) * (1 - lerp) + (y == hi) * lerp) *
// ws, as _axis_weights forms it before the sum over the samples.
__device__ __forceinline__ float row_weight(const Sample& u, int y) {
  const float a = y == u.lo ? __fsub_rn(1.f, u.lerp) : 0.f;
  const float b = y == u.hi ? u.lerp : 0.f;
  return __fmul_rn(__fadd_rn(a, b), u.ws);
}

// The bf16 variants' two taps of bin p along one axis, out[s] for sample s:
// the rows of axis_tap, and as weights the bin's weight on each row (its two
// samples' row_weight summed in f32, rounded to bf16) on the first of its
// four taps that reads the row, 0 on the others. A sum over the four taps
// then weighs each row once, by its rounded weight.
__device__ __forceinline__ void merged_taps(float start, float bin, int p, int size, Tap* out) {
  const Sample u0 = axis_sample(start, bin, p, 0, size);
  const Sample u1 = axis_sample(start, bin, p, 1, size);
  const int r[4] = {u0.lo, u0.hi, u1.lo, u1.hi};
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bool first = true;
#pragma unroll
    for (int j = 0; j < k; ++j) first = first && r[j] != r[k];
    const float m = __fadd_rn(row_weight(u0, r[k]), row_weight(u1, r[k]));
    w[k] = first ? __bfloat162float(__float2bfloat16_rn(m)) : 0.f;
  }
  out[0] = Tap{u0.lo, u0.hi, w[0], w[1]};
  out[1] = Tap{u1.lo, u1.hi, w[2], w[3]};
}


// One RoI on its level: the level id (clamped to the levels present), the
// box's start in feature coordinates (scaled by 1/stride, shifted by -0.5)
// and the bin sizes, in the plain version's operations and order.
struct Geometry {
  int level;
  float x1, y1, bin_h, bin_w;
};

__device__ __forceinline__ int level_of(const Levels& lv, const int* __restrict__ levels, long long br) {
  const int l = levels[br];
  return l < 0 ? 0 : (l >= lv.n ? lv.n - 1 : l);
}

__device__ __forceinline__ Geometry roi_geometry(const Levels& lv,
                                                 const float* __restrict__ rois,
                                                 const int* __restrict__ levels,
                                                 long long br, int ph, int pw) {
  Geometry g;
  g.level = level_of(lv, levels, br);
  const float sc = lv.scale[g.level];
  const float* roi = rois + br * 4;
  g.x1 = __fsub_rn(__fmul_rn(roi[0], sc), 0.5f);
  g.y1 = __fsub_rn(__fmul_rn(roi[1], sc), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], sc), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], sc), 0.5f);
  g.bin_h = __fdiv_rn(__fsub_rn(y2, g.y1), static_cast<float>(ph));
  g.bin_w = __fdiv_rn(__fsub_rn(x2, g.x1), static_cast<float>(pw));
  return g;
}

// Block: RoI br = blockIdx.x / slabs and channels [c0, c0 + kSlab), c0 =
// kSlab * (blockIdx.x % slabs). Shared memory: the 2*ph y taps, the 2*pw x
// taps, then the staged output, bin-major, kSlab + kStagePad floats a bin.
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(Levels lv, const float* __restrict__ rois,
                     const int* __restrict__ levels, int R, int C, int ph,
                     int pw, int slabs, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  Tap* ytap = reinterpret_cast<Tap*>(smem4);
  Tap* xtap = ytap + kSampling * ph;
  float* stage = reinterpret_cast<float*>(xtap + kSampling * pw);
  const long long br = blockIdx.x / slabs;
  const int c0 = (blockIdx.x % slabs) * kSlab;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Geometry g = roi_geometry(lv, rois, levels, br, ph, pw);
  const int l = g.level, H = lv.h[l], W = lv.w[l];
  for (int t = tid; t < kSampling * (ph + pw); t += kThreads) {
    if (t < kSampling * ph)
      ytap[t] = axis_tap(g.y1, g.bin_h, t / kSampling, t % kSampling, H);
    else {
      const int u = t - kSampling * ph;
      xtap[u] = axis_tap(g.x1, g.bin_w, u / kSampling, u % kSampling, W);
    }
  }
  __syncthreads();

  // this lane's x tap: bin column j, sample sx, the lo (even lanes) or hi
  // corner; lanes past 4 * pw load nothing but join the shuffles
  const bool active = lane < 2 * kSampling * pw;
  const Tap tx = xtap[active ? lane >> 1 : 0];
  const long long sy = lv.stride[l][2];
  const long long xo = (long long)(lane & 1 ? tx.hi : tx.lo) * lv.stride[l][3];
  const float* img = static_cast<const float*>(lv.feat[l]) + (br / R) * lv.stride[l][0];
  const int c_end = min(c0 + kSlab, C);
  const int bins = ph * pw, row = kSlab + kStagePad;
  for (int c = c0 + warp; c < c_end; c += kThreads / 32) {
    const float* plane = img + (long long)c * lv.stride[l][1] + xo;
    for (int i0 = 0; i0 < ph; i0 += 8) {
      // the corner values of 8 bin rows: rows lo and hi of samples sy = 0, 1
      float f[8][4];
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int i = i0 + ii;
#pragma unroll
        for (int s = 0; s < kSampling; ++s) {
          const Tap ty = ytap[min(i, ph - 1) * kSampling + s];
          const bool in = active && i < ph;
          f[ii][2 * s] = in ? __ldg(plane + ty.lo * sy) : 0.f;
          f[ii][2 * s + 1] = in ? __ldg(plane + ty.hi * sy) : 0.f;
        }
      }
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int i = i0 + ii;
        if (i >= ph) break;  // the same for the whole warp
        float v[kSampling];
#pragma unroll
        for (int s = 0; s < kSampling; ++s) {
          const Tap ty = ytap[i * kSampling + s];
          // the lo-corner lane takes its hi neighbour's values
          const float lo_hi = __shfl_down_sync(0xffffffffu, f[ii][2 * s], 1);
          const float hi_hi = __shfl_down_sync(0xffffffffu, f[ii][2 * s + 1], 1);
          const float top = __fadd_rn(__fmul_rn(tx.wlo, f[ii][2 * s]), __fmul_rn(tx.whi, lo_hi));
          const float bot = __fadd_rn(__fmul_rn(tx.wlo, f[ii][2 * s + 1]), __fmul_rn(tx.whi, hi_hi));
          v[s] = __fadd_rn(__fmul_rn(ty.wlo, top), __fmul_rn(ty.whi, bot));
        }
        // lane 4j holds sample sx = 0 of bin (i, j), lane 4j + 2 sample sx = 1
        const float v01 = __shfl_down_sync(0xffffffffu, v[0], 2);
        const float v11 = __shfl_down_sync(0xffffffffu, v[1], 2);
        const float acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(0.f, v[0]), v01), v[1]), v11);
        if (active && (lane & 3) == 0) stage[(i * pw + (lane >> 2)) * row + (c - c0)] = acc;
      }
    }
  }
  __syncthreads();

  // rows of C elements: this block's part of each bin's row, four elements a
  // lane
  float* dst = out + br * bins * (long long)C;
  if (C % 4 == 0) {
    for (int e = tid; e < bins * (kSlab / 4); e += kThreads) {
      const int bin = e / (kSlab / 4), c = c0 + 4 * (e % (kSlab / 4));
      if (c < C)
        *reinterpret_cast<float4*>(dst + (long long)bin * C + c) = *reinterpret_cast<const float4*>(stage + bin * row + (c - c0));
    }
  } else {
    for (int e = tid; e < bins * kSlab; e += kThreads) {
      const int bin = e / kSlab, c = c0 + e % kSlab;
      if (c < C) dst[(long long)bin * C + c] = stage[bin * row + (c - c0)];
    }
  }
}

// A RoI of the backward's list: its index in the image, its tap window on
// the level (first and last rows and columns any sample reads, whatever its
// weight) and its geometry.
struct Entry {
  int r, ylo, yhi, xlo, xhi;
  float x1, y1, bin_h, bin_w;
};

// The rows or columns that the taps of one axis read, from its first and
// last samples: the taps move monotonically with the sample (either way, as
// the bin's sign says), so these two bound all of them.
__device__ __forceinline__ void tap_window(float start, float bin, int p, int size,
                                           int& lo, int& hi) {
  const Tap a = axis_tap(start, bin, 0, 0, size);
  const Tap z = axis_tap(start, bin, p - 1, kSampling - 1, size);
  lo = min(a.lo, z.lo);
  hi = max(a.hi, z.hi);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, bool copy, bool vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(copy ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(copy ? 4 : 0));
}

// One shared-memory stage of the backward, for up to kChunk RoIs: g's bins
// of the block's slab (bins x kBwdLanes elements of the kernel's type, in a
// room of as many floats; channels past C zero), the weights
// of the tile's columns (kMaxPw x kTileX, bins past pw zero) and of its rows
// (kTileY x padded ph, bins past ph zero).
struct Stage {
  float* g;
  float* wx;
  float* wy;
};

__host__ __device__ __forceinline__ int padded_ph(int ph) { return (ph + 7) & ~7; }

__host__ __device__ __forceinline__ int stage_floats(int ph, int pw) {
  return kChunk * (ph * pw * kBwdLanes + kMaxPw * kTileX + kTileY * padded_ph(ph));
}

__device__ __forceinline__ Stage stage_at(float* base, int ph, int pw) {
  Stage st;
  st.g = base;
  st.wx = st.g + kChunk * ph * pw * kBwdLanes;
  st.wy = st.wx + kChunk * kMaxPw * kTileX;
  return st;
}

// The weights of bin p of one axis on the `n` tile rows (or columns) from
// `at`, into w[0], w[stride], ...: zeros, then each sample's lo and hi taps
// added in order, as _axis_weights sums them (a row takes at most one
// nonzero term from each sample, so the order cannot change a bit). With
// `merged` (bf16), the taps of merged_taps: one rounded weight a row.
// Returns the groups of 8 rows from `at` that hold a nonzero weight, a bit
// each (weights are never negative, so a sum is 0 only where every term is).
template <bool merged>
__device__ __forceinline__ unsigned bin_weights(float start, float bin, int p, int size, int at,
                                                int n, float* w, int stride) {
  for (int t = 0; t < n; ++t) w[t * stride] = 0.f;
  Tap taps[kSampling];
  if constexpr (merged) merged_taps(start, bin, p, size, taps);
  unsigned groups = 0;
#pragma unroll
  for (int s = 0; s < kSampling; ++s) {
    Tap u;
    if constexpr (merged)
      u = taps[s];
    else
      u = axis_tap(start, bin, p, s, size);
    if (u.lo >= at && u.lo < at + n) {
      w[(u.lo - at) * stride] = __fadd_rn(w[(u.lo - at) * stride], u.wlo);
      groups |= (u.wlo != 0.f) << ((u.lo - at) >> 3);
    }
    if (u.hi >= at && u.hi < at + n) {
      w[(u.hi - at) * stride] = __fadd_rn(w[(u.hi - at) * stride], u.whi);
      groups |= (u.whi != 0.f) << ((u.hi - at) >> 3);
    }
  }
  return groups;
}

// Block: level l, image b, tile (ty, tx) and channels [c0, c0 + kBwdLanes),
// the slab fastest, then the tile's column, row, image and level, the
// coarsest level first (its few tiles hold the longest lists). Shared
// memory: the page's list (kThreads entries), then two stages (reused by
// the final transpose). `vec`: g's rows copied 16 bytes at a time.
__global__ void __launch_bounds__(kThreads, 3)
roi_align_bwd_kernel(LevelsOut lv, const float* __restrict__ grad,
                     const float* __restrict__ rois,
                     const int* __restrict__ levels, int R, int C, int ph,
                     int pw, int slabs, bool vec) {
  constexpr int kVec = 4;  // floats of a 16-byte copy
  extern __shared__ float4 smem4[];
  Entry* list = reinterpret_cast<Entry*>(smem4);
  float* stages = reinterpret_cast<float*>(list + kThreads);
  __shared__ int warp_kept[kTileY];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  long long blk = blockIdx.x;
  int l = 0;
  while (blk < lv.first[l] || blk >= lv.first[l] + lv.blocks[l]) ++l;
  blk -= lv.first[l];
  const int c0 = static_cast<int>(blk % slabs) * kBwdLanes;
  blk /= slabs;
  const int x0 = static_cast<int>(blk % lv.tiles_x[l]) * kTileX;
  blk /= lv.tiles_x[l];
  const int y0 = static_cast<int>(blk % lv.tiles_y[l]) * kTileY;
  const int b = static_cast<int>(blk / lv.tiles_y[l]);
  const int H = lv.in.h[l], W = lv.in.w[l], y = y0 + warp;
  const int bins = ph * pw, php = padded_ph(ph), per = stage_floats(ph, pw);
  const float* gimg = grad + (long long)b * R * bins * C + c0;

  float acc[kTileX];
#pragma unroll
  for (int xx = 0; xx < kTileX; ++xx) acc[xx] = 0.f;

  for (int page = 0; page < R; page += kThreads) {
    // the page's RoIs of this level whose window meets the tile, in order
    const int r = page + tid;
    bool keep = false;
    Entry e;
    if (r < R && level_of(lv.in, levels, (long long)b * R + r) == l) {  // the level first: cheap
      const Geometry g = roi_geometry(lv.in, rois, levels, (long long)b * R + r, ph, pw);
      tap_window(g.y1, g.bin_h, ph, H, e.ylo, e.yhi);
      tap_window(g.x1, g.bin_w, pw, W, e.xlo, e.xhi);
      keep = e.ylo < y0 + kTileY && e.yhi >= y0 && e.xlo < x0 + kTileX && e.xhi >= x0;
      e.r = r;
      e.x1 = g.x1;
      e.y1 = g.y1;
      e.bin_h = g.bin_h;
      e.bin_w = g.bin_w;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int n = 0, at = 0;
#pragma unroll
    for (int w = 0; w < kTileY; ++w) {
      at += w < warp ? warp_kept[w] : 0;
      n += warp_kept[w];
    }
    if (keep) list[at + __popc(ballot & ((1u << lane) - 1))] = e;
    __syncthreads();

    // list entries q0.. into stage s: g by cp.async, and the weights, each
    // bin's row of them by one thread (the columns' from warp 0 on, the
    // rows' from warp kTileY / 2 on, beside the other warps' copies)
    auto load = [&](int q0, int s) {
      const Stage st = stage_at(stages + s * per, ph, pw);
      const int qn = min(kChunk, n - q0);
      for (int q = 0; q < qn; ++q) {
        const float* src = gimg + (long long)list[q0 + q].r * bins * C;
        float* dst = st.g + q * bins * kBwdLanes;
        if (vec) {
          for (int t = tid; t < bins * (kBwdLanes / kVec); t += kThreads) {
            const int bin = t / (kBwdLanes / kVec), c = kVec * (t % (kBwdLanes / kVec));
            const bool in = c0 + c < C;
            cp_async(dst + bin * kBwdLanes + c, in ? src + (long long)bin * C + c : grad, in, true);
          }
        } else {
          for (int t = tid; t < bins * kBwdLanes; t += kThreads) {
            const int bin = t / kBwdLanes, c = t % kBwdLanes;
            const bool in = c0 + c < C;
            cp_async(dst + bin * kBwdLanes + c, in ? src + (long long)bin * C + c : grad, in, false);
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
      const int tx = tid, ty = tid - kThreads / 2;
      if (tx < qn * pw) {
        const Entry& en = list[q0 + tx / pw];
        bin_weights<false>(en.x1, en.bin_w, tx % pw, W, x0, kTileX,
                           st.wx + ((tx / pw) * kMaxPw + tx % pw) * kTileX, 1);
      } else if (tx < qn * kMaxPw) {  // the rows of bins past pw
        const int z = tx - qn * pw;
        float* w = st.wx + ((z / (kMaxPw - pw)) * kMaxPw + pw + z % (kMaxPw - pw)) * kTileX;
        for (int t = 0; t < kTileX; ++t) w[t] = 0.f;
      }
      if (ty >= 0 && ty < qn * php) {
        const Entry& en = list[q0 + ty / php];
        float* w = st.wy + (ty / php) * kTileY * php + ty % php;
        if (ty % php < ph)
          bin_weights<false>(en.y1, en.bin_h, ty % php, H, y0, kTileY, w, php);
        else
          for (int t = 0; t < kTileY; ++t) w[t * php] = 0.f;
      }
    };

    const int chunks = (n + kChunk - 1) / kChunk;
    if (chunks > 0) {
      load(0, 0);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) load((k + 1) * kChunk, (k + 1) & 1);
      // this warp's row of the chunk's RoIs, into the accumulators
      const Stage st = stage_at(stages + (k & 1) * per, ph, pw);
      const int q0 = k * kChunk, qn = min(kChunk, n - q0);
      for (int q = 0; q < qn; ++q) {
        const Entry& en = list[q0 + q];
        if (y < en.ylo || y > en.yhi) continue;  // the same for the whole warp
        // U[j] = sum_i Py[i, y] g[i, j, c], the bins i of zero weight skipped
        float u[kMaxPw];
#pragma unroll
        for (int j = 0; j < kMaxPw; ++j) u[j] = 0.f;
        const float4* wy = reinterpret_cast<const float4*>(st.wy + (q * kTileY + warp) * php);
        const float* gq = st.g + q * bins * kBwdLanes + lane;
        for (int i0 = 0; i0 < ph; i0 += 8) {
          const float4 a = wy[i0 / 4], z = wy[i0 / 4 + 1];
          const float w8[8] = {a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) {
            if (w8[ii] == 0.f) continue;  // bins past ph too
            const float* gi = gq + (i0 + ii) * pw * kBwdLanes;
#pragma unroll
            for (int j = 0; j < kMaxPw; ++j)
              if (j < pw) u[j] = __fmaf_rn(w8[ii], gi[j * kBwdLanes], u[j]);
          }
        }
        // the window's columns, 8 at a time: each column's sum over j in
        // order, the 8 columns' chains side by side
        const int xa = max(en.xlo - x0, 0), xb = min(en.xhi - x0, kTileX - 1);
        const float4* wx = reinterpret_cast<const float4*>(st.wx + q * kMaxPw * kTileX);
#pragma unroll
        for (int x8 = 0; x8 < kTileX / 8; ++x8) {
          if (8 * x8 + 7 < xa || 8 * x8 > xb) continue;  // the same for the whole warp
#pragma unroll
          for (int j = 0; j < kMaxPw; ++j) {
            if (j >= pw) break;
            const float4 a = wx[(j * kTileX + 8 * x8) / 4], z = wx[(j * kTileX + 8 * x8) / 4 + 1];
            const float w8[8] = {a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[8 * x8 + c] = __fmaf_rn(w8[c], u[j], acc[8 * x8 + c]);
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();  // the next chunk's stage is in, this one's is free
    }
  }

  // the tile, zeros included: each warp's row through shared memory, channel
  // by channel in rows of kTileX columns
  __syncthreads();
  float* tr = stages + warp * kBwdLanes * kTransposePitch;
#pragma unroll
  for (int xx = 0; xx < kTileX; ++xx) tr[lane * kTransposePitch + xx] = acc[xx];
  __syncwarp();
  const int x = x0 + lane;
  if (y < H && x < W) {
    float* out = static_cast<float*>(lv.grad[l]) + ((long long)b * C + c0) * H * W + (long long)y * W + x;
    const int cn = min(kBwdLanes, C - c0);
    for (int c = 0; c < cn; ++c) out[(long long)c * H * W] = tr[c * kTransposePitch + lane];
  }
}


// ---- the bf16 kernels ------------------------------------------------------

constexpr int kFwdSlab = 16;               // bf16 forward: channels of a block, four a warp
constexpr int kFwdThreads = 8 * kFwdSlab;  // a lane per (channel, bin column)
constexpr int kOutPitch = kFwdSlab + 8;    // bf16 forward: elements between staged output bins
constexpr int kFwdStageBytes = 32768;      // bf16 forward: the room for a block's staged windows
constexpr int kBf16Lanes = 64;             // bf16 backward: channels of a block, two a lane
constexpr int kTileXb = 16;                // bf16 backward: columns of a tile, a thread's accumulators

__device__ __forceinline__ float bf16_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

// The bf16 forward's shared memory before the staged windows, in float4s:
// the 2*ph + 2*pw taps, then the output, bin-major, kOutPitch elements a bin.
__host__ __device__ __forceinline__ int fwd_bf16_taps_f4(int ph, int pw) { return kSampling * (ph + pw); }
__host__ __device__ __forceinline__ int fwd_bf16_out_f4(int ph, int pw) { return (ph * pw * kOutPitch * 2 + 15) / 16; }

// Block: RoI br = blockIdx.x / slabs and channels [c0, c0 + kFwdSlab), c0 =
// kFwdSlab * (blockIdx.x % slabs). Warp w takes channels 4w .. 4w + 3 of the
// slab: lane 8c + j takes channel 4w + c and bin column j, and walks the bin
// rows. Its 16 corner values a bin come from the RoI's window staged in
// shared memory (kFwdStageBytes after the output), as many channels at a
// time as fit, or, where not one channel's window fits or the level's x
// stride is not 1, from global memory.
__global__ void __launch_bounds__(kFwdThreads)
roi_align_fwd_bf16_kernel(Levels lv, const float* __restrict__ rois,
                          const int* __restrict__ levels, int R, int C, int ph,
                          int pw, int slabs, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float4 smem4[];
  Tap* ytap = reinterpret_cast<Tap*>(smem4);
  Tap* xtap = ytap + kSampling * ph;
  __nv_bfloat16* ostage = reinterpret_cast<__nv_bfloat16*>(smem4 + fwd_bf16_taps_f4(ph, pw));
  __nv_bfloat16* fstage =
      reinterpret_cast<__nv_bfloat16*>(smem4 + fwd_bf16_taps_f4(ph, pw) + fwd_bf16_out_f4(ph, pw));
  const long long br = blockIdx.x / slabs;
  const int c0 = static_cast<int>(blockIdx.x % slabs) * kFwdSlab;
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = 4 * (tid >> 5) + (lane >> 3), j = lane & 7;

  // the window: the rows and columns between the first and the last
  // sample's taps (tap_window), staged per channel as rows of 16-byte chunks
  // aligned down from the window's first column (e0 elements early); rows
  // rpitch elements apart (the chunks a row takes where e0 = 7), channels
  // cpitch, = 16 mod 64, which puts a warp's four channels 8 banks apart
  const Geometry g = roi_geometry(lv, rois, levels, br, ph, pw);
  const int l = g.level, H = lv.h[l], W = lv.w[l];
  int wy0, wy1, wx0, wx1;
  tap_window(g.y1, g.bin_h, ph, H, wy0, wy1);
  tap_window(g.x1, g.bin_w, pw, W, wx0, wx1);
  const int nr = wy1 - wy0 + 1, span = wx1 - wx0 + 1;
  const int rpitch = 8 * ((span + 14) / 8);
  const int room = nr * rpitch;
  const int cpitch = room + (80 - room % 64) % 64;
  const int cn = min(kFwdSlab, C - c0);
  const long long* st = lv.stride[l];
  // channels staged at once: 0 where the features are read from global memory
  const int group = st[3] == 1 ? min(cn, kFwdStageBytes / (2 * cpitch)) : 0;
  const int step = group ? group : cn;
  const bool one_round = group >= cn;  // then a warp waits for its own copies only
  const __nv_bfloat16* plane = static_cast<const __nv_bfloat16*>(lv.feat[l]) + (br / R) * st[0] +
                               (long long)(c0 + min(c, cn - 1)) * st[1];
  // the windows of channels [s0, s0 + group) into shared memory, one commit
  // group
  auto stage = [&](int s0) {
    if (c >= s0 && c < s0 + group) {
      __nv_bfloat16* win = fstage + (c - s0) * cpitch;
      for (int r = 0; r < nr; ++r) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(plane + (long long)(wy0 + r) * st[2] + wx0);
        const int e0 = (a >> 1) & 7;
        const char* chunk = reinterpret_cast<const char*>(a & ~uintptr_t(15));
        for (int k = j; k <= (e0 + span - 1) >> 3; k += 8) cp_async(win + r * rpitch + 8 * k, chunk + 16 * k, true, true);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (group) stage(0);  // in flight while the taps are formed

  for (int t = tid; t < ph + pw; t += kFwdThreads) {
    if (t < ph)
      merged_taps(g.y1, g.bin_h, t, H, ytap + kSampling * t);
    else
      merged_taps(g.x1, g.bin_w, t - ph, W, xtap + kSampling * (t - ph));
  }
  __syncthreads();

  // e0 of row r: the low bits of the byte address of (c, r, wx0)
  const unsigned a0 = static_cast<unsigned>(reinterpret_cast<uintptr_t>(plane + wx0));
  const unsigned row_bytes = static_cast<unsigned>(st[2] * 2);
  Tap tx[kSampling];
  tx[0] = xtap[kSampling * min(j, pw - 1)];
  tx[1] = xtap[kSampling * min(j, pw - 1) + 1];
  const int col[4] = {tx[0].lo, tx[0].hi, tx[1].lo, tx[1].hi};
  for (int s0 = 0; s0 < cn; s0 += step) {
    if (group) {
      if (s0) stage(s0);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      if (one_round)
        __syncwarp();
      else
        __syncthreads();
    }
    const __nv_bfloat16* win = fstage + (c - s0) * cpitch;
    if (c >= s0 && c < s0 + step && j < pw) {
      for (int i = 0; i < ph; ++i) {
        Tap ty[kSampling];
        ty[0] = ytap[kSampling * i];
        ty[1] = ytap[kSampling * i + 1];
        const int row[4] = {ty[0].lo, ty[0].hi, ty[1].lo, ty[1].hi};
        // f[k][m]: row k (lo, hi of sample 0, lo, hi of sample 1), column
        // m (the same of this lane's bin column)
        float f[4][4];
        if (group) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int e0 = ((a0 + row[k] * row_bytes) >> 1) & 7;
            const __nv_bfloat16* p = win + (row[k] - wy0) * rpitch + e0 - wx0;
#pragma unroll
            for (int m = 0; m < 4; ++m) f[k][m] = __bfloat162float(p[col[m]]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < 4; ++m) f[k][m] = __bfloat162float(__ldg(plane + row[k] * st[2] + col[m] * st[3]));
        }
        // the f32 forward's order: acc = 0, then for sy, for sx, acc +=
        // wy_lo * top + wy_hi * bot, top and bot the x lerps on the sample's
        // lo and hi rows
        float acc = 0.f;
#pragma unroll
        for (int sy = 0; sy < kSampling; ++sy)
#pragma unroll
          for (int sx = 0; sx < kSampling; ++sx) {
            const float top = __fadd_rn(__fmul_rn(tx[sx].wlo, f[2 * sy][2 * sx]), __fmul_rn(tx[sx].whi, f[2 * sy][2 * sx + 1]));
            const float bot =
                __fadd_rn(__fmul_rn(tx[sx].wlo, f[2 * sy + 1][2 * sx]), __fmul_rn(tx[sx].whi, f[2 * sy + 1][2 * sx + 1]));
            acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(ty[sy].wlo, top), __fmul_rn(ty[sy].whi, bot)));
          }
        ostage[(i * pw + j) * kOutPitch + c] = __float2bfloat16_rn(acc);
      }
    }
    if (!one_round && s0 + step < cn) __syncthreads();  // this group's windows are read before the next land
  }
  __syncthreads();

  // rows of C elements: this block's part of each bin's row, 16 bytes a lane
  const int bins = ph * pw;
  __nv_bfloat16* dst = out + br * bins * (long long)C + c0;
  if (C % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    for (int e = tid; e < bins * (kFwdSlab / 8); e += kFwdThreads) {
      const int bin = e / (kFwdSlab / 8), m = 8 * (e % (kFwdSlab / 8));
      if (m < cn)
        *reinterpret_cast<uint4*>(dst + (long long)bin * C + m) = *reinterpret_cast<const uint4*>(ostage + bin * kOutPitch + m);
    }
  } else {
    for (int e = tid; e < bins * kFwdSlab; e += kFwdThreads) {
      const int bin = e / kFwdSlab, m = e % kFwdSlab;
      if (m < cn) dst[(long long)bin * C + m] = ostage[bin * kOutPitch + m];
    }
  }
}

// cp.async of V = 4, 8 or 16 bytes (0 copied, zeros written, where !copy).
template <int V>
__device__ __forceinline__ void cp_async_v(void* dst, const void* src, bool copy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(copy ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(V), "r"(copy ? V : 0));
}

// g's bins of one RoI for the block's kBf16Lanes channels, V bytes a copy
// (channels past C zero); V = 2: element by element, without cp.async.
template <int V>
__device__ __forceinline__ void copy_g(__nv_bfloat16* dst, const __nv_bfloat16* src, const __nv_bfloat16* any,
                                       int bins, int C, int c0, int tid) {
  constexpr int kE = V / 2, kPerBin = kBf16Lanes / kE;
  for (int t = tid; t < bins * kPerBin; t += kThreads) {
    const int bin = t / kPerBin, c = kE * (t % kPerBin);
    const bool in = c0 + c < C;
    if constexpr (V == 2)
      dst[bin * kBf16Lanes + c] = in ? src[(long long)bin * C + c] : __float2bfloat16_rn(0.f);
    else
      cp_async_v<V>(dst + bin * kBf16Lanes + c, in ? src + (long long)bin * C + c : any, in);
  }
}

// One shared-memory stage of the bf16 backward, for up to kChunk RoIs: g's
// bins of the block's slab (bins x kBf16Lanes / 2 words of two channels),
// the weights of the tile's columns (kMaxPw x kTileXb) and rows (kTileY x
// padded ph, bins past ph zero), and each column bin's groups of 8 tile
// columns that hold a nonzero weight.
struct Stage16 {
  unsigned* g;
  float* wx;
  float* wy;
  unsigned* groups;
};

__host__ __device__ __forceinline__ int stage16_floats(int ph, int pw) {
  return kChunk * (ph * pw * kBf16Lanes / 2 + kMaxPw * kTileXb + kTileY * padded_ph(ph) + kMaxPw);
}

__device__ __forceinline__ Stage16 stage16_at(float* base, int ph, int pw) {
  Stage16 st;
  st.g = reinterpret_cast<unsigned*>(base);
  st.wx = base + kChunk * ph * pw * kBf16Lanes / 2;
  st.wy = st.wx + kChunk * kMaxPw * kTileXb;
  st.groups = reinterpret_cast<unsigned*>(st.wy + kChunk * kTileY * padded_ph(ph));
  return st;
}

// Eight bf16 values to dst, 16 bytes at once where the address allows and
// all eight lie in the row (n of them do), else the widest pieces it allows.
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const unsigned (&v)[4], int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (n == 8 && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if (n == 8 && (a & 7) == 0) {
    reinterpret_cast<uint2*>(dst)[0] = make_uint2(v[0], v[1]);
    reinterpret_cast<uint2*>(dst)[1] = make_uint2(v[2], v[3]);
  } else if (n == 8 && (a & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) reinterpret_cast<unsigned*>(dst)[k] = v[k];
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (t < n) reinterpret_cast<unsigned short*>(dst)[t] = static_cast<unsigned short>(v[t >> 1] >> (16 * (t & 1)));
  }
}

// Block: level l, image b, tile (ty, tx) of kTileY x kTileXb and channels
// [c0, c0 + kBf16Lanes): first the finest level's first tile of every image
// (the zero-area boxes that pad an RPN's proposals all pool there, so its
// list is the longest of a batch), then the rest as roi_align_bwd_kernel
// orders them. Warp w takes row w of the tile, lane c channels c0 + 2c and
// c0 + 2c + 1, and a thread keeps the kTileXb columns of its row and two
// channels in registers. Shared memory: the page's list (kThreads entries),
// then two stages. V: the bytes of a copy of g (16, 8 or 4; 2: element by
// element).
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
roi_align_bwd_bf16_kernel(LevelsOut lv, const __nv_bfloat16* __restrict__ grad,
                          const float* __restrict__ rois,
                          const int* __restrict__ levels, int R, int C, int ph,
                          int pw, int slabs) {
  extern __shared__ float4 smem4[];
  Entry* list = reinterpret_cast<Entry*>(smem4);
  float* stages = reinterpret_cast<float*>(list + kThreads);
  __shared__ int warp_kept[kTileY];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  long long blk = blockIdx.x;
  int l = 0;
  if (blk < lv.origin) {
    blk = blk / slabs * lv.tiles_x[0] * lv.tiles_y[0] * slabs + blk % slabs;
  } else {
    blk -= lv.origin;
    while (blk < lv.first[l] || blk >= lv.first[l] + lv.blocks[l]) ++l;
    blk -= lv.first[l];
    if (l == 0) {  // past each image's first tile
      const long long rest = (long long)lv.tiles_x[0] * lv.tiles_y[0] * slabs - slabs;
      blk = blk / rest * (rest + slabs) + blk % rest + slabs;
    }
  }
  const int c0 = static_cast<int>(blk % slabs) * kBf16Lanes;
  blk /= slabs;
  const int x0 = static_cast<int>(blk % lv.tiles_x[l]) * kTileXb;
  blk /= lv.tiles_x[l];
  const int y0 = static_cast<int>(blk % lv.tiles_y[l]) * kTileY;
  const int b = static_cast<int>(blk / lv.tiles_y[l]);
  const int H = lv.in.h[l], W = lv.in.w[l], y = y0 + warp;
  const int bins = ph * pw, php = padded_ph(ph), per = stage16_floats(ph, pw);
  const __nv_bfloat16* gimg = grad + (long long)b * R * bins * C + c0;

  float acc[kTileXb][2];
#pragma unroll
  for (int xx = 0; xx < kTileXb; ++xx) acc[xx][0] = acc[xx][1] = 0.f;

  for (int page = 0; page < R; page += kThreads) {
    // the page's RoIs of this level whose window meets the tile, in order
    const int r = page + tid;
    bool keep = false;
    Entry e;
    if (r < R && level_of(lv.in, levels, (long long)b * R + r) == l) {
      const Geometry g = roi_geometry(lv.in, rois, levels, (long long)b * R + r, ph, pw);
      tap_window(g.y1, g.bin_h, ph, H, e.ylo, e.yhi);
      tap_window(g.x1, g.bin_w, pw, W, e.xlo, e.xhi);
      keep = e.ylo < y0 + kTileY && e.yhi >= y0 && e.xlo < x0 + kTileXb && e.xhi >= x0;
      e.r = r;
      e.x1 = g.x1;
      e.y1 = g.y1;
      e.bin_h = g.bin_h;
      e.bin_w = g.bin_w;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int n = 0, at = 0;
#pragma unroll
    for (int w = 0; w < kTileY; ++w) {
      at += w < warp ? warp_kept[w] : 0;
      n += warp_kept[w];
    }
    if (keep) list[at + __popc(ballot & ((1u << lane) - 1))] = e;
    __syncthreads();

    // list entries q0.. into stage s: g by cp.async, and the weights and
    // column groups, each bin's row of them by one thread
    auto load = [&](int q0, int s) {
      const Stage16 st = stage16_at(stages + s * per, ph, pw);
      const int qn = min(kChunk, n - q0);
      for (int q = 0; q < qn; ++q)
        copy_g<V>(reinterpret_cast<__nv_bfloat16*>(st.g) + q * bins * kBf16Lanes,
                  gimg + (long long)list[q0 + q].r * bins * C, grad, bins, C, c0, tid);
      asm volatile("cp.async.commit_group;\n" ::);
      const int tx = tid, ty = tid - kThreads / 2;
      if (tx < qn * pw) {
        const Entry& en = list[q0 + tx / pw];
        st.groups[(tx / pw) * kMaxPw + tx % pw] =
            bin_weights<true>(en.x1, en.bin_w, tx % pw, W, x0, kTileXb, st.wx + ((tx / pw) * kMaxPw + tx % pw) * kTileXb, 1);
      }
      if (ty >= 0 && ty < qn * php) {
        const Entry& en = list[q0 + ty / php];
        float* w = st.wy + (ty / php) * kTileY * php + ty % php;
        if (ty % php < ph)
          bin_weights<true>(en.y1, en.bin_h, ty % php, H, y0, kTileY, w, php);
        else
          for (int t = 0; t < kTileY; ++t) w[t * php] = 0.f;
      }
    };

    const int chunks = (n + kChunk - 1) / kChunk;
    if (chunks > 0) {
      load(0, 0);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) load((k + 1) * kChunk, (k + 1) & 1);
      const Stage16 st = stage16_at(stages + (k & 1) * per, ph, pw);
      const int q0 = k * kChunk, qn = min(kChunk, n - q0);
      for (int q = 0; q < qn; ++q) {
        const Entry& en = list[q0 + q];
        if (y < en.ylo || y > en.yhi) continue;  // the same for the whole warp
        // U[j] = sum_i Py[i, y] g[i, j, c] for both channels, the bins i of
        // zero weight skipped
        float u[kMaxPw][2];
#pragma unroll
        for (int j = 0; j < kMaxPw; ++j) u[j][0] = u[j][1] = 0.f;
        const float4* wy = reinterpret_cast<const float4*>(st.wy + (q * kTileY + warp) * php);
        const unsigned* gq = st.g + q * bins * (kBf16Lanes / 2) + lane;
        for (int i0 = 0; i0 < ph; i0 += 8) {
          const float4 a = wy[i0 / 4], z = wy[i0 / 4 + 1];
          const float w8[8] = {a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) {
            if (w8[ii] == 0.f) continue;  // bins past ph too
            const unsigned* gi = gq + (i0 + ii) * pw * (kBf16Lanes / 2);
#pragma unroll
            for (int j = 0; j < kMaxPw; ++j)
              if (j < pw) {
                const unsigned v = gi[j * (kBf16Lanes / 2)];
                u[j][0] = __fmaf_rn(w8[ii], bf16_lo(v), u[j][0]);
                u[j][1] = __fmaf_rn(w8[ii], bf16_hi(v), u[j][1]);
              }
          }
        }
        // sum_j Px[j, x] U[j] into the columns, 8 at a time, j in order. A
        // group of 8 columns where bin j has no nonzero weight would add
        // fmaf(0, U, acc) = acc (acc is never -0), so it is skipped, unless
        // some U is not finite (0 * inf is NaN): then every group in the
        // window takes every j, as in the f32 kernel
        float size = 0.f;  // not finite where some U is (or where their sum overflows)
#pragma unroll
        for (int j = 0; j < kMaxPw; ++j) size = __fadd_rn(size, __fadd_rn(fabsf(u[j][0]), fabsf(u[j][1])));
        const int xa = max(en.xlo - x0, 0), xb = min(en.xhi - x0, kTileXb - 1);
        unsigned window = 0;
#pragma unroll
        for (int x8 = 0; x8 < kTileXb / 8; ++x8) window |= (8 * x8 + 7 >= xa && 8 * x8 <= xb) << x8;
        const float4* wx = reinterpret_cast<const float4*>(st.wx + q * kMaxPw * kTileXb);
        const unsigned* groups = st.groups + q * kMaxPw;
#pragma unroll
        for (int j = 0; j < kMaxPw; ++j) {
          if (j >= pw) break;
          const unsigned take = size <= FLT_MAX ? groups[j] : window;
#pragma unroll
          for (int x8 = 0; x8 < kTileXb / 8; ++x8) {
            if (!((take >> x8) & 1)) continue;
            const float4 a = wx[(j * kTileXb + 8 * x8) / 4], z = wx[(j * kTileXb + 8 * x8) / 4 + 1];
            const float w8[8] = {a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              acc[8 * x8 + c][0] = __fmaf_rn(w8[c], u[j][0], acc[8 * x8 + c][0]);
              acc[8 * x8 + c][1] = __fmaf_rn(w8[c], u[j][1], acc[8 * x8 + c][1]);
            }
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();  // the next chunk's stage is in, this one's is free
    }
  }

  // the tile, zeros included: each thread's row of each of its channels, 8
  // columns (16 bytes) a store
  if (y >= H) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 2 * lane + h;
    if (c >= C) continue;
    __nv_bfloat16* row = static_cast<__nv_bfloat16*>(lv.grad[l]) + ((long long)b * C + c) * H * W + (long long)y * W;
#pragma unroll
    for (int x8 = 0; x8 < kTileXb / 8; ++x8) {
      const int x = x0 + 8 * x8;
      if (x >= W) continue;
      unsigned v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(acc[8 * x8 + 2 * t][h], acc[8 * x8 + 2 * t + 1][h]);
        v[t] = *reinterpret_cast<const unsigned*>(&p);
      }
      store8(row + x, v, min(8, W - x));
    }
  }
}

// The backward's list and stages, in bytes, or 0 where they would not fit in
// `max_bytes`.
size_t bwd_smem(int ph, int pw, size_t max_bytes) {
  const size_t stages = 2 * sizeof(float) * stage_floats(ph, pw);
  const size_t transpose = sizeof(float) * kTileY * kBwdLanes * kTransposePitch;
  const size_t bytes = sizeof(Entry) * kThreads + (stages > transpose ? stages : transpose);
  return bytes <= max_bytes ? bytes : 0;
}

// Levels past n_levels repeat the last one, so that a clamped level id
// always finds a valid entry. feats and feat_strides may be null (the
// backward's).
Levels make_levels(const void* const* feats, const long long* feat_strides,
                   const int* heights, const int* widths, const int* strides,
                   int n_levels) {
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < n_levels ? l : n_levels - 1;
    lv.feat[l] = feats ? feats[k] : nullptr;
    for (int d = 0; d < 4; ++d)
      lv.stride[l][d] = feat_strides ? feat_strides[4 * k + d] : 0;
    lv.h[l] = heights[k];
    lv.w[l] = widths[k];
    lv.scale[l] = 1.f / static_cast<float>(strides[k]);
  }
  return lv;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

int max_smem() {
  int device = 0, bytes = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

// The backward's block count, and each level's tiles and first block, the
// coarsest level's blocks first, for `slabs` channel slabs a tile.
long long bwd_blocks(LevelsOut& lv, void* const* grads, int n_levels, int B, int slabs, int tile_x) {
  long long blocks = 0;
  lv.origin = 0;
  for (int l = kMaxLevels - 1; l >= 0; --l) {
    lv.grad[l] = grads[l < n_levels ? l : n_levels - 1];
    lv.tiles_y[l] = (lv.in.h[l] + kTileY - 1) / kTileY;
    lv.tiles_x[l] = (lv.in.w[l] + tile_x - 1) / tile_x;
    lv.first[l] = blocks;
    lv.blocks[l] = l < n_levels ? (long long)B * lv.tiles_y[l] * lv.tiles_x[l] * slabs : 0;
    blocks += lv.blocks[l];
  }
  return blocks;
}

int roi_align_fwd(const void* const* feats, const long long* feat_strides, const int* heights,
                  const int* widths, const int* strides, int n_levels, const float* rois,
                  const int* levels, int B, int R, int C, int ph, int pw, float* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || pw < 1 || pw > kMaxPw || ph < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * R * C <= 0) return 0;
  const Levels lv = make_levels(feats, feat_strides, heights, widths, strides, n_levels);
  const int slabs = (C + kSlab - 1) / kSlab;
  const long long blocks = (long long)B * R * slabs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Tap) * kSampling * (ph + pw) +
                      sizeof(float) * (size_t)ph * pw * (kSlab + kStagePad);
  if (const int err = set_smem(reinterpret_cast<const void*>(roi_align_fwd_kernel), smem)) return err;
  roi_align_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lv, rois, levels, R, C, ph, pw, slabs, out);
  return static_cast<int>(cudaGetLastError());
}

int roi_align_fwd_bf16(const void* const* feats, const long long* feat_strides, const int* heights,
                       const int* widths, const int* strides, int n_levels, const float* rois,
                       const int* levels, int B, int R, int C, int ph, int pw, __nv_bfloat16* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || pw < 1 || pw > kMaxPw || ph < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * R * C <= 0) return 0;
  const Levels lv = make_levels(feats, feat_strides, heights, widths, strides, n_levels);
  const int slabs = (C + kFwdSlab - 1) / kFwdSlab;
  const long long blocks = (long long)B * R * slabs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 16 * (size_t)(fwd_bf16_taps_f4(ph, pw) + fwd_bf16_out_f4(ph, pw)) + kFwdStageBytes;
  if (smem > static_cast<size_t>(max_smem())) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = set_smem(reinterpret_cast<const void*>(roi_align_fwd_bf16_kernel), smem)) return err;
  roi_align_fwd_bf16_kernel<<<static_cast<unsigned>(blocks), kFwdThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(lv, rois, levels, R, C, ph, pw, slabs, out);
  return static_cast<int>(cudaGetLastError());
}

int roi_align_bwd(void* const* grads, const int* heights, const int* widths, const int* strides,
                  int n_levels, const float* grad_out, const float* rois, const int* levels, int B,
                  int R, int C, int ph, int pw, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || pw < 1 || pw > kMaxPw || ph < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * C <= 0) return 0;
  LevelsOut lv;
  lv.in = make_levels(nullptr, nullptr, heights, widths, strides, n_levels);
  const int slabs = (C + kBwdLanes - 1) / kBwdLanes;
  const long long blocks = bwd_blocks(lv, grads, n_levels, B, slabs, kTileX);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const size_t smem = bwd_smem(ph, pw, static_cast<size_t>(max_smem()));
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = set_smem(reinterpret_cast<const void*>(roi_align_bwd_kernel), smem)) return err;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(grad_out) % 16 == 0;
  roi_align_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lv, grad_out, rois, levels, R, C, ph, pw, slabs, vec);
  return static_cast<int>(cudaGetLastError());
}

struct BwdLaunch {
  LevelsOut lv;
  const __nv_bfloat16* grad;
  const float* rois;
  const int* levels;
  int R, C, ph, pw, slabs;
  long long blocks;
  size_t smem;
  cudaStream_t stream;
};

template <int V>
int launch_bwd_bf16(const BwdLaunch& a) {
  if (const int err = set_smem(reinterpret_cast<const void*>(roi_align_bwd_bf16_kernel<V>), a.smem)) return err;
  roi_align_bwd_bf16_kernel<V><<<static_cast<unsigned>(a.blocks), kThreads, a.smem, a.stream>>>(
      a.lv, a.grad, a.rois, a.levels, a.R, a.C, a.ph, a.pw, a.slabs);
  return static_cast<int>(cudaGetLastError());
}

int roi_align_bwd_bf16(void* const* grads, const int* heights, const int* widths, const int* strides,
                       int n_levels, const __nv_bfloat16* grad_out, const float* rois, const int* levels,
                       int B, int R, int C, int ph, int pw, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || pw < 1 || pw > kMaxPw || ph < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * C <= 0) return 0;
  LevelsOut lv;
  lv.in = make_levels(nullptr, nullptr, heights, widths, strides, n_levels);
  const int slabs = (C + kBf16Lanes - 1) / kBf16Lanes;
  const long long blocks = bwd_blocks(lv, grads, n_levels, B, slabs, kTileXb);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  lv.origin = (long long)B * slabs;  // the finest level's first tiles go first: level 0 keeps the rest
  lv.blocks[0] -= lv.origin;
  const size_t smem = sizeof(Entry) * kThreads + 2 * sizeof(float) * stage16_floats(ph, pw);
  if (smem > static_cast<size_t>(max_smem())) return static_cast<int>(cudaErrorInvalidValue);
  int vec = 2;  // the widest copy of g that every row of it allows
  const int copies[3] = {16, 8, 4};
  for (const int v : copies)
    if (C * 2 % v == 0 && reinterpret_cast<uintptr_t>(grad_out) % v == 0) {
      vec = v;
      break;
    }
  const BwdLaunch a{lv, grad_out, rois, levels, R, C, ph, pw, slabs, blocks, smem, static_cast<cudaStream_t>(stream)};
  switch (vec) {
    case 16: return launch_bwd_bf16<16>(a);
    case 8: return launch_bwd_bf16<8>(a);
    case 4: return launch_bwd_bf16<4>(a);
    default: return launch_bwd_bf16<2>(a);
  }
}

}  // namespace

// feats: n_levels device pointers to (B, C, H_l, W_l) f32 with
// feat_strides their strides in elements (n_levels x 4 host long longs, b, c,
// y, x); heights, widths, strides: n_levels host ints; rois (B, R, 4) f32,
// levels (B, R) int32, out (B, R, ph, pw, C) f32, contiguous on the device.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for more levels than the kernel
// holds, pw > kMaxPw or too many blocks.
extern "C" int basedet_roi_align_fwd(const float* const* feats,
                                     const long long* feat_strides,
                                     const int* heights, const int* widths,
                                     const int* strides, int n_levels,
                                     const float* rois, const int* levels,
                                     int B, int R, int C, int ph, int pw,
                                     float* out, void* stream) {
  return roi_align_fwd(reinterpret_cast<const void* const*>(feats), feat_strides, heights, widths, strides,
                       n_levels, rois, levels, B, R, C, ph, pw, out, stream);
}

// The bf16 forward: feats and out hold bf16, the rest as for the f32 entry.
extern "C" int basedet_roi_align_fwd_bf16(const void* const* feats,
                                          const long long* feat_strides,
                                          const int* heights, const int* widths,
                                          const int* strides, int n_levels,
                                          const float* rois, const int* levels,
                                          int B, int R, int C, int ph, int pw,
                                          void* out, void* stream) {
  return roi_align_fwd_bf16(feats, feat_strides, heights, widths, strides, n_levels, rois, levels, B, R, C, ph,
                            pw, static_cast<__nv_bfloat16*>(out), stream);
}

// grads: n_levels device pointers to NCHW-contiguous (B, C, H_l, W_l) f32,
// every element of which the kernel writes; grad_out (B, R, ph, pw, C) f32;
// the rest as for the forward. Launches on `stream`, does not synchronise,
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// more levels than the kernel holds, pw > kMaxPw, bins that do not fit
// shared memory or too many blocks.
extern "C" int basedet_roi_align_bwd(float* const* grads, const int* heights,
                                     const int* widths, const int* strides,
                                     int n_levels, const float* grad_out,
                                     const float* rois, const int* levels,
                                     int B, int R, int C, int ph, int pw,
                                     void* stream) {
  return roi_align_bwd(reinterpret_cast<void* const*>(grads), heights, widths, strides, n_levels, grad_out,
                       rois, levels, B, R, C, ph, pw, stream);
}

// The bf16 backward: grads and grad_out hold bf16, the rest as for the f32
// entry.
extern "C" int basedet_roi_align_bwd_bf16(void* const* grads, const int* heights,
                                          const int* widths, const int* strides,
                                          int n_levels, const void* grad_out,
                                          const float* rois, const int* levels,
                                          int B, int R, int C, int ph, int pw,
                                          void* stream) {
  return roi_align_bwd_bf16(grads, heights, widths, strides, n_levels,
                            static_cast<const __nv_bfloat16*>(grad_out), rois, levels, B, R, C, ph, pw, stream);
}
