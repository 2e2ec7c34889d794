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
// Both kernels are templates on the element type of the features, the
// output, g and dF: f32 (the kernels above, bit for bit) or bf16, the type
// the JAX package's Pallas kernels take (roi_align_pallas.py sends only bf16
// features there). The bf16 variants compute as roi_align_window.py's
// _fwd_kernel_win and _bwd_kernel_win do under the bf16 policy: each axis's
// weight of a bin on a row, the sum over the bin's samples of their lerp
// terms in _axis_weights's order, is rounded to bf16 once (merged_taps: the
// first of the bin's taps on a row carries the row's weight, the others 0),
// and every product and sum runs in f32 from the bf16 values; the output,
// and dF, are rounded to bf16 once. They load and store 2-byte elements
// (g through 16-byte cp.async where C % 8 == 0) and keep the f32 kernels'
// structure; tensor cores are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

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

// Element access of the templates: loads widen to f32, stores round to the
// element type once.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else
    return __float2bfloat16_rn(v);
}

// Four consecutive outputs, 16 bytes (f32) or 8 (bf16), to an address
// aligned to that.
__device__ __forceinline__ void store4(float* dst, float4 v) { *reinterpret_cast<float4*>(dst) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(dst) = u;
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
// T: the features' and the output's element type (float or __nv_bfloat16).
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(Levels lv, const float* __restrict__ rois,
                     const int* __restrict__ levels, int R, int C, int ph,
                     int pw, int slabs, T* __restrict__ out) {
  extern __shared__ float4 smem4[];
  Tap* ytap = reinterpret_cast<Tap*>(smem4);
  Tap* xtap = ytap + kSampling * ph;
  float* stage = reinterpret_cast<float*>(xtap + kSampling * pw);
  const long long br = blockIdx.x / slabs;
  const int c0 = (blockIdx.x % slabs) * kSlab;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Geometry g = roi_geometry(lv, rois, levels, br, ph, pw);
  const int l = g.level, H = lv.h[l], W = lv.w[l];
  if constexpr (std::is_same_v<T, float>) {
    for (int t = tid; t < kSampling * (ph + pw); t += kThreads) {
      if (t < kSampling * ph)
        ytap[t] = axis_tap(g.y1, g.bin_h, t / kSampling, t % kSampling, H);
      else {
        const int u = t - kSampling * ph;
        xtap[u] = axis_tap(g.x1, g.bin_w, u / kSampling, u % kSampling, W);
      }
    }
  } else {  // a bin's two taps at once, its rows' weights merged and rounded
    for (int t = tid; t < ph + pw; t += kThreads) {
      if (t < ph)
        merged_taps(g.y1, g.bin_h, t, H, ytap + kSampling * t);
      else
        merged_taps(g.x1, g.bin_w, t - ph, W, xtap + kSampling * (t - ph));
    }
  }
  __syncthreads();

  // this lane's x tap: bin column j, sample sx, the lo (even lanes) or hi
  // corner; lanes past 4 * pw load nothing but join the shuffles
  const bool active = lane < 2 * kSampling * pw;
  const Tap tx = xtap[active ? lane >> 1 : 0];
  const long long sy = lv.stride[l][2];
  const long long xo = (long long)(lane & 1 ? tx.hi : tx.lo) * lv.stride[l][3];
  const T* img = static_cast<const T*>(lv.feat[l]) + (br / R) * lv.stride[l][0];
  const int c_end = min(c0 + kSlab, C);
  const int bins = ph * pw, row = kSlab + kStagePad;
  for (int c = c0 + warp; c < c_end; c += kThreads / 32) {
    const T* plane = img + (long long)c * lv.stride[l][1] + xo;
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
          f[ii][2 * s] = in ? to_f32(__ldg(plane + ty.lo * sy)) : 0.f;
          f[ii][2 * s + 1] = in ? to_f32(__ldg(plane + ty.hi * sy)) : 0.f;
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
  T* dst = out + br * bins * (long long)C;
  if (C % 4 == 0) {
    for (int e = tid; e < bins * (kSlab / 4); e += kThreads) {
      const int bin = e / (kSlab / 4), c = c0 + 4 * (e % (kSlab / 4));
      if (c < C)
        store4(dst + (long long)bin * C + c, *reinterpret_cast<const float4*>(stage + bin * row + (c - c0)));
    }
  } else {
    for (int e = tid; e < bins * kSlab; e += kThreads) {
      const int bin = e / kSlab, c = c0 + e % kSlab;
      if (c < C) dst[(long long)bin * C + c] = from_f32<T>(stage[bin * row + (c - c0)]);
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
template <bool merged>
__device__ __forceinline__ void bin_weights(float start, float bin, int p, int size, int at,
                                            int n, float* w, int stride) {
  for (int t = 0; t < n; ++t) w[t * stride] = 0.f;
  Tap taps[kSampling];
  if constexpr (merged) merged_taps(start, bin, p, size, taps);
#pragma unroll
  for (int s = 0; s < kSampling; ++s) {
    Tap u;
    if constexpr (merged)
      u = taps[s];
    else
      u = axis_tap(start, bin, p, s, size);
    if (u.lo >= at && u.lo < at + n) w[(u.lo - at) * stride] = __fadd_rn(w[(u.lo - at) * stride], u.wlo);
    if (u.hi >= at && u.hi < at + n) w[(u.hi - at) * stride] = __fadd_rn(w[(u.hi - at) * stride], u.whi);
  }
}

// Block: level l, image b, tile (ty, tx) and channels [c0, c0 + kBwdLanes),
// the slab fastest, then the tile's column, row, image and level, the
// coarsest level first (its few tiles hold the longest lists). Shared
// memory: the page's list (kThreads entries), then two stages (reused by
// the final transpose). T: g's and dF's element type (float or
// __nv_bfloat16); `vec`: g's rows copied 16 bytes at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
roi_align_bwd_kernel(LevelsOut lv, const T* __restrict__ grad,
                     const float* __restrict__ rois,
                     const int* __restrict__ levels, int R, int C, int ph,
                     int pw, int slabs, bool vec) {
  constexpr bool kBf16 = !std::is_same_v<T, float>;
  constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte copy
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
  const T* gimg = grad + (long long)b * R * bins * C + c0;

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
        const T* src = gimg + (long long)list[q0 + q].r * bins * C;
        T* dst = reinterpret_cast<T*>(st.g) + q * bins * kBwdLanes;
        if (vec) {
          for (int t = tid; t < bins * (kBwdLanes / kVec); t += kThreads) {
            const int bin = t / (kBwdLanes / kVec), c = kVec * (t % (kBwdLanes / kVec));
            const bool in = c0 + c < C;
            cp_async(dst + bin * kBwdLanes + c, in ? src + (long long)bin * C + c : grad, in, true);
          }
        } else if constexpr (kBf16) {  // 2-byte elements: no cp.async of that size
          for (int t = tid; t < bins * kBwdLanes; t += kThreads) {
            const int bin = t / kBwdLanes, c = t % kBwdLanes;
            dst[bin * kBwdLanes + c] = c0 + c < C ? src[(long long)bin * C + c] : from_f32<T>(0.f);
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
        bin_weights<kBf16>(en.x1, en.bin_w, tx % pw, W, x0, kTileX,
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
          bin_weights<kBf16>(en.y1, en.bin_h, ty % php, H, y0, kTileY, w, php);
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
        const T* gq = reinterpret_cast<const T*>(st.g) + q * bins * kBwdLanes + lane;
        for (int i0 = 0; i0 < ph; i0 += 8) {
          const float4 a = wy[i0 / 4], z = wy[i0 / 4 + 1];
          const float w8[8] = {a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) {
            if (w8[ii] == 0.f) continue;  // bins past ph too
            const T* gi = gq + (i0 + ii) * pw * kBwdLanes;
#pragma unroll
            for (int j = 0; j < kMaxPw; ++j)
              if (j < pw) u[j] = __fmaf_rn(w8[ii], to_f32(gi[j * kBwdLanes]), u[j]);
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
    T* out = static_cast<T*>(lv.grad[l]) + ((long long)b * C + c0) * H * W + (long long)y * W + x;
    const int cn = min(kBwdLanes, C - c0);
    for (int c = 0; c < cn; ++c) out[(long long)c * H * W] = from_f32<T>(tr[c * kTransposePitch + lane]);
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

template <typename T>
int roi_align_fwd(const void* const* feats, const long long* feat_strides, const int* heights,
                  const int* widths, const int* strides, int n_levels, const float* rois,
                  const int* levels, int B, int R, int C, int ph, int pw, T* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || pw < 1 || pw > kMaxPw || ph < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * R * C <= 0) return 0;
  const Levels lv = make_levels(feats, feat_strides, heights, widths, strides, n_levels);
  const int slabs = (C + kSlab - 1) / kSlab;
  const long long blocks = (long long)B * R * slabs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Tap) * kSampling * (ph + pw) +
                      sizeof(float) * (size_t)ph * pw * (kSlab + kStagePad);
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        roi_align_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (err) return err;
  }
  roi_align_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      lv, rois, levels, R, C, ph, pw, slabs, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int roi_align_bwd(void* const* grads, const int* heights, const int* widths, const int* strides,
                  int n_levels, const T* grad_out, const float* rois, const int* levels, int B,
                  int R, int C, int ph, int pw, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || pw < 1 || pw > kMaxPw || ph < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * C <= 0) return 0;
  LevelsOut lv;
  lv.in = make_levels(nullptr, nullptr, heights, widths, strides, n_levels);
  const int slabs = (C + kBwdLanes - 1) / kBwdLanes;
  long long blocks = 0;
  for (int l = kMaxLevels - 1; l >= 0; --l) {  // the coarsest level's blocks first
    lv.grad[l] = grads[l < n_levels ? l : n_levels - 1];
    lv.tiles_y[l] = (lv.in.h[l] + kTileY - 1) / kTileY;
    lv.tiles_x[l] = (lv.in.w[l] + kTileX - 1) / kTileX;
    lv.first[l] = blocks;
    lv.blocks[l] = l < n_levels ? (long long)B * lv.tiles_y[l] * lv.tiles_x[l] * slabs : 0;
    blocks += lv.blocks[l];
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  int device = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const size_t smem = bwd_smem(ph, pw, static_cast<size_t>(max_smem));
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        roi_align_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (err) return err;
  }
  const bool vec = C % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(grad_out) % 16 == 0;
  roi_align_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      lv, grad_out, rois, levels, R, C, ph, pw, slabs, vec);
  return static_cast<int>(cudaGetLastError());
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
  return roi_align_fwd<float>(reinterpret_cast<const void* const*>(feats), feat_strides, heights, widths,
                              strides, n_levels, rois, levels, B, R, C, ph, pw, out, stream);
}

// The bf16 forward: feats and out hold bf16, the rest as for the f32 entry.
extern "C" int basedet_roi_align_fwd_bf16(const void* const* feats,
                                          const long long* feat_strides,
                                          const int* heights, const int* widths,
                                          const int* strides, int n_levels,
                                          const float* rois, const int* levels,
                                          int B, int R, int C, int ph, int pw,
                                          void* out, void* stream) {
  return roi_align_fwd<__nv_bfloat16>(feats, feat_strides, heights, widths, strides, n_levels, rois,
                                      levels, B, R, C, ph, pw, static_cast<__nv_bfloat16*>(out), stream);
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
  return roi_align_bwd<float>(reinterpret_cast<void* const*>(grads), heights, widths, strides, n_levels,
                              grad_out, rois, levels, B, R, C, ph, pw, stream);
}

// The bf16 backward: grads and grad_out hold bf16, the rest as for the f32
// entry.
extern "C" int basedet_roi_align_bwd_bf16(void* const* grads, const int* heights,
                                          const int* widths, const int* strides,
                                          int n_levels, const void* grad_out,
                                          const float* rois, const int* levels,
                                          int B, int R, int C, int ph, int pw,
                                          void* stream) {
  return roi_align_bwd<__nv_bfloat16>(grads, heights, widths, strides, n_levels,
                                      static_cast<const __nv_bfloat16*>(grad_out), rois, levels, B, R, C,
                                      ph, pw, stream);
}
