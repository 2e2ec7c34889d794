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
//   dF_l[b, y, x, c] = sum over the RoIs r of level l and the bins (i, j) of
//                      Py[r, i, y] * Px[r, j, x] * g[b, r, i, j, c],
// and no gradient for the RoIs. It lives in this file so that both
// directions take their taps from the one axis_tap and roi_geometry. On this
// card the work is a scatter: one thread per element of g adds its 16
// weighted copies into a zero-filled channels-last dF with atomicAdd, in one
// launch for every level and image. The TPU kernels' chunked accumulators,
// window clustering, group masks and dense weight matmuls are not carried
// over. The atomics make the order of each sum, and so its last bits, vary
// from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kSampling = 2;
constexpr int kThreads = 256;
constexpr int kSlab = 64;    // forward: channels of a block
constexpr int kMaxPw = 8;    // forward: kSampling * 2 corners * pw lanes <= 32
constexpr int kStagePad = 4; // forward: floats between staged bins, for 16-byte rows off one bank

struct Levels {
  const float* feat[kMaxLevels];
  long long stride[kMaxLevels][4];  // forward: elements between neighbours along b, c, y, x
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride, exact (powers of two)
  int n;
};

// The levels of the backward: the geometry of `Levels` (its feature
// pointers unused) and where each level's gradient goes.
struct LevelsOut {
  Levels in;
  float* grad[kMaxLevels];
};

// Row (or column) index pair and weights of one sample along one axis, as
// _axis_weights computes them; the weights already carry 1/S and the
// out-of-range zeroing.
struct Tap {
  int lo, hi;
  float wlo, whi;
};

__device__ __forceinline__ Tap axis_tap(float start, float bin, int p, int s,
                                        int size) {
  const float step = __fadd_rn(static_cast<float>(p),
                               __fdiv_rn(__fadd_rn(static_cast<float>(s), 0.5f),
                                         static_cast<float>(kSampling)));
  const float coord = __fadd_rn(start, __fmul_rn(step, bin));
  const bool oob = coord < -1.f || coord > static_cast<float>(size);
  const float top = static_cast<float>(size - 1);
  const float c = fminf(fmaxf(coord, 0.f), top);  // NaN -> 0: never out of bounds
  const float lo = floorf(c);
  const float hi = fminf(__fadd_rn(lo, 1.f), top);
  const float lerp = __fsub_rn(c, lo);
  const float ws = oob ? 0.f : 1.f / kSampling;
  Tap t;
  t.lo = static_cast<int>(lo);
  t.hi = static_cast<int>(hi);
  t.wlo = __fmul_rn(__fsub_rn(1.f, lerp), ws);
  t.whi = __fmul_rn(lerp, ws);
  return t;
}

// One RoI on its level: the level id (clamped to the levels present), the
// box's start in feature coordinates (scaled by 1/stride, shifted by -0.5)
// and the bin sizes, in the plain version's operations and order.
struct Geometry {
  int level;
  float x1, y1, bin_h, bin_w;
};

__device__ __forceinline__ Geometry roi_geometry(const Levels& lv,
                                                 const float* __restrict__ rois,
                                                 const int* __restrict__ levels,
                                                 long long br, int ph, int pw) {
  Geometry g;
  const int l = levels[br];
  g.level = l < 0 ? 0 : (l >= lv.n ? lv.n - 1 : l);
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

// The element (b, r, i, j, c) that thread `idx` of a flat launch over
// B*R*ph*pw*C owns; br = b * R + r.
struct Element {
  int c, j, i, b;
  long long br;
};

__device__ __forceinline__ Element element_of(long long idx, int R, int C,
                                              int ph, int pw) {
  Element e;
  e.c = static_cast<int>(idx % C);
  long long rest = idx / C;
  e.j = static_cast<int>(rest % pw);
  rest /= pw;
  e.i = static_cast<int>(rest % ph);
  e.br = rest / ph;
  e.b = static_cast<int>(e.br / R);
  return e;
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
  const float* img = lv.feat[l] + (br / R) * lv.stride[l][0];
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

  // rows of C floats: this block's part of each bin's row, 16 bytes a lane
  float* dst = out + br * bins * (long long)C;
  if (C % 4 == 0) {
    for (int e = tid; e < bins * (kSlab / 4); e += kThreads) {
      const int bin = e / (kSlab / 4), c = c0 + 4 * (e % (kSlab / 4));
      if (c < C)
        *reinterpret_cast<float4*>(dst + (long long)bin * C + c) =
            *reinterpret_cast<const float4*>(stage + bin * row + (c - c0));
    }
  } else {
    for (int e = tid; e < bins * kSlab; e += kThreads) {
      const int bin = e / kSlab, c = c0 + e % kSlab;
      if (c < C) dst[(long long)bin * C + c] = stage[bin * row + (c - c0)];
    }
  }
}

// One thread per element (b, r, i, j, c) of g: its 2x2 samples' four
// corners each receive weight * g. Consecutive threads take consecutive
// channels, so each of the 16 atomicAdds of a warp lands on 32 consecutive
// floats of dF. An element of g that is exactly 0 (the rows that the loss
// weighs 0) adds nothing and is skipped, as is a sample outside the level.
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_kernel(LevelsOut lv, const float* __restrict__ grad,
                     const float* __restrict__ rois,
                     const int* __restrict__ levels, int B, int R, int C,
                     int ph, int pw) {
  const long long total = (long long)B * R * ph * pw * C;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const float gv = grad[idx];
  if (gv == 0.f) return;
  const Element e = element_of(idx, R, C, ph, pw);
  const Geometry g = roi_geometry(lv.in, rois, levels, e.br, ph, pw);
  const int H = lv.in.h[g.level], W = lv.in.w[g.level];

  float* d = lv.grad[g.level] + (size_t)e.b * H * W * C + e.c;
#pragma unroll
  for (int sy = 0; sy < kSampling; ++sy) {
    const Tap ty = axis_tap(g.y1, g.bin_h, e.i, sy, H);
    if (ty.wlo == 0.f && ty.whi == 0.f) continue;
    float* row_lo = d + (size_t)ty.lo * W * C;
    float* row_hi = d + (size_t)ty.hi * W * C;
    const float glo = __fmul_rn(ty.wlo, gv), ghi = __fmul_rn(ty.whi, gv);
#pragma unroll
    for (int sx = 0; sx < kSampling; ++sx) {
      const Tap tx = axis_tap(g.x1, g.bin_w, e.j, sx, W);
      if (tx.wlo == 0.f && tx.whi == 0.f) continue;
      atomicAdd(row_lo + (size_t)tx.lo * C, __fmul_rn(tx.wlo, glo));
      atomicAdd(row_lo + (size_t)tx.hi * C, __fmul_rn(tx.whi, glo));
      atomicAdd(row_hi + (size_t)tx.lo * C, __fmul_rn(tx.wlo, ghi));
      atomicAdd(row_hi + (size_t)tx.hi * C, __fmul_rn(tx.whi, ghi));
    }
  }
}

// Levels past n_levels repeat the last one, so that a clamped level id
// always finds a valid entry. feats and feat_strides may be null (the
// backward's).
Levels make_levels(const float* const* feats, const long long* feat_strides,
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
        roi_align_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (err) return err;
  }
  roi_align_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      lv, rois, levels, R, C, ph, pw, slabs, out);
  return static_cast<int>(cudaGetLastError());
}

// grads: n_levels device pointers to channels-last (B, H_l, W_l, C) f32,
// zero-filled by the caller, into which the kernel adds; grad_out
// (B, R, ph, pw, C) f32; the rest as for the forward. Launches on `stream`,
// does not synchronise, returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for more levels than the kernel holds.
extern "C" int basedet_roi_align_bwd(float* const* grads, const int* heights,
                                     const int* widths, const int* strides,
                                     int n_levels, const float* grad_out,
                                     const float* rois, const int* levels,
                                     int B, int R, int C, int ph, int pw,
                                     void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)B * R * ph * pw * C;
  if (total <= 0) return 0;
  LevelsOut lv;
  lv.in = make_levels(nullptr, nullptr, heights, widths, strides, n_levels);
  for (int l = 0; l < kMaxLevels; ++l)
    lv.grad[l] = grads[l < n_levels ? l : n_levels - 1];
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  roi_align_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lv, grad_out, rois, levels, B, R, C, ph, pw);
  return static_cast<int>(cudaGetLastError());
}
