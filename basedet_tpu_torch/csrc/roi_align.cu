// Multilevel RoIAlign forward for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces the two Pallas forwards of the JAX package, which compute one
// function: basedet_tpu/ops/roi_align_window.py::_fwd_kernel_win (Morton-
// clustered windows, reached via pool_rois_window) and
// basedet_tpu/ops/roi_align_pallas.py::_fwd_kernel (the dense separable
// fallback). That function is multilevel_roi_align_batched
// (roi_align_separable.py): bilinear RoIAlign, average, aligned (-0.5 after
// scaling by 1/stride), sampling ratio 2, each RoI pooled from the one FPN
// level its id names. A sample with a coordinate < -1 or > size adds 0 but
// the bin still divides by S*S; coordinates clamp to [0, size-1] and
// hi = min(lo + 1, size - 1).
//
// Layout: features channels-last (B, H_l, W_l, C) per level, f32; rois
// (B, R, 4) xyxy in image coordinates; level ids (B, R) int32, computed once
// by the caller (the plain roi_level_assignment) so that the kernel and its
// plain version agree on the level by construction; output
// (B, R, ph, pw, C) f32, the JAX package's layout, which the box head
// flattens in (h, w, c) order.
//
// What bounds it: bytes. One launch does every level and every image; one
// thread computes one output element (b, r, i, j, c) from 2x2 samples x 4
// corners, all in f32 registers. Consecutive threads take consecutive
// channels, so every corner read and every output write is a coalesced run
// of C floats; neighbouring bins share corners, which L2 serves. The TPU's
// separable matmuls (dense weight matrices to ride the MXU) are not carried
// over: on this card the work is a gather, and the dense form would do
// ~H x more arithmetic.
//
// Agreement with the plain version: sample coordinates are computed with
// the plain version's operations in its order (compiled with -fmad=false,
// so no FMA contracts them), which keeps lo, hi and the lerp weights
// identical; only the order of the 16 products' sum differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kSampling = 2;
constexpr int kThreads = 256;

struct Levels {
  const float* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride, exact (powers of two)
  int n;
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

__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(Levels lv, const float* __restrict__ rois,
                     const int* __restrict__ levels, int B, int R, int C,
                     int ph, int pw, float* __restrict__ out) {
  const long long total = (long long)B * R * ph * pw * C;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % C);
  long long rest = idx / C;
  const int j = static_cast<int>(rest % pw);
  rest /= pw;
  const int i = static_cast<int>(rest % ph);
  const long long br = rest / ph;  // b * R + r
  const int b = static_cast<int>(br / R);

  int l = levels[br];
  l = l < 0 ? 0 : (l >= lv.n ? lv.n - 1 : l);
  const int H = lv.h[l], W = lv.w[l];
  const float sc = lv.scale[l];
  const float* roi = rois + br * 4;
  const float x1 = __fsub_rn(__fmul_rn(roi[0], sc), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(roi[1], sc), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], sc), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], sc), 0.5f);
  const float bin_h = __fdiv_rn(__fsub_rn(y2, y1), static_cast<float>(ph));
  const float bin_w = __fdiv_rn(__fsub_rn(x2, x1), static_cast<float>(pw));

  const float* f = lv.feat[l] + (size_t)b * H * W * C + c;
  float acc = 0.f;
#pragma unroll
  for (int sy = 0; sy < kSampling; ++sy) {
    const Tap ty = axis_tap(y1, bin_h, i, sy, H);
    const float* row_lo = f + (size_t)ty.lo * W * C;
    const float* row_hi = f + (size_t)ty.hi * W * C;
#pragma unroll
    for (int sx = 0; sx < kSampling; ++sx) {
      const Tap tx = axis_tap(x1, bin_w, j, sx, W);
      const float top = __fadd_rn(__fmul_rn(tx.wlo, __ldg(row_lo + (size_t)tx.lo * C)),
                                  __fmul_rn(tx.whi, __ldg(row_lo + (size_t)tx.hi * C)));
      const float bot = __fadd_rn(__fmul_rn(tx.wlo, __ldg(row_hi + (size_t)tx.lo * C)),
                                  __fmul_rn(tx.whi, __ldg(row_hi + (size_t)tx.hi * C)));
      acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(ty.wlo, top), __fmul_rn(ty.whi, bot)));
    }
  }
  out[idx] = acc;
}

}  // namespace

// feats: n_levels device pointers to channels-last (B, H_l, W_l, C) f32;
// heights, widths, strides: n_levels host ints; rois (B, R, 4) f32, levels
// (B, R) int32, out (B, R, ph, pw, C) f32, all contiguous on the device.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for more levels than the kernel
// holds.
extern "C" int basedet_roi_align_fwd(const float* const* feats,
                                     const int* heights, const int* widths,
                                     const int* strides, int n_levels,
                                     const float* rois, const int* levels,
                                     int B, int R, int C, int ph, int pw,
                                     float* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)B * R * ph * pw * C;
  if (total <= 0) return 0;
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < n_levels ? l : n_levels - 1;
    lv.feat[l] = feats[k];
    lv.h[l] = heights[k];
    lv.w[l] = widths[k];
    lv.scale[l] = 1.f / static_cast<float>(strides[k]);
  }
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  roi_align_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lv, rois, levels, B, R, C, ph, pw, out);
  return static_cast<int>(cudaGetLastError());
}
