// The port's host library: the batch pack of the pad collator and the
// greedy COCO matcher of the evaluator (the port's own copy of the JAX
// package's native_ops.cpp).
//
// The pack pads B variable-size HWC images into one NHWC canvas in one pass:
// each output row is a memcpy of the source row plus a fill of the tail, or
// a pure fill, with the DETR valid-pixel mask written in the same pass;
// ``num_threads`` OpenMP threads share the (image, row) pairs. A forked
// DataLoader worker passes 1, so that no OpenMP team inherited through the
// fork is ever woken.
//
// Built by basedet_tpu_torch/native/build.py with c++ -O3 -fopenmp at first
// use; called through ctypes. Every function returns 0 on success.

#include <cstdint>
#include <cstring>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

template <typename T>
int pack_batch(const T* const* imgs, const int32_t* hw, int64_t B,
               int64_t H, int64_t W, int64_t C, T pad, T* out,
               uint8_t* mask_out, int num_threads) {
  if (B < 0 || H <= 0 || W <= 0 || C <= 0 || num_threads < 1) return 1;
  for (int64_t b = 0; b < B; ++b)
    if (hw[2 * b] < 0 || hw[2 * b] > H || hw[2 * b + 1] < 0 || hw[2 * b + 1] > W) return 2;
  const int64_t row = W * C;
  const int64_t img_stride = H * row;
#if defined(_OPENMP)
#pragma omp parallel for collapse(2) schedule(static) num_threads(num_threads) if (num_threads > 1)
#endif
  for (int64_t b = 0; b < B; ++b) {
    for (int64_t y = 0; y < H; ++y) {
      const int64_t h = hw[2 * b];
      const int64_t w = hw[2 * b + 1];
      T* dst = out + b * img_stride + y * row;
      if (y < h) {
        const T* src = imgs[b] + y * w * C;
        std::memcpy(dst, src, sizeof(T) * w * C);
        std::fill(dst + w * C, dst + row, pad);
      } else {
        std::fill(dst, dst + row, pad);
      }
      if (mask_out != nullptr) {
        uint8_t* m = mask_out + b * H * W + y * W;
        if (y < h) {
          std::memset(m, 1, (size_t)w);
          std::memset(m + w, 0, (size_t)(W - w));
        } else {
          std::memset(m, 0, (size_t)W);
        }
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

int pack_batch_u8(const uint8_t* const* imgs, const int32_t* hw, int64_t B,
                  int64_t H, int64_t W, int64_t C, uint8_t pad, uint8_t* out,
                  uint8_t* mask_out, int num_threads) {
  return pack_batch<uint8_t>(imgs, hw, B, H, W, C, pad, out, mask_out, num_threads);
}

int pack_batch_f32(const float* const* imgs, const int32_t* hw, int64_t B,
                   int64_t H, int64_t W, int64_t C, float pad, float* out,
                   uint8_t* mask_out, int num_threads) {
  return pack_batch<float>(imgs, hw, B, H, W, C, pad, out, mask_out, num_threads);
}

int native_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// COCO greedy detection<->gt matching across all IoU thresholds, the hot
// loop of COCOeval; evaluators/coco_metrics.py::_match_python is its plain
// version, with the same semantics.
//
// ious:     (D, G) row-major, crowd-adjusted
// g_ignore: (G,) 1 = ignored gt (crowd / outside area range); gts MUST be
//           sorted non-ignored-first (the caller does this)
// iscrowd:  (G,)
// thrs:     (T,) IoU thresholds
// outputs:  dt_m (T, D) matched gt index + 1, gt_m (T, G) matched det
//           index + 1, dt_ig (T, D) matched-to-ignored flag
int match_dets(const double* ious, const int32_t* g_ignore,
               const int32_t* iscrowd, int64_t D, int64_t G,
               const double* thrs, int64_t T, int64_t* dt_m, int64_t* gt_m,
               int32_t* dt_ig) {
  if (D < 0 || G < 0 || T < 0) return 1;
  std::memset(dt_m, 0, sizeof(int64_t) * T * D);
  std::memset(gt_m, 0, sizeof(int64_t) * T * G);
  std::memset(dt_ig, 0, sizeof(int32_t) * T * D);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t t = 0; t < T; ++t) {
    int64_t* dtm = dt_m + t * D;
    int64_t* gtm = gt_m + t * G;
    int32_t* dti = dt_ig + t * D;
    for (int64_t d = 0; d < D; ++d) {
      double best = thrs[t] < 1.0 - 1e-10 ? thrs[t] : 1.0 - 1e-10;
      int64_t best_g = -1;
      const double* row = ious + d * G;
      for (int64_t g = 0; g < G; ++g) {
        if (gtm[g] > 0 && !iscrowd[g]) continue;
        if (best_g > -1 && g_ignore[best_g] == 0 && g_ignore[g] == 1) break;
        if (row[g] < best) continue;
        best = row[g];
        best_g = g;
      }
      if (best_g == -1) continue;
      dti[d] = g_ignore[best_g];
      dtm[d] = best_g + 1;
      gtm[best_g] = d + 1;
    }
  }
  return 0;
}

// Batched COCO evaluation for one area range over many (image, category)
// pairs in a single call: computes per-gt ignore flags, the
// non-ignored-first gt ordering, the greedy per-threshold matching, and the
// det out-of-range ignore merge, with no Python or ctypes call per pair,
// the pairs spread over OpenMP threads.
//
// Inputs are concatenated per pair i (dets already score-sorted + capped):
//   D[i], G[i]            sizes; iou block i is D[i] x G[i] row-major at
//                         iou_off[i] (computed by the caller)
//   d_areas / g_areas / iscrowd   concat at d_off[i] / g_off[i]
// Outputs (caller-allocated, zero-init NOT required):
//   dt_matched (T x D[i] int8 at T*d_off[i]) 1 = matched to a real gt
//   dt_ignore  (T x D[i] int8)               1 = ignored detection
//   num_gt     (n_pairs)                     non-ignored gt count
int coco_match_area(
    int64_t n_pairs, const int64_t* D, const int64_t* G,
    const int64_t* iou_off, const int64_t* d_off, const int64_t* g_off,
    const double* ious, const double* d_areas, const double* g_areas,
    const int32_t* iscrowd, double area_lo, double area_hi,
    const double* thrs, int64_t T, int8_t* dt_matched, int8_t* dt_ignore,
    int64_t* num_gt) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t i = 0; i < n_pairs; ++i) {
    const int64_t d_n = D[i], g_n = G[i];
    const double* iou = ious + iou_off[i];
    const double* da = d_areas + d_off[i];
    const double* ga = g_areas + g_off[i];
    const int32_t* crowd = iscrowd + g_off[i];
    int8_t* dtm = dt_matched + T * d_off[i];
    int8_t* dti = dt_ignore + T * d_off[i];

    // per-gt ignore + stable non-ignored-first order
    int64_t order[1024];
    int8_t gig[1024];
    int64_t gmatch[1024];
    int64_t n = 0;
    if (g_n > 1024) {  // over the capacity: the caller takes the per-pair path
      num_gt[i] = -1;
      continue;
    }
    for (int64_t g = 0; g < g_n; ++g)
      if (!(crowd[g] > 0 || ga[g] < area_lo || ga[g] > area_hi))
        order[n++] = g;
    int64_t n_real = n;
    for (int64_t g = 0; g < g_n; ++g)
      if (crowd[g] > 0 || ga[g] < area_lo || ga[g] > area_hi) order[n++] = g;
    for (int64_t k = 0; k < g_n; ++k) gig[k] = k < n_real ? 0 : 1;
    num_gt[i] = n_real;

    for (int64_t t = 0; t < T; ++t) {
      for (int64_t k = 0; k < g_n; ++k) gmatch[k] = 0;
      int8_t* dtm_t = dtm + t * d_n;
      int8_t* dti_t = dti + t * d_n;
      for (int64_t d = 0; d < d_n; ++d) {
        double best = thrs[t] < 1.0 - 1e-10 ? thrs[t] : 1.0 - 1e-10;
        int64_t best_k = -1;
        const double* row = iou + d * g_n;
        for (int64_t k = 0; k < g_n; ++k) {
          const int64_t g = order[k];
          if (gmatch[k] > 0 && !crowd[g]) continue;
          if (best_k > -1 && gig[best_k] == 0 && gig[k] == 1) break;
          if (row[g] < best) continue;
          best = row[g];
          best_k = k;
        }
        if (best_k == -1) {
          // unmatched: ignored if outside the area range
          dtm_t[d] = 0;
          dti_t[d] = (da[d] < area_lo || da[d] > area_hi) ? 1 : 0;
          continue;
        }
        dti_t[d] = gig[best_k];
        dtm_t[d] = 1;
        gmatch[best_k] = d + 1;
      }
    }
  }
  return 0;
}

}  // extern "C"
