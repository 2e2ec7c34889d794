// SimOTA dynamic-k matching for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces basedet_tpu/ops/matching_pallas.py::_matching_kernel. Same
// contract, over cost and ious (B, K, M) f32 and valid (B, K):
//   1. dk[g] = clip(int(sum of the k largest ious[g]), 1, k) for a valid row,
//      0 for an invalid one; the sum is f32, largest first, one add at a time;
//   2. each valid gt marks its dk lowest-cost anchors, the lowest anchor index
//      first among equal costs;
//   3. an anchor marked by several gts goes to the one of lowest cost, the
//      lowest gt index first among equal costs;
//   4. fg = marked by any; best_gt = that gt, and 0 where fg is false (the
//      Pallas kernel's and the scan version's argmin over an all-INF column).
// Costs must be finite (YOLOX's are at most ~2e9), as the reference assumes.
//
// What bounds it: bytes. Every row is read once (cost + ious, 2 x M x 4 B);
// the work per element is one compare against a running top-k. The Pallas
// kernel keeps a whole image in VMEM and runs 2k masked full passes over it;
// that does not carry over, so the selection is reorganised:
//   1. dk_select_kernel, one block of 256 threads per (image, gt row). An
//      invalid row exits at once (it marks nothing), so padded gts cost no
//      bytes. Each thread keeps, in registers, the k best of its strided
//      slice of the row twice: ious descending and costs ascending, each as
//      a 64-bit key (order-preserving float bits, then the anchor index), so
//      every comparison is exact and the index breaks ties. A warp merges its
//      32 lists by k rounds of a shuffle min; warp 0 merges the 8 warp lists
//      from shared memory the same way. Lane 0 sums the k ious in order for
//      dk; lanes r < dk each offer (cost bits, g) to their anchor with a
//      64-bit atomicMin: conflicts resolve to the lowest cost, then the
//      lowest g, exactly and in any order of arrival.
//   2. finalize_kernel, one thread per (image, anchor): decodes the winning
//      key into best_gt and fg.
// Exactness: -0.0 is folded onto +0.0 before its bits are taken, as the float
// comparison equates them, and the sum is __fadd_rn (file compiled with
// -fmad=false too). The plain version in basedet_tpu_torch/ops/
// matching_kernel.py is the scan formulation and agrees bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 10;  // candidate_topk of YOLOX and OTA
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kNone = ~0ull;

// Order-preserving map of a non-NaN f32 onto u32: a < b iff bits(a) < bits(b).
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

// list: ascending, kNone-padded; keeps the kMaxK smallest keys seen.
__device__ __forceinline__ void insert(unsigned long long (&list)[kMaxK],
                                       unsigned long long key) {
  if (key >= list[kMaxK - 1]) return;
  list[kMaxK - 1] = key;
#pragma unroll
  for (int j = kMaxK - 1; j > 0; --j) {
    const unsigned long long lo = umin64(list[j - 1], list[j]);
    list[j] = list[j - 1] ^ list[j] ^ lo;
    list[j - 1] = lo;
  }
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = umin64(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The k smallest keys over the 32 lanes' lists, ascending, into every lane's
// out[0..k); out[k..) = kNone. Keys are distinct (they carry the index), so
// exactly one lane pops each round. k is the same on every lane.
__device__ __forceinline__ void warp_merge(unsigned long long (&list)[kMaxK],
                                           int k,
                                           unsigned long long (&out)[kMaxK]) {
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    out[r] = kNone;
    if (r < k) {
      const unsigned long long m = warp_min(list[0]);
      if (m != kNone && list[0] == m) {
#pragma unroll
        for (int j = 0; j < kMaxK - 1; ++j) list[j] = list[j + 1];
        list[kMaxK - 1] = kNone;
      }
      out[r] = m;
    }
  }
}

// The block's k smallest keys into warp 0's out (other warps: undefined).
__device__ __forceinline__ void block_merge(
    unsigned long long (&list)[kMaxK], int k, unsigned long long (&out)[kMaxK],
    unsigned long long (*stage)[kMaxK]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_merge(list, k, out);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) stage[warp][j] = out[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) list[j] = lane < kWarps ? stage[lane][j] : kNone;
    warp_merge(list, k, out);
  }
}

__global__ void __launch_bounds__(kThreads)
dk_select_kernel(const float* __restrict__ cost, const float* __restrict__ ious,
                 const unsigned char* __restrict__ valid, int K, int M, int k,
                 unsigned long long* __restrict__ best_key) {
  const int row = blockIdx.x;  // b * K + g
  if (!valid[row]) return;
  const int g = row % K;
  const float* c = cost + (size_t)row * M;
  const float* u = ious + (size_t)row * M;

  unsigned long long top_iou[kMaxK], top_cost[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) top_iou[j] = top_cost[j] = kNone;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    // largest iou first: the complement of its bits ascends as it descends
    insert(top_iou, ((unsigned long long)(~ordered_bits(u[m])) << 32) | (uint32_t)m);
    insert(top_cost, ((unsigned long long)ordered_bits(c[m]) << 32) | (uint32_t)m);
  }

  __shared__ unsigned long long stage[2][kWarps][kMaxK];
  unsigned long long best_iou[kMaxK], best_cost[kMaxK];
  block_merge(top_iou, k, best_iou, stage[0]);
  block_merge(top_cost, k, best_cost, stage[1]);
  if (threadIdx.x >= 32) return;

  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r)
    if (r < k) s = __fadd_rn(s, from_ordered_bits(~(uint32_t)(best_iou[r] >> 32)));
  int dk = (int)s;  // truncation, as astype(int32)
  dk = dk < 1 ? 1 : (dk > k ? k : dk);

  const int lane = threadIdx.x;
  unsigned long long* col = best_key + (size_t)(row / K) * M;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (lane == r && r < dk) {
      const uint32_t anchor = (uint32_t)best_cost[r];
      atomicMin(col + anchor, (best_cost[r] & 0xffffffff00000000ull) | (uint32_t)g);
    }
  }
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ best_key,
                                size_t n, int* __restrict__ best_gt,
                                unsigned char* __restrict__ fg) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = best_key[i];
  const bool hit = key != kNone;
  fg[i] = hit;
  best_gt[i] = hit ? (int)(uint32_t)key : 0;
}

}  // namespace

// cost, ious (B, K, M) f32, valid (B, K) bool as bytes, best_key scratch
// (B, M) u64, best_gt (B, M) i32, fg (B, M) bool as bytes; all contiguous on
// the device; 1 <= k <= 10, k <= M. Launches on `stream`, does not
// synchronise, returns the first CUDA error (0 on success).
extern "C" int basedet_dynamic_k_matching(const float* cost, const float* ious,
                                          const unsigned char* valid, int B,
                                          int K, int M, int k,
                                          unsigned long long* best_key,
                                          int* best_gt, unsigned char* fg,
                                          void* stream) {
  if (B <= 0 || K <= 0 || M <= 0) return 0;
  if (k < 1 || k > kMaxK || k > M) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)B * M;

  cudaError_t err = cudaMemsetAsync(best_key, 0xff, n * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dk_select_kernel<<<B * K, kThreads, 0, s>>>(cost, ious, valid, K, M, k, best_key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  finalize_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      best_key, n, best_gt, fg);
  return static_cast<int>(cudaGetLastError());
}
