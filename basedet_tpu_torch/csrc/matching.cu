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
// What bounds it: bytes. Every valid row is read once (cost + ious, 2 x M x
// 4 B); the work per element is a few compares. With 3 valid gts an image
// there are few rows, so what the card sees is the chain of dependent steps
// inside one row. The Pallas kernel keeps a whole image in VMEM and runs 2k
// masked full passes over it; that does not carry over. Here one launch
// does everything:
//   1. match_kernel, one block of 1024 threads per (image, gt row), so that
//      each pass over a row is a few steps a thread. An
//      invalid row goes straight to step 3. A valid row is read once into
//      32-bit keys that order like the values (order-preserving float bits,
//      complemented for the ious so that the largest comes first; -0.0
//      folded onto +0.0, as the float comparison equates them): into shared
//      memory where the row fits (M <= kMaxStaged), and the histograms of
//      both keys' top 8 bits are taken on the way. Past kMaxStaged the row
//      is streamed: every pass reads it from global memory again.
//   2. The k largest ious and the dk lowest costs come from a radix select:
//      8-bit digit histograms in shared memory, from the top digit down,
//      each keeping the bucket that holds the wanted rank, until a bucket
//      holds exactly the ranks still wanted or all 32 bits are fixed.
//      Where a warp's keys share a digit (the top digit of most rows) its
//      increments go in as one shared atomic. The ious above
//      the threshold, plus copies of it, are summed by one thread in
//      descending order for dk. Costs at the threshold, when more of them tie
//      than are wanted, go to the lowest indices: each thread counts the ties
//      in a contiguous run of the row, a block scan gives each run its first
//      rank. Each chosen anchor gets a 64-bit atomicMin of (cost key, g) into
//      the image's column of keys: conflicts resolve to the lowest cost, then
//      the lowest g, exactly and in any order of arrival.
//   3. Each image has a done-counter. The block that finds itself the
//      image's last (after a __threadfence) decodes its keys into best_gt and
//      fg, puts kNone back in them and sets the counter back to 0, so the
//      scratch (cached by the caller across calls) is ready for the next
//      call: no memset and no second kernel.
// Exactness: the sum is __fadd_rn (file compiled with -fmad=false too). The
// plain version in basedet_tpu_torch/ops/matching_kernel.py is the scan
// formulation and agrees bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 10;  // candidate_topk of YOLOX and OTA
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;  // 8-bit digits
constexpr int kMaxStaged = 16384;  // longest row kept in shared memory: 2 x 64 KB of keys
constexpr unsigned long long kNone = ~0ull;

// Order-preserving map of a non-NaN f32 onto u32: a < b iff bits(a) < bits(b).
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The keys of one row: 0 = ious (largest first), 1 = costs (lowest first),
// from shared memory (kStaged) or from the row itself.
template <bool kStaged>
struct Row {
  const float* cost;
  const float* ious;
  const uint32_t* staged;  // [0, M) ious' keys, [M, 2M) costs'
  int M;

  __device__ __forceinline__ uint32_t key(int which, int m) const {
    if (kStaged) return staged[which * M + m];
    return which ? ordered_bits(cost[m]) : ~ordered_bits(ious[m]);
  }
};

// hist[digit] += 1 for each active lane. Where all the warp's active lanes
// share a digit (the top digit of most rows, or one crowded digit), one lane
// adds them all; otherwise each adds its own. Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t digit, bool active) {
  const unsigned voters = __ballot_sync(0xffffffffu, active);
  if (voters == 0u) return;
  const int leader = __ffs(voters) - 1;
  const uint32_t first = __shfl_sync(0xffffffffu, digit, leader);
  const unsigned same = __ballot_sync(0xffffffffu, active && digit == first);
  if (same == voters) {
    if ((threadIdx.x & 31) == leader) atomicAdd(hist + first, __popc(voters));
  } else if (active) {
    atomicAdd(hist + digit, 1u);
  }
}

// Block-wide inclusive scan of one int a thread; warp_sums holds kWarps ints.
__device__ __forceinline__ int block_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  // the warps' totals, scanned by every warp: its offset is the sum before it
  int t = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, t, off);
    if (lane >= off) t += n;
  }
  v += warp > 0 ? __shfl_sync(0xffffffffu, t, warp - 1) : 0;
  __syncthreads();
  return v;
}

// Where a radix select stands: the keys whose bits under `mask` are below
// `prefix` are taken; of the `group` keys equal to it there, `want` more.
struct Select {
  uint32_t prefix, mask;
  int want, group;
};

struct Shared {
  uint32_t hist0[2][kDigits];  // top digit of the ious' and the costs' keys
  uint32_t hist[kDigits];
  int warp_sums[kWarps];
  int bucket[3];  // digit, ranks before it, keys in it
  uint32_t top[kMaxK];
  int n_top;
  int dk;
  bool last;
};

// The keys of rank `want` (1-based, lowest first) among the row's keys
// `which`, digit by digit, starting from the top digit's histogram `hist0`.
template <bool kStaged>
__device__ Select radix_select(const Row<kStaged>& row, int which, int want,
                               const uint32_t* hist0, Shared& sh) {
  Select s{0u, 0u, want, 0};
  const uint32_t* hist = hist0;
  for (int shift = 24;; shift -= 8) {
    if (shift != 24) {
      if (threadIdx.x < kDigits) sh.hist[threadIdx.x] = 0;
      __syncthreads();
      for (int base = 0; base < row.M; base += kThreads) {
        const int m = base + threadIdx.x;
        const uint32_t k = m < row.M ? row.key(which, m) : 0u;
        hist_add(sh.hist, (k >> shift) & 0xffu, m < row.M && (k & s.mask) == s.prefix);
      }
      __syncthreads();
      hist = sh.hist;
    }
    const int h = threadIdx.x < kDigits ? static_cast<int>(hist[threadIdx.x]) : 0;
    const int incl = block_scan(h, sh.warp_sums);
    if (incl - h < s.want && s.want <= incl) {
      sh.bucket[0] = threadIdx.x;
      sh.bucket[1] = incl - h;
      sh.bucket[2] = h;
    }
    __syncthreads();
    s.prefix |= static_cast<uint32_t>(sh.bucket[0]) << shift;
    s.mask |= 0xffu << shift;
    s.want -= sh.bucket[1];
    s.group = sh.bucket[2];
    __syncthreads();  // bucket read before the next pass may write it
    if (s.group == s.want || shift == 0) return s;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
match_kernel(const float* __restrict__ cost, const float* __restrict__ ious,
             const unsigned char* __restrict__ valid, int K, int M, int k,
             unsigned long long* __restrict__ keys, unsigned int* __restrict__ done,
             int* __restrict__ best_gt, unsigned char* __restrict__ fg) {
  extern __shared__ uint32_t staged[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, row_id = blockIdx.x, b = row_id / K, g = row_id % K;
  unsigned long long* col = keys + (size_t)b * M;

  if (valid[row_id]) {
    const Row<kStaged> row{cost + (size_t)row_id * M, ious + (size_t)row_id * M, staged, M};
    if (tid < kDigits) sh.hist0[0][tid] = sh.hist0[1][tid] = 0;
    __syncthreads();
#pragma unroll 4
    for (int base = 0; base < M; base += kThreads) {
      const int m = base + tid;
      const bool in = m < M;
      const uint32_t ku = in ? ~ordered_bits(row.ious[m]) : 0u;
      const uint32_t kc = in ? ordered_bits(row.cost[m]) : 0u;
      if (kStaged && in) {
        staged[m] = ku;
        staged[M + m] = kc;
      }
      hist_add(sh.hist0[0], ku >> 24, in);
      hist_add(sh.hist0[1], kc >> 24, in);
    }
    __syncthreads();

    // dk: the k largest ious, summed largest first
    const Select si = radix_select(row, 0, k, sh.hist0[0], sh);
    if (tid == 0) sh.n_top = 0;
    __syncthreads();
    const bool whole = si.group == si.want;  // else all 32 bits fixed: the ties are equal
    for (int base = 0; base < M; base += kThreads) {
      const int m = base + tid;
      if (m >= M) break;
      const uint32_t key = row.key(0, m), masked = key & si.mask;
      if (masked < si.prefix || (whole && masked == si.prefix)) sh.top[atomicAdd(&sh.n_top, 1)] = key;
    }
    __syncthreads();
    if (tid == 0) {
      int n = sh.n_top;
      while (n < k) sh.top[n++] = si.prefix;
      for (int a = 1; a < k; ++a) {  // ascending keys: descending ious
        const uint32_t v = sh.top[a];
        int z = a;
        for (; z > 0 && sh.top[z - 1] > v; --z) sh.top[z] = sh.top[z - 1];
        sh.top[z] = v;
      }
      float sum = 0.0f;
      for (int r = 0; r < k; ++r) sum = __fadd_rn(sum, from_ordered_bits(~sh.top[r]));
      const int dk = static_cast<int>(sum);  // truncation, as astype(int32)
      sh.dk = dk < 1 ? 1 : (dk > k ? k : dk);
    }
    __syncthreads();

    // the dk lowest costs, the lowest index first at the threshold
    const Select sc = radix_select(row, 1, sh.dk, sh.hist0[1], sh);
    const bool all = sc.group == sc.want;
    for (int base = 0; base < M; base += kThreads) {
      const int m = base + tid;
      if (m >= M) break;
      const uint32_t key = row.key(1, m), masked = key & sc.mask;
      if (masked < sc.prefix || (all && masked == sc.prefix))
        atomicMin(col + m, (static_cast<unsigned long long>(key) << 32) | static_cast<uint32_t>(g));
    }
    if (!all) {  // more keys equal the threshold than are wanted
      const int run = (M + kThreads - 1) / kThreads, lo = min(M, tid * run), hi = min(M, lo + run);
      int ties = 0;
      for (int m = lo; m < hi; ++m) ties += row.key(1, m) == sc.prefix;
      int rank = block_scan(ties, sh.warp_sums) - ties;
      for (int m = lo; m < hi && rank < sc.want; ++m) {
        if (row.key(1, m) != sc.prefix) continue;
        atomicMin(col + m, (static_cast<unsigned long long>(sc.prefix) << 32) | static_cast<uint32_t>(g));
        ++rank;
      }
    }
  }

  // the image's last block decodes its keys and resets the scratch
  __threadfence();
  __syncthreads();
  if (tid == 0) sh.last = atomicAdd(done + b, 1u) == static_cast<unsigned>(K - 1);
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  for (int m = tid; m < M; m += kThreads) {
    const unsigned long long key = __ldcg(col + m);
    const bool hit = key != kNone;
    fg[(size_t)b * M + m] = hit;
    best_gt[(size_t)b * M + m] = hit ? static_cast<int>(static_cast<uint32_t>(key)) : 0;
    col[m] = kNone;
  }
  if (tid == 0) done[b] = 0;
}

}  // namespace

// cost, ious (B, K, M) f32, valid (B, K) bool as bytes; keys (B, M) u64 at
// kNone and done (B) u32 at 0, which the kernel leaves so; best_gt (B, M)
// i32, fg (B, M) bool as bytes; all contiguous on the device; 1 <= k <= 10,
// k <= M, B * K < 2^31. Launches once on `stream`, does not synchronise,
// returns the first CUDA error (0 on success).
extern "C" int basedet_dynamic_k_matching(const float* cost, const float* ious,
                                          const unsigned char* valid, int B,
                                          int K, int M, int k,
                                          unsigned long long* keys,
                                          unsigned int* done, int* best_gt,
                                          unsigned char* fg, void* stream) {
  if (B <= 0 || K <= 0 || M <= 0) return 0;
  if (k < 1 || k > kMaxK || k > M || (long long)B * K > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(B * K);
  if (M <= kMaxStaged) {
    const size_t smem = sizeof(uint32_t) * 2 * (size_t)M;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          match_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    match_kernel<true><<<blocks, kThreads, smem, s>>>(cost, ious, valid, K, M, k, keys, done, best_gt, fg);
  } else {
    match_kernel<false><<<blocks, kThreads, 0, s>>>(cost, ious, valid, K, M, k, keys, done, best_gt, fg);
  }
  return static_cast<int>(cudaGetLastError());
}
