// Greedy hard-NMS keep mask for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces basedet_tpu/ops/nms_pallas.py::_nms_kernel. Same contract: over
// boxes already sorted by descending score, keep[i] = valid[i] and no kept
// j < i has inter > t * max(union, 1e-12). Invalid boxes are never kept and
// so never suppress; they may sit anywhere in the order.
//
// What bounds it on this card: not bytes (5000 boxes are 80 KB) and not the
// pairwise tests (12.5 M at K = 5000, a few microseconds over 132 SMs) but
// the chain of dependent keep decisions: box i's fate waits on every kept box
// before it. A first version resolved one box per round of two block
// barriers (2K rounds, 0.63 ms at K = 5000). This one resolves 64 boxes per
// round:
//   1. nms_mask_kernel, fully parallel: grid (ceil(K/64), ceil(K/64), B) of
//      64 threads. Each block stages 64 column boxes in shared memory and
//      thread i writes one 64-bit word: the bits j > i that i would suppress.
//      Blocks below the diagonal hold only j < i and rows of invalid boxes
//      are never kept: the sweep reads neither, so neither is computed.
//   2. nms_sweep_kernel, one block per image, one round per 64-box word w:
//      every warp loads the word's 64 diagonal mask words (prefetched a round
//      ahead) and its `removed` word, and resolves the 64 decisions in
//      registers with no block barrier: up to four Jacobi rounds (kept = the
//      candidates minus what the kept rows suppress, a warp OR-reduction
//      each), which settle where few boxes suppress each other, else one
//      kept box at a time by shuffles; every warp gets the same kept-bit
//      word. Then each thread ORs the kept rows into the `removed` words it
//      owns (w' > w, word-parallel and coalesced), sixteen rows' loads in
//      flight at a time. One barrier ends the round: a word whose boxes are
//      all removed or invalid costs that barrier alone.
//   ceil(K/64) barrier rounds in place of 2K.
// The TPU kernel's 256-tiles and (4, Kp) lane layout are not carried over;
// its Jacobi fixpoint survives inside a word, ahead of the exact walk.
//
// Exactness: the predicate is evaluated with round-to-nearest intrinsics so
// that `area_i + area_j - inter` is never contracted into an FMA (the file is
// also compiled with -fmad=false). The plain PyTorch version in
// basedet_tpu_torch/ops/nms_kernel.py evaluates the same operations in the
// same order, so the two agree bit for bit, ties and the threshold boundary
// included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;    // boxes per column block == bits per mask word
constexpr int kBatch = 16;    // kept rows whose loads are in flight together
constexpr int kJacobi = 4;    // Jacobi rounds tried on a word before the one-by-one walk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// inter > t * max(union, 1e-12), as in nms_pallas.py:51-57.
__device__ __forceinline__ bool suppresses(float4 a, float4 b, float t) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  return inter > __fmul_rn(t, fmaxf(uni, 1e-12f));
}

__global__ void __launch_bounds__(kBlock) nms_mask_kernel(const float4* __restrict__ boxes,
                                                          const unsigned char* __restrict__ valid,
                                                          int K, int words, float t,
                                                          unsigned long long* __restrict__ mask) {
  const int col_blk = blockIdx.x;
  const int row_blk = blockIdx.y;
  if (col_blk < row_blk) return;  // every j < i: never read by the sweep
  const int b = blockIdx.z;
  const float4* img = boxes + (size_t)b * K;

  __shared__ float4 cols[kBlock];
  const int col0 = col_blk * kBlock;
  const int ncols = min(kBlock, K - col0);
  if (threadIdx.x < ncols) cols[threadIdx.x] = img[col0 + threadIdx.x];
  __syncthreads();

  const int i = row_blk * kBlock + threadIdx.x;
  if (i >= K || !valid[(size_t)b * K + i]) return;  // an invalid row is never kept, never read
  const float4 me = img[i];
  unsigned long long bits = 0ull;
  const int j0 = (col_blk == row_blk) ? threadIdx.x + 1 : 0;
  for (int jj = j0; jj < ncols; ++jj)
    if (suppresses(me, cols[jj], t)) bits |= 1ull << jj;
  mask[((size_t)b * K + i) * words + col_blk] = bits;
}

// The valid bits of word w: lane l reads boxes 64w + l and 64w + 32 + l.
__device__ __forceinline__ void load_word_inputs(const unsigned char* v,
                                                 const unsigned long long* rows, int K,
                                                 int words, int w, int lane, bool& v_lo,
                                                 bool& v_hi, unsigned long long& d_lo,
                                                 unsigned long long& d_hi) {
  const int i0 = w * kBlock;
  v_lo = i0 + lane < K && v[i0 + lane];
  v_hi = i0 + 32 + lane < K && v[i0 + 32 + lane];
  // diagonal words of rows 64w + 2l and 64w + 2l + 1; only kept rows are read back
  const int r0 = i0 + 2 * lane;
  d_lo = r0 < K ? rows[(size_t)r0 * words + w] : 0ull;
  d_hi = r0 + 1 < K ? rows[(size_t)(r0 + 1) * words + w] : 0ull;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const unsigned char* __restrict__ valid, int K, int words,
                                 unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];  // words, then a 64-byte list per warp
  unsigned char* lists = reinterpret_cast<unsigned char*>(removed + words);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned char* v = valid + (size_t)b * K;
  const unsigned long long* rows = mask + (size_t)b * K * words;
  unsigned char* out = keep + (size_t)b * K;

  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ull;
  bool v_lo, v_hi;
  unsigned long long d_lo, d_hi;
  // valid flags are read before any diagonal word: a row's word exists only if it is valid
  load_word_inputs(v, rows, K, words, 0, lane, v_lo, v_hi, d_lo, d_hi);
  __syncthreads();

  for (int w = 0; w < words; ++w) {
    // 1. this warp's copy of the word's 64 decisions, in registers
    const unsigned long long valid_bits =
        (unsigned long long)__ballot_sync(kFull, v_lo) |
        ((unsigned long long)__ballot_sync(kFull, v_hi) << 32);
    const unsigned long long cur_lo = d_lo, cur_hi = d_hi;
    if (w + 1 < words) load_word_inputs(v, rows, K, words, w + 1, lane, v_lo, v_hi, d_lo, d_hi);
    const unsigned long long cand0 = valid_bits & ~removed[w];
    // Jacobi rounds first: kept = cand0 minus what the kept rows suppress, each lane ORing its
    // two rows in; a fixed point is the greedy result (the diagonal words hold only bits
    // j > i, so the greedy equations have one solution). Words with few suppressions, where
    // most boxes are kept, settle in two or three rounds.
    unsigned long long kept = cand0;
    bool settled = false;
    for (int r = 0; r < kJacobi && !settled; ++r) {
      const unsigned long long mine = (((kept >> (2 * lane)) & 1ull) ? cur_lo : 0ull) |
                                      (((kept >> (2 * lane + 1)) & 1ull) ? cur_hi : 0ull);
      const unsigned long long sup =
          (unsigned long long)__reduce_or_sync(kFull, (unsigned)mine) |
          ((unsigned long long)__reduce_or_sync(kFull, (unsigned)(mine >> 32)) << 32);
      const unsigned long long next = cand0 & ~sup;
      settled = next == kept;
      kept = next;
    }
    if (!settled) {  // long chains of suppression: one kept box at a time
      unsigned long long cand = cand0;
      kept = 0ull;
      while (cand) {
        const int i = __ffsll((long long)cand) - 1;
        kept |= 1ull << i;
        cand &= cand - 1;  // box i itself
        // row i's diagonal word lives in lane i/2; it holds only bits j > i
        const unsigned long long d = __shfl_sync(kFull, (i & 1) ? cur_hi : cur_lo, i >> 1);
        cand &= ~d;
      }
    }

    // 2. the kept rows beyond the diagonal into the removed words each thread owns: the kept
    // indices listed in this warp's slot first, so that the rows' loads do not wait on each
    // other's bit arithmetic
    unsigned char* list = lists + (threadIdx.x >> 5) * kBlock;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 2 * lane + h;
      if ((kept >> e) & 1ull) list[__popcll(kept & ((1ull << e) - 1ull))] = (unsigned char)e;
    }
    __syncwarp();
    const int n_kept = __popcll(kept);
    for (int wp = w + 1 + threadIdx.x; n_kept && wp < words; wp += blockDim.x) {
      unsigned long long acc = removed[wp];
      for (int n0 = 0; n0 < n_kept; n0 += kBatch) {
        unsigned long long got[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          got[k] = n0 + k < n_kept ? rows[(size_t)(w * kBlock + list[n0 + k]) * words + wp] : 0ull;
#pragma unroll
        for (int k = 0; k < kBatch; ++k) acc |= got[k];
      }
      removed[wp] = acc;
    }
    for (int e = threadIdx.x; e < kBlock; e += blockDim.x)
      if (w * kBlock + e < K) out[w * kBlock + e] = (kept >> e) & 1ull;
    __syncthreads();  // removed[w + 1] is final before any warp reads it
  }
}

}  // namespace

// boxes (B, K, 4) f32, valid (B, K) bool as bytes, mask scratch
// (B, K, ceil(K/64)) u64, keep (B, K) bool as bytes; all contiguous on the
// device, boxes 16-byte aligned. Launches on `stream`, does not synchronise,
// returns cudaGetLastError() (0 on success).
extern "C" int basedet_nms_keep(const float* boxes, const unsigned char* valid, int B, int K,
                                float thresh, unsigned long long* mask, unsigned char* keep,
                                void* stream) {
  if (B <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (K + kBlock - 1) / kBlock;

  nms_mask_kernel<<<dim3(words, words, B), kBlock, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), valid, K, words, thresh, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // one thread per word beyond the diagonal, at least the 64 that write a word's keep flags
  int threads = ((words + 31) / 32) * 32;
  threads = threads < kBlock ? kBlock : (threads < 1024 ? threads : 1024);
  const size_t smem = (size_t)words * sizeof(unsigned long long) + (size_t)(threads / 32) * kBlock;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sweep_kernel<<<B, threads, smem, s>>>(mask, valid, K, words, keep);
  return static_cast<int>(cudaGetLastError());
}
