// Batched row scatter-add for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces basedet_tpu/ops/scatter_onehot.py::_scatter_oh_kernel (reached via
// scatter_rows_onehot_pallas, kernel #9): the transpose of the DCN block
// gather, out = zeros(B, R, D).at[b, idx].add(values), summed in f32.
// Entries whose index lies outside [0, R) add nothing. Values are f32 or
// bf16 (bf16 converts to f32 exactly on load); the output is f32, or bf16
// rounded once from the f32 sum.
//
// Two steps, both on the card, all launches on the caller's stream:
//
// 1. Segmentation (basedet_row_segments): the in-range entries grouped by
//    row b*R + idx, each row's entries in ascending n, and where each row
//    starts: the stable order that ops/scatter_rows.py::row_segments gives
//    with a sort, built here from 32-bit keys without one.
//    - count_rows_kernel: each row's count by integer atomics (a count does
//      not depend on their order), and each image's out-of-range count;
//    - scan_rows_kernel: a block per image scans its R counts into starts;
//      image b's first row starts at b*N less the out-of-range entries of
//      the images before it. It zeroes the counts for step 3;
//    - place_rows_kernel: each entry takes a slot in its row by an atomic
//      (in no fixed order);
//    - order_rows_kernel: a warp per row sorts the row's entry ids, which
//      gives back ascending n since ids are unique: up to kRankMax by
//      counting each id's rank (the row's ids below it), past that by
//      walking the image's indices in order (right at any length, and slow:
//      rows that long need most of an image on one row).
//    Scratch: counts and out-of-range counts (zeroed by a memset), starts,
//    slots and ids, all int32, bound by bytes (a few MB a call at
//    CenterNet's shapes: 2.4 MB of ids at stage 3).
//
// 2. scatter_rows_kernel: what bounds it is bytes. Every value is read
//    once and every output element written once; the arithmetic is one add
//    per value. A warp owns one output row and 32 x 16 bytes of its
//    channels (128 f32 or 256 bf16 values); a block holds kWarps such
//    (row, channel tile) tasks, neighbouring tiles of one row or several
//    short rows, so short rows do not make tiny blocks. The warp reads the
//    row's ids once, 32 at a time, into registers and hands them out by
//    shuffles, so no value load waits on an id load; each thread keeps
//    kInFlight 16-byte value loads in flight and adds them in ascending n
//    into f32 registers (64 registers a thread: 32 warps an SM). On an H100
//    at CenterNet's shapes it moves 2.8 (bf16) to 3.0 (f32) TB/s; more
//    loads in flight a thread (so fewer warps resident), a warp walking
//    several rows with the next ids loaded ahead, and persistent blocks
//    were no faster. Each task writes its tile once (zeros for a row that
//    receives nothing), f32 or bf16: no zero-fill, no atomics, no separate
//    cast. The sum's order is fixed, so two runs give the same bits, and
//    they are the plain version's (ops/scatter_rows.py::scatter_rows_plain):
//    the same adds in the same order. The TPU's one-hot MXU matmul (2*N*R*D
//    flops to move N*D values) has no reason to exist here: the card
//    gathers rows directly.
//
// Sizes: B*N <= 2^31 - 1024 and 2*B*R + B + 1 <= 2^31 - 1 (both entries check).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kInFlight = 8;   // 16-byte value loads in flight a thread
constexpr int kRankMax = 1024;  // longest row ordered by counting ranks
constexpr int kWalkUnroll = 8;  // index loads in flight a lane, walking an image

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// grid ceil(B*N / kThreads); counts (B*R,) and outside (B,) zeroed.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    count_rows_kernel(const I* __restrict__ idx, int total, int N, int R, int* __restrict__ counts,
                      int* __restrict__ outside) {
  const long long at = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (at >= total) return;
  const int i = (int)at, b = i / N;
  const I r = idx[i];
  if (r >= 0 && r < R)
    atomicAdd(&counts[(long long)b * R + (int)r], 1);
  else
    atomicAdd(&outside[b], 1);
}

// grid B, block kScanThreads: starts[b*R + r] for every row of image b, and
// starts[B*R] (the in-range entries) from the last image; counts zeroed.
__global__ void __launch_bounds__(kScanThreads)
    scan_rows_kernel(int B, int N, int R, int* __restrict__ counts, const int* __restrict__ outside,
                     int* __restrict__ starts) {
  __shared__ int warp_sums[32];
  __shared__ int chunk_total, first;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    int skipped = 0;
    for (int j = lane; j < b; j += 32) skipped += outside[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) skipped += __shfl_xor_sync(kFull, skipped, o);
    if (lane == 0) first = b * N - skipped;
  }
  __syncthreads();
  int carry = first;
  int* c = counts + (long long)b * R;
  int* s = starts + (long long)b * R;
  for (int chunk = 0; chunk < R; chunk += kScanThreads * kScanItems) {
    const int j0 = chunk + threadIdx.x * kScanItems;
    int v[kScanItems], sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = j0 + k < R ? c[j0 + k] : 0;
      sum += v[k];
    }
    const int incl = warp_inclusive_sum(sum, lane);
    __syncthreads();  // the previous chunk's warp_sums and chunk_total are read
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_sums[lane];
      const int wi = warp_inclusive_sum(w, lane);
      warp_sums[lane] = wi - w;
      if (lane == 31) chunk_total = wi;
    }
    __syncthreads();
    int run = carry + warp_sums[warp] + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (j0 + k < R) {
        s[j0 + k] = run;
        c[j0 + k] = 0;
      }
      run += v[k];
    }
    carry += chunk_total;
  }
  if (b == B - 1 && threadIdx.x == 0) starts[(long long)B * R] = carry;
}

// grid ceil(B*N / kThreads): each in-range entry's id in a slot of its row.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    place_rows_kernel(const I* __restrict__ idx, int total, int N, int R, int* __restrict__ cursor,
                      const int* __restrict__ starts, int* __restrict__ slots) {
  const long long at = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (at >= total) return;
  const int i = (int)at;
  const I r = idx[i];
  if (r < 0 || r >= R) return;
  const long long key = (long long)(i / N) * R + (int)r;
  slots[starts[key] + atomicAdd(&cursor[key], 1)] = i;
}

// grid ceil(B*R / kWarps): a warp per row writes the row's ids in ascending
// order.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    order_rows_kernel(const I* __restrict__ idx, int N, int R, long long rows,
                      const int* __restrict__ starts, const int* __restrict__ slots,
                      int* __restrict__ ids) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int s = starts[row], L = starts[row + 1] - s;
  if (L <= kRankMax) {
    for (int i0 = 0; i0 < L; i0 += 32) {
      const int mine = i0 + lane < L ? slots[s + i0 + lane] : 0;
      int rank = 0;
      for (int j0 = 0; j0 < L; j0 += 32) {
        const int other = j0 + lane < L ? slots[s + j0 + lane] : 0;
        if (L - j0 >= 32) {
#pragma unroll
          for (int k = 0; k < 32; ++k) rank += __shfl_sync(kFull, other, k) < mine;
        } else {  // the row's last ids, one shuffle each (CenterNet's rows hold about 9)
          for (int k = 0; k < L - j0; ++k) rank += __shfl_sync(kFull, other, k) < mine;
        }
      }
      if (i0 + lane < L) ids[s + rank] = mine;
    }
  } else {
    const int b = (int)(row / R);
    const I r = (I)(row - (long long)b * R);
    const I* im = idx + (long long)b * N;
    int found = 0;
    for (int n0 = 0; n0 < N && found < L; n0 += 32 * kWalkUnroll) {
      I v[kWalkUnroll];
#pragma unroll
      for (int u = 0; u < kWalkUnroll; ++u) {
        const int n = n0 + u * 32 + lane;
        v[u] = n < N ? im[n] : (I)-1;
      }
#pragma unroll
      for (int u = 0; u < kWalkUnroll; ++u) {
        const unsigned hit = __ballot_sync(kFull, v[u] == r);
        if (v[u] == r) ids[s + found + __popc(hit & ((1u << lane) - 1))] = b * N + n0 + u * 32 + lane;
        found += __popc(hit);
      }
    }
  }
}

// V consecutive values of one entry as raw bits (Raw), added into f32.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ static void add(float* acc, Raw q) {
    acc[0] += q.x; acc[1] += q.y; acc[2] += q.z; acc[3] += q.w;
  }
};

template <>
struct Vec<float, 1> {
  using Raw = float;
  __device__ __forceinline__ static Raw load(const float* p) { return __ldg(p); }
  __device__ __forceinline__ static void add(float* acc, Raw q) { acc[0] += q; }
};

// bf16 to f32 is exact: the bits shifted into the high half. Element 2k is
// the low half of word k.
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void add(float* acc, Raw q) {
    acc[0] += lo_bf16(q.x); acc[1] += hi_bf16(q.x); acc[2] += lo_bf16(q.y); acc[3] += hi_bf16(q.y);
    acc[4] += lo_bf16(q.z); acc[5] += hi_bf16(q.z); acc[6] += lo_bf16(q.w); acc[7] += hi_bf16(q.w);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ static void add(float* acc, Raw q) { acc[0] += lo_bf16(q); }
};

// V f32 sums stored as O: f32 as they are, bf16 rounded to nearest even.
template <typename O, int V>
__device__ __forceinline__ void store(O* p, const float* acc);

template <>
__device__ __forceinline__ void store<float, 1>(float* p, const float* acc) { *p = acc[0]; }

template <>
__device__ __forceinline__ void store<float, 4>(float* p, const float* acc) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <>
__device__ __forceinline__ void store<float, 8>(float* p, const float* acc) {
  reinterpret_cast<float4*>(p)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <>
__device__ __forceinline__ void store<__nv_bfloat16, 1>(__nv_bfloat16* p, const float* acc) {
  *p = __float2bfloat16_rn(acc[0]);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <>
__device__ __forceinline__ void store<__nv_bfloat16, 8>(__nv_bfloat16* p, const float* acc) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                                            pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
}

// grid ceil(rows * tiles / kWarps); a warp per (row, tile of 32 * V
// channels); D % V == 0.
template <typename T, typename O, int V>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const T* __restrict__ values, const int* __restrict__ ids,
                        const int* __restrict__ starts, long long tasks, int tiles, int D,
                        O* __restrict__ out) {
  const long long task = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= tasks) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long row = task / tiles;
  const int d = ((int)(task - row * tiles) * 32 + lane) * V;
  const bool active = d < D;
  const T* base = values + (active ? d : 0);  // idle lanes of a ragged tile load channel 0 and store nothing
  const int s = starts[row], e = starts[row + 1];
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.0f;
  for (int i0 = s; i0 < e; i0 += 32) {
    const int here = min(32, e - i0);
    const int mine = lane < here ? ids[i0 + lane] : 0;
    for (int k0 = 0; k0 < here; k0 += kInFlight) {
      typename Vec<T, V>::Raw q[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int id = __shfl_sync(kFull, mine, k0 + u);
        if (k0 + u < here) q[u] = Vec<T, V>::load(base + (long long)id * D);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (k0 + u < here) Vec<T, V>::add(acc, q[u]);
    }
  }
  if (active) store<O, V>(out + row * D + d, acc);
}

int grid_of(long long items, int per_block) {
  const long long blocks = (items + per_block - 1) / per_block;
  return blocks > 0x7fffffffLL ? -1 : (int)blocks;
}

template <typename I>
int segment(const I* idx, int B, int N, int R, int* scratch, cudaStream_t stream) {
  const long long rows = (long long)B * R;
  const int total = B * N;
  int* counts = scratch;          // (B*R,), then zeroed again by the scan: the place kernel's cursors
  int* outside = counts + rows;   // (B,)
  int* starts = outside + B;      // (B*R + 1,)
  int* slots = starts + rows + 1; // (B*N,)
  int* ids = slots + total;       // (B*N,)
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (rows + B), stream);
  if (err != cudaSuccess) return (int)err;
  const int entry_blocks = grid_of(total, kThreads), row_blocks = grid_of(rows, kWarps);
  if (entry_blocks < 0 || row_blocks < 0) return (int)cudaErrorInvalidValue;
  if (total > 0) {
    count_rows_kernel<I><<<entry_blocks, kThreads, 0, stream>>>(idx, total, N, R, counts, outside);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  scan_rows_kernel<<<B, kScanThreads, 0, stream>>>(B, N, R, counts, outside, starts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (total > 0) {
    place_rows_kernel<I><<<entry_blocks, kThreads, 0, stream>>>(idx, total, N, R, counts, starts, slots);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    order_rows_kernel<I><<<row_blocks, kThreads, 0, stream>>>(idx, N, R, rows, starts, slots, ids);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, typename O, int V>
int scatter(const void* values, const int* ids, const int* starts, long long rows, int D, void* out,
            cudaStream_t stream) {
  const int tiles = (D / V + 31) / 32;
  const int blocks = grid_of(rows * tiles, kWarps);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  scatter_rows_kernel<T, O, V><<<blocks, kThreads, 0, stream>>>(
      (const T*)values, ids, starts, rows * tiles, tiles, D, (O*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// idx (B, N) int32 (idx64 = 0) or int64 (idx64 = 1), contiguous; scratch
// int32 of (B*R + B) + (B*R + 1) + 2*B*N elements: counts, out-of-range
// counts, starts (B*R + 1,) at offset B*R + B, slots, then ids (B*N,) at
// offset 2*B*R + B + 1 + B*N, of which the first starts[B*R] are the
// in-range entries' flat ids (b*N + n) row by row, ascending n in each row.
int basedet_row_segments(const void* idx, int idx64, int B, int N, int R, void* scratch,
                         cudaStream_t stream) {
  if (B <= 0 || N < 0 || R <= 0 || (long long)B * N > 0x7ffffc00LL ||
      2LL * B * R + B + 1 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return idx64 ? segment((const long long*)idx, B, N, R, (int*)scratch, stream)
               : segment((const int*)idx, B, N, R, (int*)scratch, stream);
}

// values (rows' entries, D) f32 (bf16 = 0) or bf16 (bf16 = 1); ids and
// starts from basedet_row_segments; out (rows, D) f32 (out_bf16 = 0) or
// bf16 (out_bf16 = 1, bf16 values only). vec is 16 bytes of values (D a
// multiple of 4 f32 or 8 bf16, values aligned to 16 bytes) or 1.
int basedet_scatter_rows(const void* values, int bf16, const void* ids, const void* starts,
                         long long rows, int D, int vec, void* out, int out_bf16, cudaStream_t stream) {
  if (rows <= 0 || D <= 0) return 0;
  const int wide = bf16 ? 8 : 4;
  if ((vec != 1 && vec != wide) || D % vec || (out_bf16 && !bf16)) return (int)cudaErrorInvalidValue;
  const int* i = (const int*)ids;
  const int* s = (const int*)starts;
  if (!bf16)
    return vec == 4 ? scatter<float, float, 4>(values, i, s, rows, D, out, stream)
                    : scatter<float, float, 1>(values, i, s, rows, D, out, stream);
  if (out_bf16)
    return vec == 8 ? scatter<__nv_bfloat16, __nv_bfloat16, 8>(values, i, s, rows, D, out, stream)
                    : scatter<__nv_bfloat16, __nv_bfloat16, 1>(values, i, s, rows, D, out, stream);
  return vec == 8 ? scatter<__nv_bfloat16, float, 8>(values, i, s, rows, D, out, stream)
                  : scatter<__nv_bfloat16, float, 1>(values, i, s, rows, D, out, stream);
}

}  // extern "C"
