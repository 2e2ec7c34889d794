// Batched row scatter-add for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces basedet_tpu/ops/scatter_onehot.py::_scatter_oh_kernel (reached via
// scatter_rows_onehot_pallas, kernel #9): the transpose of the DCN block
// gather, out = zeros(B, R, D).at[b, idx].add(values), summed in f32.
// Entries whose index lies outside [0, R) add nothing. Values are f32 or
// bf16 (bf16 converts to f32 exactly on load); the output is f32.
//
// Layout: the wrapper (ops/scatter_rows_kernel.py) sorts the keys b*R + idx
// stably (out-of-range entries get the key B*R, past every row) and finds
// where each row's run starts (ops/scatter_rows.py::row_segments). The
// kernel gets the permutation `order` (B*N,) int64, the run starts
// `starts` (B*R + 1,) int64, values (B*N, D) row-major and writes
// out (B*R, D) f32 row-major.
//
// What bounds it: bytes. Every value is read once and every output element
// written once; the arithmetic is one add per value. One block owns one
// output row and a tile of 128 x VEC channels: its threads walk the row's
// entries in sorted order, which is the original n order (the sort is
// stable), and add them in f32 registers, four entries' loads in flight at a
// time. Each block writes its tile once, zeros for a row that receives
// nothing, so there is no separate zero-fill and no atomic: the sum's order
// is fixed and two runs give the same bits. The TPU's one-hot MXU matmul
// (2*N*R*D flops to move N*D values) has no reason to exist here: the card
// gathers rows directly.
//
// A row that receives many entries (all N on one row, at worst) is one
// block's serial loop; trained or randomised DCN offsets put tens of
// entries on a row, zero offsets about nine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;

// VEC consecutive values of one entry, as f32.
template <typename T, int VEC>
struct Load;

template <>
struct Load<float, 4> {
  __device__ __forceinline__ static void run(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

template <>
struct Load<float, 1> {
  __device__ __forceinline__ static void run(const float* p, float* v) { v[0] = *p; }
};

template <>
struct Load<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p, float* v) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  }
};

template <>
struct Load<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
};

// grid (B*R, ceil(D / (kThreads * VEC))); D % VEC == 0.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const T* __restrict__ values, const long long* __restrict__ order,
                        const long long* __restrict__ starts, int D, float* __restrict__ out) {
  const long long row = blockIdx.x;
  const int d = (blockIdx.y * kThreads + threadIdx.x) * VEC;
  if (d >= D) return;
  const long long s = starts[row], e = starts[row + 1];
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  long long i = s;
  for (; i + kUnroll <= e; i += kUnroll) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) Load<T, VEC>::run(values + order[i + u] * D + d, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
  }
  for (; i < e; ++i) {
    float v[VEC];
    Load<T, VEC>::run(values + order[i] * D + d, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += v[k];
  }
  float* o = out + row * D + d;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    o[0] = acc[0];
  }
}

template <typename T, int VEC>
int launch(const void* values, const void* order, const void* starts, long long rows, int D,
           void* out, cudaStream_t stream) {
  const dim3 grid((unsigned)rows, (D / VEC + kThreads - 1) / kThreads);
  scatter_rows_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      (const T*)values, (const long long*)order, (const long long*)starts, D, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// values (B*N, D) f32 (bf16 = 0) or bf16 (bf16 = 1); order (B*N,) and
// starts (rows + 1,) int64; out (rows, D) f32. vec is 4 (D % 4 == 0, values
// and out aligned to 4 elements) or 1.
int basedet_scatter_rows(const void* values, int bf16, const void* order, const void* starts,
                         long long rows, int D, int vec, void* out, cudaStream_t stream) {
  if (rows <= 0 || D <= 0) return 0;
  if (rows > 0x7fffffffLL || (vec != 1 && vec != 4) || D % vec)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return vec == 4 ? launch<__nv_bfloat16, 4>(values, order, starts, rows, D, out, stream)
                    : launch<__nv_bfloat16, 1>(values, order, starts, rows, D, out, stream);
  return vec == 4 ? launch<float, 4>(values, order, starts, rows, D, out, stream)
                  : launch<float, 1>(values, order, starts, rows, D, out, stream);
}

}  // extern "C"
