// Pairwise IoU of xyxy f32 boxes for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces basedet_tpu/ops/iou_pallas.py::_iou_kernel (reached via
// box_iou_pallas, kernel #10): out[b, m, n] = IoU(boxes1[b, m], boxes2[b, n]),
// 0 where the union is not positive. The TPU kernel streams 256x256 tiles over
// lane-major (4, N) boxes; here boxes stay row-major (x1, y1, x2, y2).
//
// Layout: boxes1 (B, M, 4), boxes2 (B, N, 4) or one (N, 4) shared by every
// image (b2_batch_stride 0: RetinaNet's anchors), out (B, M, N), all
// contiguous f32. The output is indexed in 64 bits: (2, 100, 268569) is
// already 53.7 M elements.
//
// What bounds it: bytes. The output, M*N f32 per image, is the only large
// array: at RetinaNet's (2, 100, 201600) it is 161 MB against 3.2 MB of
// anchors, and each element costs ~17 f32 operations, far under the card's
// f32 rate for 4 bytes of store. So every output element is written once,
// with 16-byte stores along n (n fastest, so a warp's stores are 512
// contiguous bytes), and nothing else is written. One thread owns 4
// consecutive n: it loads those 4 boxes2 once and keeps them, with their
// areas, in registers for kRows rows of boxes1, which the block stages in
// shared memory. The grid is (ceil(N / 1024), ceil(M / kRows), B).
//
// Arithmetic, in the plain version's order (structures/box_ops.py::box_iou;
// built with -fmad=false, IEEE division):
//   iw = max(min(x2a, x2b) - max(x1a, x1b), 0), ih likewise; inter = iw*ih;
//   area = (x2 - x1) * (y2 - y1); union = area_a + area_b - inter;
//   out = union > 0 ? inter / max(union, 1e-12) : 0.
// On finite inputs this gives the plain version's bits: fmaxf(union, 1e-12)
// and clamp(min=1e-12) agree wherever union > 0, and both sides write 0
// elsewhere (a NaN union included).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                   // consecutive n per thread
constexpr int kCols = kThreads * kVec;    // n per block
constexpr int kRows = 16;                 // rows of boxes1 per block

__device__ __forceinline__ float iou_one(float ax1, float ay1, float ax2, float ay2, float area_a,
                                         float bx1, float by1, float bx2, float by2, float area_b) {
  const float iw = fmaxf(fminf(ax2, bx2) - fmaxf(ax1, bx1), 0.0f);
  const float ih = fmaxf(fminf(ay2, by2) - fmaxf(ay1, by1), 0.0f);
  const float inter = iw * ih;
  const float uni = area_a + area_b - inter;
  return uni > 0.0f ? inter / fmaxf(uni, 1e-12f) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    iou_kernel(const float* __restrict__ boxes1, const float* __restrict__ boxes2, int M, int N,
               long long b2_batch_stride, int vec_store, float* __restrict__ out) {
  __shared__ float rows[kRows][5];  // x1, y1, x2, y2, area of this block's boxes1 rows
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kRows;
  const int rows_here = min(kRows, M - m0);
  if (threadIdx.x < rows_here) {
    const float* a = boxes1 + ((long long)b * M + m0 + threadIdx.x) * 4;
    const float x1 = a[0], y1 = a[1], x2 = a[2], y2 = a[3];
    rows[threadIdx.x][0] = x1;
    rows[threadIdx.x][1] = y1;
    rows[threadIdx.x][2] = x2;
    rows[threadIdx.x][3] = y2;
    rows[threadIdx.x][4] = (x2 - x1) * (y2 - y1);
  }
  __syncthreads();

  const int n0 = blockIdx.x * kCols + threadIdx.x * kVec;
  if (n0 >= N) return;
  const int cols = min(kVec, N - n0);
  const float* bb = boxes2 + (long long)b * b2_batch_stride + (long long)n0 * 4;
  float bx1[kVec], by1[kVec], bx2[kVec], by2[kVec], area_b[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (k < cols) {
      bx1[k] = __ldg(bb + 4 * k);
      by1[k] = __ldg(bb + 4 * k + 1);
      bx2[k] = __ldg(bb + 4 * k + 2);
      by2[k] = __ldg(bb + 4 * k + 3);
    } else {
      bx1[k] = by1[k] = bx2[k] = by2[k] = 0.0f;
    }
    area_b[k] = (bx2[k] - bx1[k]) * (by2[k] - by1[k]);
  }

  for (int r = 0; r < rows_here; ++r) {
    const float ax1 = rows[r][0], ay1 = rows[r][1], ax2 = rows[r][2], ay2 = rows[r][3];
    const float area_a = rows[r][4];
    float v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      v[k] = iou_one(ax1, ay1, ax2, ay2, area_a, bx1[k], by1[k], bx2[k], by2[k], area_b[k]);
    float* o = out + ((long long)b * M + m0 + r) * N + n0;
    if (vec_store && cols == kVec) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int k = 0; k < cols; ++k) o[k] = v[k];
    }
  }
}

}  // namespace

extern "C" {

// boxes1 (B, M, 4); boxes2 (B, N, 4) with b2_batch_stride = N * 4, or (N, 4)
// shared with b2_batch_stride = 0; out (B, M, N). All contiguous f32; out
// must be 16-byte aligned where N % 4 == 0 (torch.empty is). Returns the
// launch's CUDA error.
int basedet_box_iou(const void* boxes1, const void* boxes2, int B, int M, int N,
                    long long b2_batch_stride, void* out, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0) return 0;
  const long long col_blocks = ((long long)N + kCols - 1) / kCols;
  const long long row_blocks = ((long long)M + kRows - 1) / kRows;
  if (col_blocks > 0x7fffffffLL || row_blocks > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec_store = (N % kVec == 0) && ((uintptr_t)out % 16 == 0);
  const dim3 grid((unsigned)col_blocks, (unsigned)row_blocks, (unsigned)B);
  iou_kernel<<<grid, kThreads, 0, stream>>>((const float*)boxes1, (const float*)boxes2, M, N,
                                            b2_batch_stride, vec_store, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
