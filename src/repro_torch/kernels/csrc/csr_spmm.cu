// Weighted neighbour gather-sum, the GCN/SAGE aggregation of stage 1:
//
//     out[i, :] = sum_d w[i, d] * h[idx[i, d], :]
//
// Replaces the TPU kernel src/repro/kernels/csr_spmm.py::csr_spmm_pallas
// (body _spmm_kernel).  Same padded in-neighbour layout: padded slots point
// at row 0 with weight 0, so no per-slot mask is read.
//
// Bound on the H100: memory.  At the main path's shape (N=1064, D=24, H=64,
// f32) the function moves ~0.75 MB and does ~3.3 MFLOP, a bound well under a
// microsecond, so one launch is bound by its launch and its dependent chain
// of D gathers, not by HBM.  Design: a block holds a tile of node rows
// (threadIdx.y) and its threads run across H (threadIdx.x), so each gathered
// row of h is one coalesced read; a community's h (~270 KB) stays in L2
// across the D steps.  Accumulation is in f32 whatever h's type.  An index
// outside [0, N) is clamped, so a bad index never reads outside h.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void csr_spmm_kernel(const T* __restrict__ h,
                                const int* __restrict__ idx,
                                const float* __restrict__ w,
                                T* __restrict__ out, int n, int d, int hdim) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n) return;
  const int* ri = idx + (size_t)row * d;
  const float* rw = w + (size_t)row * d;
  for (int c = threadIdx.x; c < hdim; c += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < d; ++k) {
      const int src = min(max(ri[k], 0), n - 1);
      acc = fmaf(load_f32(h + (size_t)src * hdim + c), rw[k], acc);
    }
    store_f32(out + (size_t)row * hdim + c, acc);
  }
}

template <typename T>
int launch(const void* h, const void* idx, const void* w, void* out, int n,
           int d, int hdim, void* stream) {
  if (n <= 0 || d < 0 || hdim <= 0) return (int)cudaErrorInvalidValue;
  // threads across H: one warp for narrow rows, up to four for wide ones;
  // the rest of the 256 threads take further node rows
  const int bx = hdim > 64 ? 128 : (hdim > 32 ? 64 : 32);
  const dim3 block(bx, 256 / bx);
  const dim3 grid((n + block.y - 1) / block.y);
  csr_spmm_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)h, (const int*)idx, (const float*)w, (T*)out, n, d, hdim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int csr_spmm_f32(const void* h, const void* idx, const void* w,
                            void* out, int n, int d, int hdim, void* stream) {
  return launch<float>(h, idx, w, out, n, d, hdim, stream);
}

extern "C" int csr_spmm_bf16(const void* h, const void* idx, const void* w,
                             void* out, int n, int d, int hdim, void* stream) {
  return launch<__nv_bfloat16>(h, idx, w, out, n, d, hdim, stream);
}
