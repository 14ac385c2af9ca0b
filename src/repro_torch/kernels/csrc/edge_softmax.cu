// GAT edge softmax and weighted aggregation, the GAT layer of stage 1:
//
//     logit[i,d] = leaky_relu(s_src[idx[i,d]] + s_dst[i] + bias[i,d], 0.2)
//     logit[i,d] = -1e9 where mask[i,d] == 0
//     attn[i,:]  = softmax(logit[i,:]) * mask[i,:]          (f32, max-subtracted)
//     out[i,:]   = sum_d attn[i,d] * z[idx[i,d], :]
//
// Replaces the TPU kernel src/repro/kernels/edge_softmax.py::
// edge_softmax_agg_pallas (body _edge_softmax_kernel).
//
// Bound on the H100: memory, and at the main path's shape (N=1064, D=24,
// H=64) the launch itself: the function moves ~0.9 MB, a bound under a
// microsecond.  Design: one warp per node row.  A lane holds one neighbour
// slot, so D=24 fits one pass of 32 lanes; longer rows loop in chunks of 32.
// The max and the sum are warp shuffles; the aggregation broadcasts each
// slot's weight and source row to the warp, whose lanes run across H, so
// each gathered row of z is one coalesced read.  Masking with -1e9 (not
// -inf) keeps an all-masked row finite: its weights are 1/D * 0 = 0.  An
// index outside [0, N) is clamped, so a bad index never reads outside z.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ float edge_logit(const float* __restrict__ s_src,
                                            float sd, const int* __restrict__ ri,
                                            const float* __restrict__ rm,
                                            const float* __restrict__ rb, int k,
                                            int n, int* src) {
  *src = min(max(ri[k], 0), n - 1);
  float x = s_src[*src] + sd + rb[k];
  x = x >= 0.f ? x : 0.2f * x;
  return rm[k] > 0.f ? x : -1e9f;
}

__global__ void edge_softmax_kernel(const float* __restrict__ z,
                                    const float* __restrict__ s_src,
                                    const float* __restrict__ s_dst,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ bias,
                                    float* __restrict__ out, int n, int d,
                                    int hdim) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const size_t base = (size_t)row * d;
  const int* ri = idx + base;
  const float* rm = mask + base;
  const float* rb = bias + base;
  const float sd = s_dst[row];
  int src;

  float m = -INFINITY;
  for (int k = lane; k < d; k += 32)
    m = fmaxf(m, edge_logit(s_src, sd, ri, rm, rb, k, n, &src));
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));

  float s = 0.f;
  for (int k = lane; k < d; k += 32)
    s += expf(edge_logit(s_src, sd, ri, rm, rb, k, n, &src) - m);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);

  for (int c0 = 0; c0 < hdim; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    for (int k0 = 0; k0 < d; k0 += 32) {
      const int k = k0 + lane;
      float a = 0.f;
      src = 0;
      if (k < d) {
        const float e = expf(edge_logit(s_src, sd, ri, rm, rb, k, n, &src) - m);
        a = e / s * rm[k];
      }
      const int kn = min(32, d - k0);
      for (int j = 0; j < kn; ++j) {
        const float aj = __shfl_sync(kFull, a, j);
        const int sj = __shfl_sync(kFull, src, j);
        if (c < hdim) acc = fmaf(z[(size_t)sj * hdim + c], aj, acc);
      }
    }
    if (c < hdim) out[(size_t)row * hdim + c] = acc;
  }
}

}  // namespace

extern "C" int edge_softmax_agg_f32(const void* z, const void* s_src,
                                    const void* s_dst, const void* idx,
                                    const void* mask, const void* bias,
                                    void* out, int n, int d, int hdim,
                                    void* stream) {
  if (n <= 0 || d < 0 || hdim <= 0) return (int)cudaErrorInvalidValue;
  const int rows_per_block = kThreads / 32;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block);
  edge_softmax_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)s_src, (const float*)s_dst,
      (const int*)idx, (const float*)mask, (const float*)bias, (float*)out, n,
      d, hdim);
  return (int)cudaGetLastError();
}
