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
// H=64) the launch and its chain of dependent loads: the function moves
// ~0.9 MB, a bound under a microsecond, and 623 of the 1,064 rows have no
// valid slot.  Design: one warp per node row, a lane per neighbour slot
// (rows of D > 32 loop in chunks of 32 with an online max).  Each lane loads
// its slot's index, mask and bias and gathers s_src once, so the logits are
// computed once; the max and the sum are warp shuffles, and each lane keeps
// its weight attn = exp(logit - max) / sum * mask in a register.  A masked
// slot's weight is exactly 0 (softmax * 0), so a ballot of the mask drives
// one pass over the row's columns that gathers only the valid slots' rows
// of z (nbr_slots.cuh: vector loads, several in flight).  Masked slots are never gathered; skipping one gives the
// reference's 0 * z[idx] for finite z.  A row with every slot masked writes
// zeros without a gather: its logits are all -1e9 (not -inf, which keeps
// them finite), its softmax is 1/D, and 1/D * 0 = 0.  An index outside
// [0, N) is clamped, so a bad index never reads outside z.
#include <math.h>

#include "nbr_slots.cuh"

namespace {

using namespace nbr;

__device__ __forceinline__ float masked_logit(float ss, float sd, float bias, float mask) {
  float x = ss + sd + bias;
  x = x >= 0.f ? x : 0.2f * x;
  return mask > 0.f ? x : -1e9f;
}

// One lane's slot: its source row, masked logit (-inf past D) and mask.
struct Slot {
  int src;
  float logit, mask;
};

__device__ __forceinline__ Slot edge_slot(const float* __restrict__ s_src, float sd,
                                          const int* __restrict__ ri,
                                          const float* __restrict__ rm,
                                          const float* __restrict__ rb, int k, int d, int n) {
  Slot s{0, -INFINITY, 0.f};
  if (k < d) {
    s.src = clamp_row(ri[k], n);
    s.mask = rm[k];
    s.logit = masked_logit(s_src[s.src], sd, rb[k], s.mask);
  }
  return s;
}

template <int VEC, int NP>
__global__ void __launch_bounds__(kWarps * 32)
    edge_softmax_kernel(const float* __restrict__ z, const float* __restrict__ s_src,
                        const float* __restrict__ s_dst, const int* __restrict__ idx,
                        const float* __restrict__ mask, const float* __restrict__ bias,
                        float* __restrict__ out, int n, int d, int hdim) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const size_t base = (size_t)row * d;
  const int* ri = idx + base;
  const float* rm = mask + base;
  const float* rb = bias + base;
  const float sd = s_dst[row];

  // max and sum over all D slots, online across chunks of 32; the first
  // chunk's slots stay in registers
  const Slot s0 = edge_slot(s_src, sd, ri, rm, rb, lane, d, n);
  float m = -INFINITY, sum = 0.f;
  for (int k0 = 0; k0 < d; k0 += 32) {
    const float logit =
        k0 == 0 ? s0.logit : edge_slot(s_src, sd, ri, rm, rb, k0 + lane, d, n).logit;
    const float m_new = fmaxf(m, warp_max(logit));
    sum = sum * expf(m - m_new) + warp_sum(expf(logit - m_new));
    m = m_new;
  }

  auto attn = [&](float logit, float mk) { return expf(logit - m) / sum * mk; };
  // a masked slot's weight is exactly 0 (softmax * 0): the mask's ballot
  // says which rows of z the sum needs
  const float a0 = lane < d ? attn(s0.logit, s0.mask) : 0.f;
  const unsigned valid0 = __ballot_sync(kFull, s0.mask != 0.f);
  for (int col0 = 0; col0 < hdim; col0 += 32 * VEC * NP) {
    const int first = col0 + lane * VEC;
    float acc[NP][VEC] = {};
    auto add = [&](int, float a, const float(&x)[NP][VEC]) { fma_cols(acc, a, x); };
    gather_slots<float, VEC, NP>(z, hdim, first, valid0, s0.src, a0, 0, add);
    for (int k0 = 32; k0 < d; k0 += 32) {
      const Slot s = edge_slot(s_src, sd, ri, rm, rb, k0 + lane, d, n);
      gather_slots<float, VEC, NP>(z, hdim, first, __ballot_sync(kFull, s.mask != 0.f), s.src,
                                   attn(s.logit, s.mask), 0, add);
    }
    store_cols<float, VEC, NP>(out + (size_t)row * hdim, first, hdim, acc);
  }
}

}  // namespace

extern "C" int edge_softmax_agg_f32(const void* z, const void* s_src, const void* s_dst,
                                    const void* idx, const void* mask, const void* bias,
                                    void* out, int n, int d, int hdim, void* stream) {
  if (n <= 0 || d < 0 || hdim <= 0) return (int)cudaErrorInvalidValue;
  int vec, np;
  pick_cols(hdim, (int)sizeof(float), z, out, &vec, &np);
  return dispatch_cols<float>(vec, np, [&](auto v, auto p) {
    edge_softmax_kernel<decltype(v)::value, decltype(p)::value>
        <<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
            (const float*)z, (const float*)s_src, (const float*)s_dst, (const int*)idx,
            (const float*)mask, (const float*)bias, (float*)out, n, d, hdim);
    return (int)cudaGetLastError();
  });
}
