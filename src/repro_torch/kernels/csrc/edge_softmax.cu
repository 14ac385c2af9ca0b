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

// ---------------------------------------------------------------------------
// Backward (training), f32: the gradients with respect to z, s_src, s_dst
// and bias.  The reference has no backward kernel: it differentiates its XLA
// path (jax.nn.leaky_relu, whose derivative at exactly 0 is 1, as here).
//
// With p = softmax(logit[i, :]) (masked logits at -1e9) and
// g[i, k] = dout[i, :] . z[idx[i, k], :]:
//
//     dp[i, k]     = mask * g[i, k]                 c[i] = sum_k p * dp
//     dlogit[i, k] = p * (dp - c[i]) * (pre >= 0 ? 1 : 0.2)   where mask > 0, else 0
//     d_bias       = dlogit          ds_dst[i] = sum_k dlogit[i, k]
//     dz[j, :]     = sum over (i, k) -> j of p * mask * dout[i, :]
//     ds_src[j]    = sum over (i, k) -> j of dlogit[i, k]
//
// Two launches.  The first, a warp per node row, recomputes the row's max
// and sum as the forward does, gathers each valid slot's row of z once for
// its dot product with dout[i] (the lanes across H, a warp sum per slot),
// and writes the per-slot weight p * mask (a scratch [N, D]), dlogit and
// ds_dst.  The second, a warp per source row, sums over the graph's
// reverse-slot index (rev_row_sum in nbr_slots.cuh) in a fixed order, with
// no atomics.  The mask must be zero outside the index's slots.  Bound, as
// the forward: bytes, and at the main path's shape the launch and the chain
// of dependent loads per row.
// ---------------------------------------------------------------------------

template <int VEC, int NP>
__global__ void __launch_bounds__(kWarps * 32)
    edge_softmax_bwd_dst_kernel(const float* __restrict__ dout, const float* __restrict__ z,
                                const float* __restrict__ s_src, const float* __restrict__ s_dst,
                                const int* __restrict__ idx, const float* __restrict__ mask,
                                const float* __restrict__ bias, float* __restrict__ alpha,
                                float* dlogit, float* __restrict__ ds_dst, int n, int d,
                                int hdim) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const size_t base = (size_t)row * d;
  const int* ri = idx + base;
  const float* rm = mask + base;
  const float* rb = bias + base;
  const float sd = s_dst[row];
  const float* grow = dout + (size_t)row * hdim;

  // the row's max and sum, as the forward computes them
  const Slot s0 = edge_slot(s_src, sd, ri, rm, rb, lane, d, n);
  float m = -INFINITY, sum = 0.f;
  for (int k0 = 0; k0 < d; k0 += 32) {
    const float logit =
        k0 == 0 ? s0.logit : edge_slot(s_src, sd, ri, rm, rb, k0 + lane, d, n).logit;
    const float m_new = fmaxf(m, warp_max(logit));
    sum = sum * expf(m - m_new) + warp_sum(expf(logit - m_new));
    m = m_new;
  }

  // dp per slot (kept in dlogit until the second loop, read back by the lane
  // that wrote it) and c = sum_k p * dp
  float c = 0.f;
  for (int k0 = 0; k0 < d; k0 += 32) {
    const int k = k0 + lane;
    const Slot s = k0 == 0 ? s0 : edge_slot(s_src, sd, ri, rm, rb, k, d, n);
    const unsigned valid = __ballot_sync(kFull, s.mask != 0.f);
    float g = 0.f;
    for (int col0 = 0; valid && col0 < hdim; col0 += 32 * VEC * NP) {
      const int first = col0 + lane * VEC;
      RawVec<float, VEC> r[NP];
      load_cols<float, VEC, NP>(grow, first, hdim, r);
      float o[NP][VEC];
#pragma unroll
      for (int p = 0; p < NP; ++p) widen<float, VEC>(r[p], o[p]);
      auto dot = [&](int slot_lane, float, const float(&x)[NP][VEC]) {
        float part = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int i = 0; i < VEC; ++i) part = fmaf(x[p][i], o[p][i], part);
        part = warp_sum(part);
        if (lane == slot_lane) g += part;
      };
      gather_slots<float, VEC, NP>(z, hdim, first, valid, s.src, 0.f, lane, dot);
    }
    const float p = k < d ? expf(s.logit - m) / sum : 0.f;
    const float dp = s.mask * g;
    c += warp_sum(p * dp);
    if (k < d) dlogit[base + k] = dp;
  }

  float dsd = 0.f;
  for (int k0 = 0; k0 < d; k0 += 32) {
    const int k = k0 + lane;
    const Slot s = k0 == 0 ? s0 : edge_slot(s_src, sd, ri, rm, rb, k, d, n);
    float dl = 0.f;
    if (k < d) {
      const float p = expf(s.logit - m) / sum;
      if (s.mask > 0.f) {
        const float pre = s_src[s.src] + sd + rb[k];
        dl = p * (dlogit[base + k] - c) * (pre >= 0.f ? 1.f : 0.2f);
      }
      alpha[base + k] = p * s.mask;
      dlogit[base + k] = dl;
    }
    dsd += warp_sum(dl);
  }
  if (lane == 0) ds_dst[row] = dsd;
}

template <int VEC, int NP>
__global__ void __launch_bounds__(kWarps * 32)
    edge_softmax_bwd_src_kernel(const float* __restrict__ dout, const int* __restrict__ rev_ptr,
                                const int* __restrict__ rev_slot,
                                const float* __restrict__ alpha,
                                const float* __restrict__ dlogit, float* __restrict__ dz,
                                float* __restrict__ ds_src, int n, int d, int hdim) {
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= n) return;  // uniform across the warp
  rev_row_sum<VEC, NP>(dout, rev_ptr, rev_slot, alpha, nullptr, 1, dlogit, dz, ds_src, j, n, d,
                       hdim);
}

}  // namespace

extern "C" int edge_softmax_agg_bwd_f32(const void* dout, const void* z, const void* s_src,
                                        const void* s_dst, const void* idx, const void* mask,
                                        const void* bias, const void* rev_ptr,
                                        const void* rev_slot, void* alpha, void* dz,
                                        void* ds_src, void* ds_dst, void* dbias, int n, int d,
                                        int hdim, void* stream) {
  if (n <= 0 || d <= 0 || hdim <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (n + kWarps - 1) / kWarps;
  int vec, np;
  // the first launch gathers rows of z and reads dout's rows; the second
  // gathers rows of dout into dz
  pick_cols(hdim, (int)sizeof(float), z, dout, &vec, &np);
  int rc = dispatch_cols<float>(vec, np, [&](auto v, auto p) {
    edge_softmax_bwd_dst_kernel<decltype(v)::value, decltype(p)::value>
        <<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
            (const float*)dout, (const float*)z, (const float*)s_src, (const float*)s_dst,
            (const int*)idx, (const float*)mask, (const float*)bias, (float*)alpha,
            (float*)dbias, (float*)ds_dst, n, d, hdim);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc;
  pick_cols(hdim, (int)sizeof(float), dout, dz, &vec, &np);
  return dispatch_cols<float>(vec, np, [&](auto v, auto p) {
    edge_softmax_bwd_src_kernel<decltype(v)::value, decltype(p)::value>
        <<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
            (const float*)dout, (const int*)rev_ptr, (const int*)rev_slot,
            (const float*)alpha, (const float*)dbias, (float*)dz, (float*)ds_src, n, d, hdim);
    return (int)cudaGetLastError();
  });
}

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
