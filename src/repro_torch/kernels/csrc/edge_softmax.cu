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
// of z (nbr_slots.cuh: vector loads, several in flight).  Masked slots are
// never gathered; skipping one gives the reference's 0 * z[idx] for finite
// z.  A row with every slot masked writes zeros without a gather: its
// logits are all -1e9 (not -inf, which keeps them finite), its softmax is
// 1/D, and 1/D * 0 = 0.  An index outside [0, N) is clamped, so a bad index
// never reads outside z.  Under grad the kernel also writes each row's max
// and sum (stats) for the backward; without grad the pointer is null and
// nothing more is stored.
#include <math.h>

#include "nbr_slots.cuh"

namespace {

using namespace nbr;

// the logit of a slot from its pre-activation s_src[idx] + s_dst + bias
__device__ __forceinline__ float masked_logit(float pre, float mask) {
  const float x = pre >= 0.f ? pre : 0.2f * pre;
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
    s.logit = masked_logit(s_src[s.src] + sd + rb[k], s.mask);
  }
  return s;
}

template <int VEC, int NP>
__global__ void __launch_bounds__(kWarps * 32)
    edge_softmax_kernel(const float* __restrict__ z, const float* __restrict__ s_src,
                        const float* __restrict__ s_dst, const int* __restrict__ idx,
                        const float* __restrict__ mask, const float* __restrict__ bias,
                        float* __restrict__ out, float2* __restrict__ stats, int n, int d,
                        int hdim) {
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
  if (stats != nullptr && lane == 0) stats[row] = make_float2(m, sum);   // under grad only

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
// With p = softmax(logit[i, :]) (masked logits at -1e9), out the forward's
// output and g[i, k] = dout[i, :] . z[idx[i, k], :]:
//
//     c[i]         = dout[i, :] . out[i, :]        (= sum_k p * mask * g, as in
//                                                    FlashAttention's backward)
//     dlogit[i, k] = p * (mask * g[i, k] - c[i]) * (pre >= 0 ? 1 : 0.2)   where mask > 0, else 0
//     d_bias       = dlogit          ds_dst[i] = sum_k dlogit[i, k]
//     dz[j, :]     = sum over (i, k) -> j of p * mask * dout[i, :]
//     ds_src[j]    = sum over (i, k) -> j of dlogit[i, k]
//
// p comes from the row's max and sum, which the forward writes under grad
// (stats), so one launch does it all, with no scratch in device memory: a
// block holds kBwdRows rows and two warps for each.  The destination warp
// of row i gathers the rows of z of i's valid slots (all in flight) for g
// and writes dlogit, d_bias and ds_dst; the source warp of row j walks j's
// reverse slots (i, k), a lane per slot, gathers dout[i] and out[i] (all in
// flight), and recomputes p, g = dout[i] . z[j], c[i] and dlogit[i, k] for
// dz and ds_src.  Both warps take every dot product in the same layout
// (this lane's columns in one order, fmaf; then the butterfly's pairs of
// lanes, transpose_sum reducing a group's dot products together rather
// than one butterfly per slot in series), so they agree on every edge's
// dlogit bit for bit: d_bias and ds_src come from the same numbers.  Every
// sum runs in one fixed order, with no atomics, so two calls give the same
// bits.  The mask must be zero outside the reverse index's slots.
//
// Bound, as the forward: bytes (under half a microsecond at the main path's
// shape); in practice the launch and the chain of dependent loads, two
// round trips for the destination warp (slots, then z and s_src) and three
// for the source warp (rev_ptr, its slots, then their rows and scalars),
// and the shuffles: an SM's warps share one shuffle unit, and each place in
// a group of rows costs one (with_group sizes groups to the rows at hand).
// ---------------------------------------------------------------------------

constexpr int kBwdRows = 4;   // node rows per block of the backward, two warps each
constexpr int kDstRows = 8;   // rows of z a destination warp gathers at once
constexpr int kSrcRows = 8;   // slots (a row of dout and of out each) a source warp gathers

// p of a slot from its row's saved max and sum, as the forward weighs it
__device__ __forceinline__ float slot_p(float logit, float2 st) {
  return expf(logit - st.x) / st.y;
}

// dlogit of a slot with mask > 0; explicit roundings, so both warps that
// compute it give the same bits
__device__ __forceinline__ float slot_dlogit(float p, float mask, float g, float c, float pre) {
  const float dp = __fmul_rn(mask, g);
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, c)), pre >= 0.f ? 1.f : 0.2f);
}

template <int VEC, int NP>
__device__ __forceinline__ void load_row_cols(const float* __restrict__ row, int first, int hdim,
                                              float (&x)[NP][VEC]) {
  RawVec<float, VEC> r[NP];
  load_cols<float, VEC, NP>(row, first, hdim, r);
#pragma unroll
  for (int p = 0; p < NP; ++p) widen<float, VEC>(r[p], x[p]);
}

// Destination warp of row i: dlogit of each slot into d_bias, and ds_dst.
// Every load a slot needs (its index, mask and bias, s_src of its source
// row) is issued before any is used, and the rows of z and of dout[i] and
// out[i] (for c) go out together, so the warp waits for two round trips.
template <int VEC, int NP>
__device__ __forceinline__ void bwd_dst_row(const float* __restrict__ dout,
                                            const float* __restrict__ out,
                                            const float2* __restrict__ stats,
                                            const float* __restrict__ z,
                                            const float* __restrict__ s_src,
                                            const float* __restrict__ s_dst,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ mask,
                                            const float* __restrict__ bias,
                                            float* __restrict__ ds_dst,
                                            float* __restrict__ dbias, int i, int n, int d,
                                            int hdim) {
  constexpr int R = flight_rows<VEC, NP>(1, kDstRows);
  constexpr int kBlock = 32 * VEC * NP;
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)i * d;
  const float sd = s_dst[i];
  const float2 st = stats[i];
  const float* di = dout + (size_t)i * hdim;
  const float* oi = out + (size_t)i * hdim;
  float c = 0.f, dsd = 0.f;
  bool have_c = false;
  for (int k0 = 0; k0 < d; k0 += 32) {
    const int k = k0 + lane;
    int src = 0;
    float mk = 0.f, ss = 0.f, bk = 0.f;
    if (k < d) {
      src = clamp_row(idx[base + k], n);
      mk = mask[base + k];
      bk = bias[base + k];
      ss = s_src[src];
    }
    float g = 0.f;
    // g of the valid slots, up to R at a time: part u of the group's u-th slot
    for (unsigned bits = __ballot_sync(kFull, mk > 0.f); bits != 0u;) {
      with_group<R>(min(__popc(bits), R), [&](auto size) {
        constexpr int G = decltype(size)::value;
        const unsigned group_start = bits;
        int sl[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          sl[u] = bits ? __ffs(bits) - 1 : -1;
          bits &= bits - 1;
        }
        const unsigned group = group_start & ~bits;
        float part[G] = {};
        float cpart = 0.f;   // c[i] = dout[i] . out[i], in the first group only
        for (int col0 = 0; col0 < hdim; col0 += kBlock) {
          const int first = col0 + lane * VEC;
          RawVec<float, VEC> r[G][NP], ro[NP];
#pragma unroll
          for (int u = 0; u < G; ++u) {
            const int s = __shfl_sync(kFull, src, sl[u] & 31);
            if (sl[u] >= 0) load_cols<float, VEC, NP>(z + (size_t)s * hdim, first, hdim, r[u]);
          }
          if (!have_c) load_cols<float, VEC, NP>(oi, first, hdim, ro);
          float o[NP][VEC];
          load_row_cols<VEC, NP>(di, first, hdim, o);
#pragma unroll
          for (int u = 0; u < G; ++u) {
            if (sl[u] < 0) continue;
            float x[NP][VEC];
#pragma unroll
            for (int p = 0; p < NP; ++p) widen<float, VEC>(r[u][p], x[p]);
            part[u] = dot_cols(x, o, part[u]);
          }
          if (!have_c) {
            float y[NP][VEC];
#pragma unroll
            for (int p = 0; p < NP; ++p) widen<float, VEC>(ro[p], y[p]);
            cpart = dot_cols(o, y, cpart);
          }
        }
        if (!have_c) {
          c = warp_sum(cpart);
          have_c = true;
        }
        const float gu = transpose_sum(part);
        const int rank = __popc(group & ((1u << lane) - 1u));
        const float mine = __shfl_sync(kFull, gu, rank % G);
        if ((group >> lane) & 1u) g = mine;
      });
    }
    float dl = 0.f;
    if (mk > 0.f) {
      const float pre = ss + sd + bk;
      dl = slot_dlogit(slot_p(masked_logit(pre, mk), st), mk, g, c, pre);
    }
    if (k < d) dbias[base + k] = dl;
    dsd += warp_sum(dl);
  }
  if (lane == 0) ds_dst[i] = dsd;
}

// One reverse slot (i, k) of source row j, as loaded: node row i, mask,
// bias, s_dst[i] and row i's saved max and sum (lanes past the row's
// slots: mask 0).  Nothing is computed from them until the rows of the
// slot's group are in flight.
struct RevEdge {
  int i;
  float mask, bias, sd;
  float2 st;
};

__device__ __forceinline__ RevEdge rev_edge(const int* __restrict__ rev_slot, int q, bool live,
                                            const float* __restrict__ s_dst,
                                            const float2* __restrict__ stats,
                                            const float* __restrict__ mask,
                                            const float* __restrict__ bias, int d) {
  RevEdge e{0, 0.f, 0.f, 0.f, make_float2(0.f, 1.f)};
  if (live) {
    const int s = rev_slot[q];
    e.i = s / d;
    e.mask = mask[s];
    e.bias = bias[s];
    e.sd = s_dst[e.i];
    e.st = stats[e.i];
  }
  return e;
}

// Source warp of row j: dz[j] and ds_src[j] over j's reverse slots, a lane
// per slot: three round trips (rev_ptr, the slots, then their rows and
// scalars together).
template <int VEC, int NP>
__device__ __forceinline__ void bwd_src_row(const float* __restrict__ dout,
                                            const float* __restrict__ out,
                                            const float2* __restrict__ stats,
                                            const float* __restrict__ z,
                                            const float* __restrict__ s_src,
                                            const float* __restrict__ s_dst,
                                            const float* __restrict__ mask,
                                            const float* __restrict__ bias,
                                            const int* __restrict__ rev_ptr,
                                            const int* __restrict__ rev_slot,
                                            float* __restrict__ dz, float* __restrict__ ds_src,
                                            int j, int d, int hdim) {
  constexpr int R = flight_rows<VEC, NP>(2, kSrcRows);   // dout[i] and out[i] a slot
  constexpr int kBlock = 32 * VEC * NP;
  const int lane = threadIdx.x & 31;
  const int q0 = rev_ptr[j], q1 = rev_ptr[j + 1];
  const float ss = s_src[j];
  const float* zj = z + (size_t)j * hdim;
  const bool one_block = hdim <= kBlock;
  float acc[NP][VEC] = {};   // dz[j] where the row is one column block
  float dss = 0.f;
  for (int q = q0; q < q1; q += 32) {
    const int cnt = min(32, q1 - q);
    const RevEdge e = rev_edge(rev_slot, q + lane, lane < cnt, s_dst, stats, mask, bias, d);
    float g = 0.f, c = 0.f, p = 0.f, pre = 0.f;
    for (int base = 0; base < cnt; base += R) {
      with_group<R>(cnt - base, [&](auto size) {
        constexpr int G = decltype(size)::value;
        float part[2 * G] = {};   // [u]: g of slot base + u, [G + u]: its c
        for (int col0 = 0; col0 < hdim; col0 += kBlock) {
          const int first = col0 + lane * VEC;
          RawVec<float, VEC> rd[G][NP], ro[G][NP];
          gather_rows<VEC, NP, G>(dout, hdim, first, e.i, base, cnt, rd, out, ro);
          float zc[NP][VEC];
          load_row_cols<VEC, NP>(zj, first, hdim, zc);
          if (base == 0 && col0 == 0) {   // the slot's p, once its loads are out
            pre = ss + e.sd + e.bias;
            p = slot_p(masked_logit(pre, e.mask), e.st);
          }
          const float alpha = p * e.mask;
#pragma unroll
          for (int u = 0; u < G; ++u) {
            const float au = __shfl_sync(kFull, alpha, (base + u) & 31);
            if (base + u >= cnt) continue;
            float x[NP][VEC], y[NP][VEC];
#pragma unroll
            for (int pp = 0; pp < NP; ++pp) {
              widen<float, VEC>(rd[u][pp], x[pp]);
              widen<float, VEC>(ro[u][pp], y[pp]);
            }
            part[u] = dot_cols(x, zc, part[u]);
            part[G + u] = dot_cols(x, y, part[G + u]);
            if (one_block) fma_cols(acc, au, x);
          }
        }
        const float t = transpose_sum(part);
        const float gl = __shfl_sync(kFull, t, (lane - base) & 31);
        const float cl = __shfl_sync(kFull, t, (G + lane - base) & 31);
        if (lane >= base && lane < base + G) {
          g = gl;
          c = cl;
        }
      });
    }
    float dl = 0.f;
    if (e.mask > 0.f) dl = slot_dlogit(p, e.mask, g, c, pre);
    dss += warp_sum(dl);
  }
  if (lane == 0) ds_src[j] = dss;
  if (one_block) {
    store_cols<float, VEC, NP>(dz + (size_t)j * hdim, lane * VEC, hdim, acc);
    return;
  }
  // a row of several column blocks: dz a block at a time, the slots again
  for (int col0 = 0; col0 < hdim; col0 += kBlock) {
    const int first = col0 + lane * VEC;
    float a[NP][VEC] = {};
    for (int q = q0; q < q1; q += 32) {
      const int cnt = min(32, q1 - q);
      const RevEdge e = rev_edge(rev_slot, q + lane, lane < cnt, s_dst, stats, mask, bias, d);
      const float alpha = slot_p(masked_logit(ss + e.sd + e.bias, e.mask), e.st) * e.mask;
      for (int base = 0; base < cnt; base += R) {
        with_group<R>(cnt - base, [&](auto size) {
          constexpr int G = decltype(size)::value;
          RawVec<float, VEC> rd[G][NP];
          gather_rows<VEC, NP, G>(dout, hdim, first, e.i, base, cnt, rd);
#pragma unroll
          for (int u = 0; u < G; ++u) {
            const float au = __shfl_sync(kFull, alpha, (base + u) & 31);
            if (base + u >= cnt) continue;
            float x[NP][VEC];
#pragma unroll
            for (int pp = 0; pp < NP; ++pp) widen<float, VEC>(rd[u][pp], x[pp]);
            fma_cols(a, au, x);
          }
        });
      }
    }
    store_cols<float, VEC, NP>(dz + (size_t)j * hdim, first, hdim, a);
  }
}

// At most 128 registers a thread, two blocks an SM: 264 of the main path's
// 266 blocks (1,064 rows) resident at once, without spills at H=64.  (On
// the H100 at that shape, larger groups spill under a tighter cap, and
// smaller ones cost more in series than a second wave of two blocks.)
template <int VEC, int NP>
__global__ void __launch_bounds__(2 * kBwdRows * 32, 2)
    edge_softmax_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                            const float2* __restrict__ stats, const float* __restrict__ z,
                            const float* __restrict__ s_src, const float* __restrict__ s_dst,
                            const int* __restrict__ idx, const float* __restrict__ mask,
                            const float* __restrict__ bias, const int* __restrict__ rev_ptr,
                            const int* __restrict__ rev_slot, float* __restrict__ dz,
                            float* __restrict__ ds_src, float* __restrict__ ds_dst,
                            float* __restrict__ dbias, int n, int d, int hdim) {
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kBwdRows + (warp % kBwdRows);
  if (row >= n) return;  // uniform across the warp
  if (warp < kBwdRows)
    bwd_dst_row<VEC, NP>(dout, out, stats, z, s_src, s_dst, idx, mask, bias, ds_dst, dbias, row,
                         n, d, hdim);
  else
    bwd_src_row<VEC, NP>(dout, out, stats, z, s_src, s_dst, mask, bias, rev_ptr, rev_slot, dz,
                         ds_src, row, d, hdim);
}

}  // namespace

// stats: null for the forward alone; under grad an [N] float2 buffer that
// receives each row's softmax max and sum for the backward
extern "C" int edge_softmax_agg_bwd_f32(const void* dout, const void* out, const void* stats,
                                        const void* z, const void* s_src, const void* s_dst,
                                        const void* idx, const void* mask, const void* bias,
                                        const void* rev_ptr, const void* rev_slot, void* dz,
                                        void* ds_src, void* ds_dst, void* dbias, int n, int d,
                                        int hdim, void* stream) {
  if (n <= 0 || d <= 0 || hdim <= 0) return (int)cudaErrorInvalidValue;
  int vec, np;
  // one layout for every row the kernel reads or writes: z, dout, out, dz
  pick_cols(hdim, (int)sizeof(float), z,
            (const void*)((uintptr_t)dout | (uintptr_t)out | (uintptr_t)dz), &vec, &np);
  return dispatch_cols<float>(vec, np, [&](auto v, auto p) {
    edge_softmax_bwd_kernel<decltype(v)::value, decltype(p)::value>
        <<<(n + kBwdRows - 1) / kBwdRows, 2 * kBwdRows * 32, 0, (cudaStream_t)stream>>>(
            (const float*)dout, (const float*)out, (const float2*)stats, (const float*)z,
            (const float*)s_src, (const float*)s_dst, (const int*)idx, (const float*)mask,
            (const float*)bias, (const int*)rev_ptr, (const int*)rev_slot, (float*)dz,
            (float*)ds_src, (float*)ds_dst, (float*)dbias, n, d, hdim);
    return (int)cudaGetLastError();
  });
}

extern "C" int edge_softmax_agg_f32(const void* z, const void* s_src, const void* s_dst,
                                    const void* idx, const void* mask, const void* bias,
                                    void* out, void* stats, int n, int d, int hdim,
                                    void* stream) {
  if (n <= 0 || d < 0 || hdim <= 0) return (int)cudaErrorInvalidValue;
  int vec, np;
  pick_cols(hdim, (int)sizeof(float), z, out, &vec, &np);
  return dispatch_cols<float>(vec, np, [&](auto v, auto p) {
    edge_softmax_kernel<decltype(v)::value, decltype(p)::value>
        <<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
            (const float*)z, (const float*)s_src, (const float*)s_dst, (const int*)idx,
            (const float*)mask, (const float*)bias, (float*)out, (float2*)stats, n, d, hdim);
    return (int)cudaGetLastError();
  });
}
