// Weighted neighbour gather-sum, the GCN/SAGE aggregation of stage 1, and
// its per-edge-type mean (GCN) in one launch:
//
//     csr_spmm:             out[i, :]    = sum_d w[i, d] * h[idx[i, d], :]
//     csr_spmm_etype_mean:  cnt[i, e]    = max(sum_d mask[i, d] * [etype[i, d] == e], 1)
//                           out[e, i, :] = sum_d (mask[i, d] * [etype[i, d] == e] / cnt[i, e])
//                                                * h[idx[i, d], :]          for e < E
//
// Replaces the TPU kernel src/repro/kernels/csr_spmm.py::csr_spmm_pallas
// (body _spmm_kernel); the second entry is the reference's
// core/layers.py::per_etype_mean, E calls of that kernel, in one launch.
//
// Bound on the H100: memory, and at the main path's shape (N=1064, D=24,
// H=64, f32) the launch and its chain of dependent loads: the function moves
// ~0.75 MB (the per-type mean ~1.67 MB), a bound under a microsecond.  Only
// ~6% of the slots are valid and a row's gathers depend on its slot loads,
// so the design (nbr_slots.cuh) reads each row's slots once, a lane per
// slot, ballots the slots of non-zero weight, and gathers only those rows of
// h, several in flight; a row with no such slot writes zeros and gathers
// nothing.  Skipping a zero-weight slot gives the same sum as the
// reference's 0 * h[idx] for finite h.  Accumulation is in f32, in slot
// order, whatever h's type.  An index outside [0, N) is clamped, so a bad
// index never reads outside h.
//
// The per-type mean sums each type's mask as a float (the reference's
// w.sum(-1), not a count of slots), divides each slot's mask by its own
// type's sum, and gathers each valid slot once, for its own type; a slot
// whose type lies outside [0, E) belongs to no output.  Types with no
// slot in a row write zeros.
#include "nbr_slots.cuh"

namespace {

using namespace nbr;

constexpr int kMaxTypes = 4;   // EdgeType.NUM: the graph's edge-type vocabulary

template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(kWarps * 32)
    csr_spmm_kernel(const T* __restrict__ h, const int* __restrict__ idx,
                    const float* __restrict__ w, T* __restrict__ out, int n, int d, int hdim) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const int* ri = idx + (size_t)row * d;
  const float* rw = w + (size_t)row * d;
  // the first 32 slots, read once; a row of D > 32 reads further chunks in
  // the loop, and a row wider than one column block reads them again (L1)
  const int src0 = lane < d ? clamp_row(ri[lane], n) : 0;
  const float w0 = lane < d ? rw[lane] : 0.f;
  const unsigned bits0 = __ballot_sync(kFull, w0 != 0.f);
  for (int col0 = 0; col0 < hdim; col0 += 32 * VEC * NP) {
    const int first = col0 + lane * VEC;
    float acc[NP][VEC] = {};
    auto add = [&](int, float wj, const float(&x)[NP][VEC]) { fma_cols(acc, wj, x); };
    gather_slots<T, VEC, NP>(h, hdim, first, bits0, src0, w0, 0, add);
    for (int k0 = 32; k0 < d; k0 += 32) {
      const int k = k0 + lane;
      const int src = k < d ? clamp_row(ri[k], n) : 0;
      const float wk = k < d ? rw[k] : 0.f;
      gather_slots<T, VEC, NP>(h, hdim, first, __ballot_sync(kFull, wk != 0.f), src, wk, 0,
                               add);
    }
    store_cols<T, VEC, NP>(out + (size_t)row * hdim, first, hdim, acc);
  }
}

// One lane's slot of the per-type mean: its source row, mask and type (-1
// for a type outside [0, ntypes) and for lanes past D).
struct TypedSlot {
  int src, type;
  float mask;
};

__device__ __forceinline__ TypedSlot typed_slot(const int* ri, const float* rm, const int* re,
                                                int k, int d, int n, int ntypes) {
  TypedSlot s{0, -1, 0.f};
  if (k < d) {
    s.src = clamp_row(ri[k], n);
    s.mask = rm[k];
    const int t = re[k];
    s.type = (t >= 0 && t < ntypes) ? t : -1;
  }
  return s;
}

// A slot that adds to some type's mean: a type in [0, ntypes) and a
// non-zero mask (its weight mask / cnt can only be 0 where the mask is, or
// by underflow, which adds 0 * h as the reference does).
__device__ __forceinline__ bool is_valid(const TypedSlot& s) {
  return s.type >= 0 && s.mask != 0.f;
}

// Each type's float sum of the mask over the row's D slots, clamped to 1
// (types no slot of the row carries keep 0, clamped like the others); s0
// is the lane's slot of the first chunk of 32.
__device__ __forceinline__ void type_counts(const int* ri, const float* rm, const int* re,
                                            const TypedSlot& s0, int d, int n, int ntypes,
                                            float (&cnt)[kMaxTypes]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < kMaxTypes; ++e) cnt[e] = 0.f;
  for (int k0 = 0; k0 < d; k0 += 32) {
    const TypedSlot s = k0 == 0 ? s0 : typed_slot(ri, rm, re, k0 + lane, d, n, ntypes);
#pragma unroll
    for (int e = 0; e < kMaxTypes; ++e)
      if (__ballot_sync(kFull, s.type == e && s.mask != 0.f))
        cnt[e] += warp_sum(s.type == e ? s.mask : 0.f);
  }
#pragma unroll
  for (int e = 0; e < kMaxTypes; ++e) cnt[e] = fmaxf(cnt[e], 1.f);
}

// A slot's weight: its mask over its own type's sum (the reference's w / cnt).
__device__ __forceinline__ float slot_weight(const TypedSlot& s, const float (&cnt)[kMaxTypes]) {
  float c = 1.f;
#pragma unroll
  for (int e = 0; e < kMaxTypes; ++e)
    if (s.type == e) c = cnt[e];
  return s.type >= 0 ? s.mask / c : 0.f;
}

template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(kWarps * 32)
    csr_spmm_etype_mean_kernel(const T* __restrict__ h, const int* __restrict__ idx,
                               const float* __restrict__ mask, const int* __restrict__ etype,
                               T* __restrict__ out, float* __restrict__ wslot, int n, int d,
                               int hdim, int ntypes) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const size_t base = (size_t)row * d;
  const int* ri = idx + base;
  const float* rm = mask + base;
  const int* re = etype + base;

  const TypedSlot s0 = typed_slot(ri, rm, re, lane, d, n, ntypes);
  float cnt[kMaxTypes];
  type_counts(ri, rm, re, s0, d, n, ntypes, cnt);
  auto weight = [&](const TypedSlot& s) { return slot_weight(s, cnt); };
  const float w0 = weight(s0);
  if (wslot != nullptr && lane < d) wslot[base + lane] = w0;   // under grad only
  const unsigned valid0 = __ballot_sync(kFull, is_valid(s0));
  for (int col0 = 0; col0 < hdim; col0 += 32 * VEC * NP) {
    const int first = col0 + lane * VEC;
    float acc[kMaxTypes][NP][VEC] = {};
    auto add = [&](int type, float wj, const float(&x)[NP][VEC]) {
#pragma unroll
      for (int e = 0; e < kMaxTypes; ++e)
        if (type == e) fma_cols(acc[e], wj, x);
    };
    gather_slots<T, VEC, NP>(h, hdim, first, valid0, s0.src, w0, s0.type, add);
    for (int k0 = 32; k0 < d; k0 += 32) {
      const TypedSlot s = typed_slot(ri, rm, re, k0 + lane, d, n, ntypes);
      const float wk = weight(s);
      if (wslot != nullptr && col0 == 0 && k0 + lane < d) wslot[base + k0 + lane] = wk;
      gather_slots<T, VEC, NP>(h, hdim, first, __ballot_sync(kFull, is_valid(s)), s.src, wk,
                               s.type, add);
    }
#pragma unroll
    for (int e = 0; e < kMaxTypes; ++e)
      if (e < ntypes)
        store_cols<T, VEC, NP>(out + ((size_t)e * n + row) * hdim, first, hdim, acc[e]);
  }
}

// ---------------------------------------------------------------------------
// Backward (training): the gradient with respect to h, f32
//
//     csr_spmm:             dh[j, :] = sum over (i, k) -> j of w[i, k] * dout[i, :]
//     csr_spmm_etype_mean:  dh[j, :] = sum over (i, k) -> j of
//                                      wslot[i, k] * dout[etype[i, k], i, :]
//
// where wslot[i, k] = mask[i, k] / cnt[i, etype[i, k]] is the weight the
// forward gave the slot (it writes wslot under grad; a type outside [0, E)
// adds nothing).  The reference has no backward kernel: it differentiates
// its XLA path (jnp.take + einsum), whose scatter-add sums in a fixed
// order.  Here a warp per source row j sums over the graph's reverse-slot
// index rev_slot[rev_ptr[j] .. rev_ptr[j + 1]) (the flat slots i * d + k
// whose clamped index is j, ascending), a lane per slot, so two calls give
// the same bits (no atomics).  The weights must be zero outside the
// index's slots.  One launch for either entry.
//
// Bound, as the forward: bytes (well under a microsecond at the main path's
// shape), and in practice the launch and the chain of dependent loads: the
// row's rev_ptr, its slots, then (for the per-type entry, the slots' types,
// then) the rows of dout, all of one source row's gathers in flight at once
// (gather_rows, up to flight_rows of them; the single entry issues them
// beside its weight loads), summed in slot order.
// ---------------------------------------------------------------------------

template <int VEC, int NP, bool TYPED>
__global__ void __launch_bounds__(kWarps * 32)
    csr_spmm_bwd_kernel(const float* __restrict__ dout, const int* __restrict__ rev_ptr,
                        const int* __restrict__ rev_slot, const float* __restrict__ w,
                        const int* __restrict__ etype, int ntypes, float* __restrict__ dh,
                        int n, int d, int hdim) {
  constexpr int R = flight_rows<VEC, NP>(1);
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= n) return;  // uniform across the warp
  const int q0 = rev_ptr[j], q1 = rev_ptr[j + 1];
  for (int col0 = 0; col0 < hdim; col0 += 32 * VEC * NP) {
    const int first = col0 + lane * VEC;
    float acc[NP][VEC] = {};
    for (int q = q0; q < q1; q += 32) {
      const int cnt = min(32, q1 - q);
      int row = 0;
      float wq = 0.f;
      if (lane < cnt) {
        const int s = rev_slot[q + lane];
        wq = w[s];
        int plane = 0;
        if constexpr (TYPED) {
          plane = etype[s];
          if (plane < 0 || plane >= ntypes) {
            plane = 0;
            wq = 0.f;
          }
        }
        row = plane * n + s / d;
      }
      for (int base = 0; base < cnt; base += R) {
        with_group<R>(cnt - base, [&](auto group) {
          constexpr int G = decltype(group)::value;
          RawVec<float, VEC> r[G][NP];
          gather_rows<VEC, NP, G>(dout, hdim, first, row, base, cnt, r);
#pragma unroll
          for (int u = 0; u < G; ++u) {
            const float wu = __shfl_sync(kFull, wq, (base + u) & 31);
            if (base + u < cnt) {
              float x[NP][VEC];
#pragma unroll
              for (int p = 0; p < NP; ++p) widen<float, VEC>(r[u][p], x[p]);
              fma_cols(acc, wu, x);
            }
          }
        });
      }
    }
    store_cols<float, VEC, NP>(dh + (size_t)j * hdim, first, hdim, acc);
  }
}

int grid_rows(int n) { return (n + kWarps - 1) / kWarps; }

template <bool TYPED>
int launch_bwd(const void* dout, const void* rev_ptr, const void* rev_slot, const void* w,
               const void* etype, int ntypes, void* dh, int n, int d, int hdim, void* stream) {
  int vec, np;
  pick_cols(hdim, (int)sizeof(float), dout, dh, &vec, &np);
  return dispatch_cols<float>(vec, np, [&](auto v, auto p) {
    csr_spmm_bwd_kernel<decltype(v)::value, decltype(p)::value, TYPED>
        <<<grid_rows(n), kWarps * 32, 0, (cudaStream_t)stream>>>(
            (const float*)dout, (const int*)rev_ptr, (const int*)rev_slot, (const float*)w,
            (const int*)etype, ntypes, (float*)dh, n, d, hdim);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int launch(const void* h, const void* idx, const void* w, void* out, int n, int d, int hdim,
           void* stream) {
  if (n <= 0 || d < 0 || hdim <= 0) return (int)cudaErrorInvalidValue;
  int vec, np;
  pick_cols(hdim, (int)sizeof(T), h, out, &vec, &np);
  return dispatch_cols<T>(vec, np, [&](auto v, auto p) {
    csr_spmm_kernel<T, decltype(v)::value, decltype(p)::value>
        <<<grid_rows(n), kWarps * 32, 0, (cudaStream_t)stream>>>(
            (const T*)h, (const int*)idx, (const float*)w, (T*)out, n, d, hdim);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int launch_etype_mean(const void* h, const void* idx, const void* mask, const void* etype,
                      void* out, void* wslot, int n, int d, int hdim, int ntypes, void* stream) {
  if (n <= 0 || d < 0 || hdim <= 0 || ntypes < 1 || ntypes > kMaxTypes)
    return (int)cudaErrorInvalidValue;
  int vec, np;
  pick_cols(hdim, (int)sizeof(T), h, out, &vec, &np);
  return dispatch_cols<T>(vec, np, [&](auto v, auto p) {
    csr_spmm_etype_mean_kernel<T, decltype(v)::value, decltype(p)::value>
        <<<grid_rows(n), kWarps * 32, 0, (cudaStream_t)stream>>>(
            (const T*)h, (const int*)idx, (const float*)mask, (const int*)etype, (T*)out,
            (float*)wslot, n, d, hdim, ntypes);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int csr_spmm_f32(const void* h, const void* idx, const void* w, void* out, int n,
                            int d, int hdim, void* stream) {
  return launch<float>(h, idx, w, out, n, d, hdim, stream);
}

extern "C" int csr_spmm_bf16(const void* h, const void* idx, const void* w, void* out, int n,
                             int d, int hdim, void* stream) {
  return launch<__nv_bfloat16>(h, idx, w, out, n, d, hdim, stream);
}

// wslot: null for the forward alone; under grad an [N, D] f32 buffer that
// receives each slot's weight mask / cnt[type] for the backward
extern "C" int csr_spmm_etype_mean_f32(const void* h, const void* idx, const void* mask,
                                       const void* etype, void* out, void* wslot, int n, int d,
                                       int hdim, int ntypes, void* stream) {
  return launch_etype_mean<float>(h, idx, mask, etype, out, wslot, n, d, hdim, ntypes, stream);
}

extern "C" int csr_spmm_etype_mean_bf16(const void* h, const void* idx, const void* mask,
                                        const void* etype, void* out, int n, int d, int hdim,
                                        int ntypes, void* stream) {
  return launch_etype_mean<__nv_bfloat16>(h, idx, mask, etype, out, nullptr, n, d, hdim, ntypes,
                                          stream);
}

extern "C" int csr_spmm_bwd_f32(const void* dout, const void* w, const void* rev_ptr,
                                const void* rev_slot, void* dh, int n, int d, int hdim,
                                void* stream) {
  if (n <= 0 || d <= 0 || hdim <= 0) return (int)cudaErrorInvalidValue;
  return launch_bwd<false>(dout, rev_ptr, rev_slot, w, nullptr, 1, dh, n, d, hdim, stream);
}

// wslot: the weights the forward wrote under grad; dout [ntypes, N, H]
extern "C" int csr_spmm_etype_mean_bwd_f32(const void* dout, const void* wslot,
                                           const void* etype, const void* rev_ptr,
                                           const void* rev_slot, void* dh, int n, int d,
                                           int hdim, int ntypes, void* stream) {
  if (n <= 0 || d <= 0 || hdim <= 0 || ntypes < 1 || ntypes > kMaxTypes)
    return (int)cudaErrorInvalidValue;
  return launch_bwd<true>(dout, rev_ptr, rev_slot, wslot, etype, ntypes, dh, n, d, hdim, stream);
}
