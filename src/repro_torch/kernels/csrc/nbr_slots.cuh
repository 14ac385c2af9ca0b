// The padded in-neighbour layout of stage 1, read by csr_spmm.cu and
// edge_softmax.cu: a node row has D slots, slot k holding the source row
// idx[k] and a weight (or a mask) that is zero for an empty slot.  Most slots
// are empty (about 6% are valid in a community graph), so both kernels read
// a row's slots once, a lane per slot, keep the slots of non-zero weight in a
// warp ballot, and gather only those rows of the feature matrix.
//
// Layout of the work: one warp per node row.  The warp's lanes run across
// the feature columns: NP groups of VEC consecutive columns a lane, so one
// gathered row is one coalesced read of vector loads (VEC * sizeof(T) bytes
// each, at most 16).  The slot loop takes the ballot's set bits kUnroll at a
// time, so that several gathers are in flight before the FMAs consume them,
// and adds them in ascending slot order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace nbr {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;    // node rows per block, a warp each
constexpr int kUnroll = 4;   // gathered rows in flight per lane

// VEC elements of T as raw bits, moved in one load or store of
// VEC * sizeof(T) bytes.  A gather loads raw bits only and widens them where
// the FMAs use them: widening right after each load would make the warp
// wait for that load before it issues the next.  bf16 widens to f32 by a
// shift (exact) and narrows by __float2bfloat16 (round to nearest even, as
// torch's .to(bfloat16)).
template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };
template <typename T, int VEC>
using RawVec = typename Raw<sizeof(T) * VEC>::type;

template <typename T, int VEC>
__device__ __forceinline__ void widen(const RawVec<T, VEC>& r, float (&x)[VEC]) {
  unsigned w[(sizeof(r) + 3) / 4] = {};
  memcpy(w, &r, sizeof(r));
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = __uint_as_float(w[i]);
  } else if constexpr (VEC == 1) {
    x[0] = __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&x)[VEC]) {
  using R = RawVec<T, VEC>;
  unsigned w[(sizeof(R) + 3) / 4] = {};
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) w[i] = __float_as_uint(x[i]);
  } else if constexpr (VEC == 1) {
    w[0] = __bfloat16_as_ushort(__float2bfloat16(x[0]));
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
      w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(x[2 * i])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16(x[2 * i + 1])) << 16);
  }
  R r;
  memcpy(&r, w, sizeof(R));
  *reinterpret_cast<R*>(p) = r;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// The butterfly gives every lane the same bits: each step adds the same two
// values, in either order.
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int clamp_row(int i, int n) { return min(max(i, 0), n - 1); }

// This lane's columns of one row, from column `first` (= col0 + lane * VEC):
// group p starts at first + p * 32 * VEC.  VEC divides hdim, so a group lies
// wholly inside the row or wholly past it (zeros, never stored).
template <typename T, int VEC, int NP>
__device__ __forceinline__ void load_cols(const T* __restrict__ row, int first, int hdim,
                                          RawVec<T, VEC> (&r)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int c = first + p * 32 * VEC;
    if (c < hdim)
      r[p] = *reinterpret_cast<const RawVec<T, VEC>*>(row + c);
    else
      memset(&r[p], 0, sizeof(r[p]));
  }
}

template <typename T, int VEC, int NP>
__device__ __forceinline__ void store_cols(T* __restrict__ row, int first, int hdim,
                                           const float (&acc)[NP][VEC]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int c = first + p * 32 * VEC;
    if (c < hdim) store_vec<T, VEC>(row + c, acc[p]);
  }
}

// For each set bit j of `bits` (warp-uniform), in ascending order: lane j's
// `src`, `w` and `tag` are broadcast, row src of h is gathered at this
// lane's columns (kUnroll rows in flight), and sink(tag_j, w_j, x_j)
// consumes it.  A warp whose ballot is empty gathers nothing.
template <typename T, int VEC, int NP, typename Sink>
__device__ __forceinline__ void gather_slots(const T* __restrict__ h, int hdim, int first,
                                             unsigned bits, int src, float w, int tag,
                                             Sink&& sink) {
  while (bits) {
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      j[u] = bits ? __ffs(bits) - 1 : -1;
      bits &= bits - 1;
    }
    int s[kUnroll], t[kUnroll];
    float ws[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = __shfl_sync(kFull, src, j[u] & 31);
      ws[u] = __shfl_sync(kFull, w, j[u] & 31);
      t[u] = __shfl_sync(kFull, tag, j[u] & 31);
    }
    RawVec<T, VEC> r[kUnroll][NP];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j[u] >= 0) load_cols<T, VEC, NP>(h + (size_t)s[u] * hdim, first, hdim, r[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j[u] < 0) continue;
      float x[NP][VEC];
#pragma unroll
      for (int p = 0; p < NP; ++p) widen<T, VEC>(r[u][p], x[p]);
      sink(t[u], ws[u], x);
    }
  }
}

template <int VEC, int NP>
__device__ __forceinline__ void fma_cols(float (&acc)[NP][VEC], float w,
                                         const float (&x)[NP][VEC]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[p][i] = fmaf(x[p][i], w, acc[p][i]);
}

// The backward kernels' source pass: this warp's source row j gets
//
//     out[j, :]  = sum over j's reverse slots s of  w[s] * g[plane(s) * n + s / d, :]
//     out_s[j]   = sum over j's reverse slots s of  scal[s]        (where scal is given)
//
// over rev_slot[rev_ptr[j] .. rev_ptr[j + 1]), the flat slots i * d + k whose
// clamped index is j, in ascending order (kernels.ref.reverse_slots_ref).
// plane(s) is etype[s] where etype is given (a slot whose type lies outside
// [0, ntypes) adds nothing), else 0.  The slots are read 32 at a time, a lane
// per slot, and the rows of g gathered as the forward gathers rows of h: a
// ballot of the non-zero weights, kUnroll in flight, added in slot order.
// Every sum is taken in one fixed order, so two calls give the same bits
// (no atomics).  A row with no slot writes zeros.
template <int VEC, int NP>
__device__ __forceinline__ void rev_row_sum(const float* __restrict__ g,
                                            const int* __restrict__ rev_ptr,
                                            const int* __restrict__ rev_slot,
                                            const float* __restrict__ w,
                                            const int* __restrict__ etype, int ntypes,
                                            const float* __restrict__ scal,
                                            float* __restrict__ out,
                                            float* __restrict__ out_s, int j, int n, int d,
                                            int hdim) {
  const int lane = threadIdx.x & 31;
  const int q0 = rev_ptr[j], q1 = rev_ptr[j + 1];
  float s_acc = 0.f;
  for (int col0 = 0; col0 < hdim; col0 += 32 * VEC * NP) {
    const int first = col0 + lane * VEC;
    float acc[NP][VEC] = {};
    auto add = [&](int, float wj, const float(&x)[NP][VEC]) { fma_cols(acc, wj, x); };
    for (int q = q0; q < q1; q += 32) {
      int row = 0;
      float wq = 0.f, sq = 0.f;
      if (q + lane < q1) {
        const int s = rev_slot[q + lane];
        int plane = 0;
        wq = w[s];
        if (etype != nullptr) {
          plane = etype[s];
          if (plane < 0 || plane >= ntypes) {
            plane = 0;
            wq = 0.f;
          }
        }
        row = plane * n + s / d;
        if (scal != nullptr) sq = scal[s];
      }
      if (scal != nullptr && col0 == 0) s_acc += warp_sum(sq);
      gather_slots<float, VEC, NP>(g, hdim, first, __ballot_sync(kFull, wq != 0.f), row, wq, 0,
                                   add);
    }
    store_cols<float, VEC, NP>(out + (size_t)j * hdim, first, hdim, acc);
  }
  if (out_s != nullptr && lane == 0) out_s[j] = s_acc;
}

// Host side: the vector width and the groups per lane for a row of hdim
// elements of `elem` bytes.  VEC is the widest of 8, 4, 2, 1 elements that
// fits 16 bytes, divides hdim, keeps all 32 lanes busy (32 * VEC <= hdim)
// and that the gathered matrix and the output are aligned to; NP is 2 where
// one group per lane does not cover the row and a lane's load is under 16
// bytes (wider rows loop over column blocks).
inline void pick_cols(int hdim, int elem, const void* in, const void* out, int* vec, int* np) {
  const uintptr_t addr = (uintptr_t)in | (uintptr_t)out;
  int v = 8;
  while (v > 1 && (v * elem > 16 || hdim % v != 0 || 32 * v > hdim || addr % (v * elem) != 0))
    v >>= 1;
  *vec = v;
  *np = hdim > 32 * v && v * elem < 16 ? 2 : 1;
}

// Calls f(std::integral_constant<int, VEC>, std::integral_constant<int, NP>)
// for the pair pick_cols chose; pairs it never chooses are not instantiated.
template <typename T, typename F>
int dispatch_cols(int vec, int np, F&& f) {
  using std::integral_constant;
  auto by_np = [&](auto v) {
    if constexpr (sizeof(T) * decltype(v)::value >= 16)
      return f(v, integral_constant<int, 1>{});
    else
      return np == 2 ? f(v, integral_constant<int, 2>{}) : f(v, integral_constant<int, 1>{});
  };
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) * 8 <= 16) return by_np(integral_constant<int, 8>{});
      return (int)cudaErrorInvalidValue;
    case 4: return by_np(integral_constant<int, 4>{});
    case 2: return by_np(integral_constant<int, 2>{});
    default: return by_np(integral_constant<int, 1>{});
  }
}

}  // namespace nbr
