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

// The backward kernels gather rows by the graph's reverse-slot index: lane u
// of a warp holds the row of one reverse slot, and the warp gathers up to
// flight_rows such rows at once, every load issued before any is used, so a
// source row of in-degree <= flight_rows waits for one gather round trip
// (the forward's kUnroll = 4 groups would make it wait for several).  The
// budget keeps the raw rows in flight within kFlightRegs registers a lane;
// with_group sizes each group to the rows it has.
constexpr int kFlightRegs = 64;

template <int VEC, int NP>
__host__ __device__ constexpr int flight_rows(int rows_per_slot, int most = 32) {
  const int r = kFlightRegs / (VEC * NP * rows_per_slot);
  return r < most ? r : most;
}

// Calls f(std::integral_constant<int, G>) for the least power of two G from
// kMinGroup up that holds cnt (warp-uniform, 1 <= cnt <= MAXG): a group of
// rows in flight sized to the rows at hand, since each place in a group
// costs a shuffle (the broadcast of its row; an SM's warps share one shuffle
// unit) and a predicated load whether a row is there or not.
constexpr int kMinGroup = 4;

template <int MAXG, int G = kMinGroup, typename F>
__device__ __forceinline__ void with_group(int cnt, F&& f) {
  if constexpr (G < MAXG) {
    if (cnt > G) return with_group<MAXG, 2 * G>(cnt, f);
  }
  f(std::integral_constant<int, G>{});
}

// Rows row_u of g (row_u: lane base + u's `row`) at this lane's columns from
// `first`, for u < R with base + u < cnt (warp-uniform), all in flight; and
// the same rows of g2 where it is given, on the same broadcast of row_u.
template <int VEC, int NP, int R>
__device__ __forceinline__ void gather_rows(const float* __restrict__ g, int hdim, int first,
                                            int row, int base, int cnt,
                                            RawVec<float, VEC> (&r)[R][NP],
                                            const float* __restrict__ g2 = nullptr,
                                            RawVec<float, VEC> (*r2)[NP] = nullptr) {
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const size_t off = (size_t)__shfl_sync(kFull, row, (base + u) & 31) * hdim;
    if (base + u < cnt) {
      load_cols<float, VEC, NP>(g + off, first, hdim, r[u]);
      if (g2 != nullptr) load_cols<float, VEC, NP>(g2 + off, first, hdim, r2[u]);
    }
  }
}

// This lane's part of a dot product over its columns of one block, added to
// `part`: the same bits whichever of the two rows is a or b.
template <int VEC, int NP>
__device__ __forceinline__ float dot_cols(const float (&a)[NP][VEC], const float (&b)[NP][VEC],
                                          float part) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < VEC; ++i) part = fmaf(a[p][i], b[p][i], part);
  return part;
}

// One level of transpose_sum: lanes l and l ^ O add their parts.  While O is
// at least the number of sums, every lane keeps all of them (warp_sum's
// step); below, each lane keeps the half whose bit O matches its own and
// sends the other half.
template <int O, int NV>
__device__ __forceinline__ void transpose_level(float (&v)[NV], int lane) {
  if constexpr (O >= NV) {
#pragma unroll
    for (int s = 0; s < NV; ++s) v[s] += __shfl_xor_sync(kFull, v[s], O);
  } else {
    const bool up = lane & O;
#pragma unroll
    for (int s = 0; s < O; ++s) {
      const float send = up ? v[s] : v[s + O];
      const float keep = up ? v[s + O] : v[s];
      v[s] = keep + __shfl_xor_sync(kFull, send, O);
    }
  }
}

// v[u] holds this lane's part of sum u (u < NV, a power of two <= 32); lane
// l gets the warp's sum of parts l % NV, all NV sums in 31 shuffles or
// fewer.  Each level adds the pairs of lanes that warp_sum's butterfly
// adds, so a sum has the bits warp_sum gives it, however many other sums
// come with it.
template <int NV>
__device__ __forceinline__ float transpose_sum(float (&v)[NV]) {
  static_assert(NV >= 1 && NV <= 32 && (NV & (NV - 1)) == 0, "NV: a power of two <= 32");
  const int lane = threadIdx.x & 31;
  transpose_level<16>(v, lane);
  transpose_level<8>(v, lane);
  transpose_level<4>(v, lane);
  transpose_level<2>(v, lane);
  transpose_level<1>(v, lane);
  return v[0];
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
