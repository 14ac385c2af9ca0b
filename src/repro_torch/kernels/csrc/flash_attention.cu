// Prefill flash attention with GQA and causal / sliding-window masks:
//
//     out[b, h, i] = softmax_j(q[b, h, i] · k[b, h / rep, j] / sqrt(Dh)) v[b, h / rep, j]
//
// with q rows aligned to the end of the keys (qpos = i + Sk - Sq), a causal
// mask kpos <= qpos, a window mask kpos > qpos - window, -1e30 for masked
// logits and a final division by max(l, 1e-30), as the TPU kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel).  The TPU walks the k tiles
// as the sequential innermost grid axis and carries the running max,
// denominator and accumulator in VMEM scratch; here one block owns one
// (batch, q head, 64-row q tile), reads its kv head h / rep (no repeated
// K/V), and loops over 64-row k/v tiles staged in shared memory, keeping the
// running max, denominator and f32 accumulator in registers.  k tiles that
// the causal or window mask empties for every row of the q tile are not
// visited.  A row with no valid key (only when Sq > Sk, causal) is finite,
// never NaN, and the TPU kernel's: a q tile that holds such a row visits
// every k tile, all its logits are -1e30, so its weights are equal and it
// gets the mean of v over the Sk keys.  Key slots past Sk in the last tile
// get -inf, a weight of exactly 0, so they never count.
// Probabilities are rounded to the input type before the P·V product, as
// the TPU kernel's p.astype(v.dtype).
//
// Bound on the H100: at the zamba2-1.2b prefill shape (B=4 Hq=Hkv=32 S=512
// Dh=64, bf16, causal) the function moves ~34 MB (~10 µs) and does ~4.3
// GFLOP of causal work (Q·Kᵀ and P·V), ~4 µs at the bf16 tensor-core peak
// but ~64 µs as f32 FMA on CUDA cores, so it is bound by operations while
// it stays off the tensor cores.  Design: 256
// threads as a 16x16 grid, each holding a 4x4 tile of the 64x64 logits and
// a 4 x Dh/16 tile of the output; rows of q and k are padded to an odd
// stride so the rows a warp reads fall in distinct banks; row max and sum
// are reduced across the 16 lanes of a row with shuffles.  Templated on
// Dh in {64, 128}.  wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// round to the input type and back (identity for f32)
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Hq, int Hkv, int Sq, int Sk, int causal, int window,
    float scale) {
  constexpr int LDQ = DH + 1, LDP = BK + 1, E = DH / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][LDQ]
  float* ks = qs + BQ * LDQ;     // [BK][LDQ]
  float* vs = ks + BK * LDQ;     // [BK][DH]
  float* ps = vs + BK * DH;      // [BQ][LDP]

  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int off = Sk - Sq;
  const T* qb = q + ((size_t)b * Hq + hq) * Sq * DH;
  const T* kb = k + ((size_t)b * Hkv + hk) * Sk * DH;
  const T* vb = v + ((size_t)b * Hkv + hk) * Sk * DH;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i - r * DH;
    qs[r * LDQ + d] = q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * DH + d]) : 0.f;
  }

  // the k tiles some row of this q tile can see
  const int qlo = q0 + off, qhi = min(q0 + BQ, Sq) - 1 + off;
  const int n_tiles = (Sk + BK - 1) / BK;
  int t_end = n_tiles;
  if (causal && qlo >= 0) t_end = min(n_tiles, qhi / BK + 1);
  int t_begin = 0;
  if (window > 0 && qlo - window + 1 > 0) t_begin = (qlo - window + 1) / BK;

  float m[4], l[4], o[4][E];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) o[r][e] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done (and q is staged)
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i - r * DH;
      const bool in = k0 + r < Sk;
      ks[r * LDQ + d] = in ? to_f32(kb[(size_t)(k0 + r) * DH + d]) : 0.f;
      vs[r * DH + d] = in ? to_f32(vb[(size_t)(k0 + r) * DH + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(ty + 16 * r) * LDQ + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * LDQ + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r + off;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        bool ok = true;
        if (causal) ok = kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[r][c] = kpos >= Sk ? -__int_as_float(0x7f800000) : ok ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max16(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        ps[(ty + 16 * r) * LDP + tx + 16 * c] = round_as(p, q);
      }
      l[r] = l[r] * alpha + row_sum16(sum);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) o[r][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[E];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ps[(ty + 16 * r) * LDP + j];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = vs[j * DH + tx + 16 * e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) o[r][e] = fmaf(pv[r], vv[e], o[r][e]);
    }
  }

  T* ob = out + ((size_t)b * Hq + hq) * Sq * DH;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) store(ob + (size_t)row * DH + tx + 16 * e, o[r][e] / den);
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, void* out, int B, int Hq,
              int Hkv, int Sq, int Sk, int causal, int window, float scale,
              void* stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (DH + 1) + (size_t)BK * (DH + 1) +
                                       (size_t)BK * DH + (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<T, DH><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq,
           int Hkv, int Sq, int Sk, int Dh, int causal, int window, float scale,
           void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (Dh == 64)
    return launch_dh<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, window, scale, stream);
  if (Dh == 128)
    return launch_dh<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int Sq, int Sk, int Dh,
                                   int causal, int window, float scale, void* stream) {
  return launch<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, causal, window, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int Hq, int Hkv, int Sq, int Sk, int Dh,
                                    int causal, int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, causal, window, scale,
                               stream);
}
