// Single-token GQA decode attention over a KV cache (flash-decoding):
//
//     out[b, h] = softmax_s(q[b, h] · k[b, h / rep, s] / sqrt(Dh)) v[b, h / rep, s]
//
// over the valid positions s < kv_len[b] (and s >= kv_len[b] - window with a
// window), with -1e30 masking and a final division by max(l, 1e-30), as the
// TPU kernel.
//
// Replaces the TPU kernel src/repro/kernels/gqa_decode.py::gqa_decode_pallas
// (body _decode_kernel).  Its structural saving is kept: one block owns one
// (batch, kv head) pair and all rep q heads of that group, so each k/v tile
// is read from memory once for the whole group.  The TPU streams every tile
// of the S_max buffer and masks; here the block starts at the window's first
// valid position and stops at the sequence's kv_len, so only valid
// positions are read.  64-row k/v tiles are staged in shared memory; the
// running max and denominator of each q head live in shared memory (one warp
// updates each head), the f32 accumulator in registers.  Probabilities are
// rounded to the input type before the P·V product, as the TPU kernel's
// p.astype(v.dtype).  kv_len <= 0 gives 0.
//
// Bound on the H100: memory.  At the zamba2-1.2b decode shape (B=4 Hq=Hkv=32
// S_max=544 Dh=64, bf16) one step reads at most ~18 MB of cache (~5 µs at
// 3.35 TB/s) and does ~2 FLOP per byte.  Design: 128 threads per block; tile
// loads are coalesced along Dh; k rows are padded to an odd stride so the
// threads computing neighbouring logits read distinct banks.  One block per
// (batch, kv head) is 128 blocks at that shape, under one wave of the 132
// SMs; splitting the keys across blocks (split-K) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 64, THREADS = 128, MAX_REP = 16;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) gqa_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_len, T* __restrict__ out, int Hkv, int rep, int S,
    int window, float scale) {
  constexpr int LDK = DH + 1, KMAX = MAX_REP * DH / THREADS;
  extern __shared__ float smem[];
  float* qs = smem;               // [rep][DH]
  float* ks = qs + rep * DH;      // [BK][LDK]
  float* vs = ks + BK * LDK;      // [BK][DH]
  float* ps = vs + BK * DH;       // [rep][BK] logits, then probabilities
  float* ms = ps + rep * BK;      // [rep] running max
  float* ls = ms + rep;           // [rep] running denominator
  float* al = ls + rep;           // [rep] this tile's rescale factor

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hq0 = hk * rep;
  const T* qb = q + ((size_t)b * Hkv * rep + hq0) * DH;
  const T* kb = k + ((size_t)b * Hkv + hk) * S * DH;
  const T* vb = v + ((size_t)b * Hkv + hk) * S * DH;

  for (int i = tid; i < rep * DH; i += THREADS) qs[i] = to_f32(qb[i]);
  for (int r = tid; r < rep; r += THREADS) {
    ms[r] = NEG_INF;
    ls[r] = 0.f;
  }
  const int hi = min(kv_len[b], S);
  const int lo = window > 0 ? max(hi - window, 0) : 0;
  const int n_out = rep * DH;

  float acc[KMAX];
#pragma unroll
  for (int e = 0; e < KMAX; ++e) acc[e] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and q is staged)
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i - r * DH;
      const bool in = k0 + r < hi;
      ks[r * LDK + d] = in ? to_f32(kb[(size_t)(k0 + r) * DH + d]) : 0.f;
      vs[r * DH + d] = in ? to_f32(vb[(size_t)(k0 + r) * DH + d]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < rep * BK; e += THREADS) {
      const int r = e / BK, j = e - r * BK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(qs[r * DH + d], ks[j * LDK + d], s);
      ps[e] = k0 + j < hi ? s * scale : NEG_INF;
    }
    __syncthreads();
    for (int r = warp; r < rep; r += THREADS / 32) {
      const float s0 = ps[r * BK + lane], s1 = ps[r * BK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[r], m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[r * BK + lane] = round_as(p0, q);
      ps[r * BK + lane + 32] = round_as(p1, q);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al[r] = alpha;
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < KMAX; ++e) {
      const int o = tid + THREADS * e;
      if (o >= n_out) break;
      const int r = o / DH, d = o - r * DH;
      float a = acc[e] * al[r];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a = fmaf(ps[r * BK + j], vs[j * DH + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * Hkv * rep + hq0) * DH;
#pragma unroll
  for (int e = 0; e < KMAX; ++e) {
    const int o = tid + THREADS * e;
    if (o >= n_out) break;
    store(ob + o, acc[e] / fmaxf(ls[o / DH], 1e-30f));
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* kv_len, void* out,
              int B, int Hkv, int rep, int S, int window, float scale, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)rep * DH + (size_t)BK * (DH + 1) +
                                       (size_t)BK * DH + (size_t)rep * BK + 3 * (size_t)rep);
  cudaError_t err = cudaFuncSetAttribute(gqa_decode_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  gqa_decode_kernel<T, DH><<<dim3(Hkv, B), THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)kv_len, (T*)out, Hkv, rep, S,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* out,
           int B, int Hkv, int rep, int S, int Dh, int window, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || rep <= 0 || rep > MAX_REP || S <= 0)
    return (int)cudaErrorInvalidValue;
  if (Dh == 64)
    return launch_dh<T, 64>(q, k, v, kv_len, out, B, Hkv, rep, S, window, scale, stream);
  if (Dh == 128)
    return launch_dh<T, 128>(q, k, v, kv_len, out, B, Hkv, rep, S, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int gqa_decode_f32(const void* q, const void* k, const void* v, const void* kv_len,
                              void* out, int B, int Hkv, int rep, int S, int Dh, int window,
                              float scale, void* stream) {
  return launch<float>(q, k, v, kv_len, out, B, Hkv, rep, S, Dh, window, scale, stream);
}

extern "C" int gqa_decode_bf16(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, int B, int Hkv, int rep, int S,
                               int Dh, int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, out, B, Hkv, rep, S, Dh, window, scale,
                               stream);
}
