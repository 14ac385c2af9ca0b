// Single-token GQA decode attention over a KV cache (split-K flash-decoding):
//
//     out[b, h] = softmax_s(q[b, h] · k[b, h / rep, s] / sqrt(Dh)) v[b, h / rep, s]
//
// over the valid positions s in [max(kv_len[b] - window, 0), min(kv_len[b], S))
// (the window's low end is taken from kv_len itself, not from min(kv_len, S)),
// with a final division by max(l, 1e-30), as the TPU kernel.  Where no
// position is valid (kv_len <= 0, or a window that lies wholly past S) the
// TPU kernel's logits are all -1e30 over the S slots of the buffer, its
// weights all equal, and the result is the mean of v over all S slots; this
// kernel computes that mean too (in f32, rounded to the output type).
//
// Replaces the TPU kernel src/repro/kernels/gqa_decode.py::gqa_decode_pallas
// (body _decode_kernel), which walks the buffer's tiles as the sequential
// innermost grid axis and carries the running max, denominator and
// accumulator in VMEM.  Its structural saving is kept: a block reads one
// chunk of cache rows for all rep q heads of its kv head, so each k/v row is
// read once for the whole group.
//
// Bound on the H100: memory.  At the zamba2-1.2b decode shape (B=4 Hq=Hkv=32
// S=kv_len=544 Dh=64, bf16) the step reads ~18 MB of cache (~5 µs at
// 3.35 TB/s) and does ~2 FLOP per byte.  Design, two kernels per call:
//   pass 1, grid (S / 64 splits, Hkv, B) (1,152 blocks at that shape, ~9
//   per SM, all resident at once, where one block per (b, kv head) gave 128
//   blocks for 132 SMs): each block issues its
//   whole 64-row chunk of k and of v as 16-byte cp.async copies (two groups,
//   so the logits are computed while v still arrives), computes the logits
//   with Dh/8 lanes per cache row, 8 elements each, reduced by shuffles (no
//   lane idles at rep = 1), the chunk's softmax with its own max, and P·V
//   with 8 lanes per 8 output columns whose sums are reduce-scattered by
//   shuffles; it writes an f32 partial (m, l, acc[Dh]) per (b, q head,
//   split) to scratch.  Chunks outside the valid range read nothing and
//   write a neutral partial (m = -inf, l = 0).
//   pass 2: one warp per (b, q head) merges the partials in split order
//   (deterministic, no atomics) and divides by max(l, 1e-30).
// The grid is sized from S, never from kv_len, so the wrapper never reads
// kv_len on the host and the call can be captured in a CUDA graph.
// Probabilities are rounded to the input type before the P·V product, as
// the TPU kernel's p.astype(v.dtype), relative to the chunk's own max.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int CHUNK = 64, THREADS = 128, MAX_REP = 16;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 consecutive elements from 16-byte aligned shared memory, as f32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Pass 1: one block per (split, kv head, batch).  Partials are indexed by
// row = b * Hq + q head (= (b * Hkv + hk) * rep + r) and split.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) gqa_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_len, float* __restrict__ part_acc,
    float2* __restrict__ part_ml, int Hkv, int rep, int S, int window, float scale) {
  constexpr int EV = 16 / sizeof(T);    // elements per 16-byte vector
  constexpr int LD = DH + EV;           // smem row stride: one vector of pad
  constexpr int VPR = DH / EV;          // 16-byte vectors per row
  constexpr int LPR = DH / 8;           // lanes per row in the dot products
  constexpr int NV = DH / 8;            // groups of 8 output columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);             // [CHUNK][LD]
  T* vs = ks + CHUNK * LD;                            // [CHUNK][LD]
  float* qs = reinterpret_cast<float*>(vs + CHUNK * LD);   // [rep][DH]
  float* ps = qs + rep * DH;                          // [rep][CHUNK]

  const int split = blockIdx.x, n_split = gridDim.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = split * CHUNK;
  const int len = kv_len[b];
  const int hi = min(len, S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const bool empty = lo >= hi;   // no valid position: every slot weighs the same
  const int r_lo = empty ? c0 : max(c0, lo);
  const int r_hi = min(c0 + CHUNK, empty ? S : hi);
  const size_t row0 = ((size_t)b * Hkv + hk) * rep;
  if (r_lo >= r_hi) {   // no row of this chunk takes part
    for (int r = tid; r < rep; r += THREADS)
      part_ml[(row0 + r) * n_split + split] = make_float2(neg_inf(), 0.f);
    return;
  }

  const size_t kv0 = ((size_t)b * Hkv + hk) * S * DH;
  for (int i = tid; i < CHUNK * VPR; i += THREADS) {   // k: its own group
    const int r = i / VPR, c = (i - r * VPR) * EV, row = c0 + r;
    const bool in = !empty && row >= r_lo && row < r_hi;
    cp_async16(ks + r * LD + c, k + kv0 + (size_t)(in ? row : r_lo) * DH + c, in);
  }
  cp_async_commit();
  for (int i = tid; i < CHUNK * VPR; i += THREADS) {
    const int r = i / VPR, c = (i - r * VPR) * EV, row = c0 + r;
    const bool in = row >= r_lo && row < r_hi;
    cp_async16(vs + r * LD + c, v + kv0 + (size_t)(in ? row : r_lo) * DH + c, in);
  }
  cp_async_commit();
  const T* qb = q + row0 * DH;
  for (int i = tid; i < rep * DH; i += THREADS) qs[i] = to_f32(qb[i]);
  cp_async_wait<1>();
  __syncthreads();

  // logits: LPR lanes per cache row, 8 elements each, summed by shuffles
  {
    const int part = tid % LPR;
    for (int j = tid / LPR; j < CHUNK; j += THREADS / LPR) {
      float kx[8];
      load8(ks + j * LD + part * 8, kx);
      for (int r = 0; r < rep; ++r) {
        float qx[8];
        load8(qs + r * DH + part * 8, qx);
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qx[e], kx[e], s);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (part == 0) ps[r * CHUNK + j] = s;
      }
    }
  }
  __syncthreads();

  // the chunk's softmax, one warp per q head: rows outside the range weigh
  // 0; with no valid position every slot's logit is -1e30 (weight 1)
  for (int r = warp; r < rep; r += THREADS / 32) {
    float s[2];
    float mx = neg_inf();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h, row = c0 + j;
      s[h] = row < r_lo || row >= r_hi ? neg_inf()
             : empty                    ? NEG_INF
                                        : ps[r * CHUNK + j] * scale;
      mx = fmaxf(mx, s[h]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p = expf(s[h] - mx);
      sum += p;
      ps[r * CHUNK + lane + 32 * h] = round_as(p, q);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) part_ml[(row0 + r) * n_split + split] = make_float2(mx, sum);
  }
  cp_async_wait<0>();
  __syncthreads();

  // P·V: 8 lanes per (q head, 8 output columns), lane g summing rows
  // g, g + 8, ...; a reduce-scatter over the 8 lanes leaves column g's sum
  // in lane g.  rep * DH tasks, a multiple of 32, so warps stay converged.
  for (int t = tid; t < rep * DH; t += THREADS) {
    const int g = t % 8, dv = (t / 8) % NV, r = t / 8 / NV;
    float a[8] = {};
#pragma unroll
    for (int i = 0; i < CHUNK / 8; ++i) {
      const int j = g + 8 * i;
      const float p = ps[r * CHUNK + j];
      float vx[8];
      load8(vs + j * LD + dv * 8, vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = fmaf(p, vx[e], a[e]);
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1) {   // keep half, send half, add the partner's
      const bool upper = g & w;
#pragma unroll
      for (int e = 0; e < w; ++e) {
        const float send = upper ? a[e] : a[e + w];
        const float keep = upper ? a[e + w] : a[e];
        a[e] = keep + __shfl_xor_sync(0xffffffffu, send, w);
      }
    }
    part_acc[((row0 + r) * n_split + split) * DH + dv * 8 + g] = a[0];
  }
}

// Pass 2: one warp per (b, q head) row merges its n_split partials in split
// order; a neutral split weighs 0 and its accumulator is never read.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) gqa_decode_combine_kernel(
    const float* __restrict__ part_acc, const float2* __restrict__ part_ml,
    T* __restrict__ out, int rows, int n_split) {
  constexpr int E = DH / 32;
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float2* ml = part_ml + (size_t)row * n_split;
  float m = neg_inf();
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, ml[i].x);
  float l = 0.f, acc[E] = {};
  for (int i = 0; i < n_split; ++i) {
    const float2 p = ml[i];
    if (p.x == neg_inf()) continue;
    const float w = expf(p.x - m);
    l += p.y * w;
    const float* a = part_acc + ((size_t)row * n_split + i) * DH;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(a[lane + 32 * e], w, acc[e]);
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) store(out + (size_t)row * DH + lane + 32 * e, acc[e] / den);
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* kv_len, void* out,
              void* scratch, int B, int Hkv, int rep, int S, int n_split, int window,
              float scale, void* stream) {
  const size_t smem = 2 * (size_t)CHUNK * (DH + 16 / sizeof(T)) * sizeof(T) +
                      sizeof(float) * (size_t)rep * (DH + CHUNK);
  cudaError_t err = cudaFuncSetAttribute(gqa_decode_split_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * Hkv * rep;
  float* part_acc = static_cast<float*>(scratch);
  float2* part_ml = reinterpret_cast<float2*>(part_acc + (size_t)rows * n_split * DH);
  const cudaStream_t s = (cudaStream_t)stream;
  gqa_decode_split_kernel<T, DH><<<dim3(n_split, Hkv, B), THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)kv_len, part_acc, part_ml, Hkv, rep,
      S, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_block = THREADS / 32;
  gqa_decode_combine_kernel<T, DH><<<(rows + per_block - 1) / per_block, THREADS, 0, s>>>(
      part_acc, part_ml, (T*)out, rows, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* out,
           void* scratch, int B, int Hkv, int rep, int S, int Dh, int n_split, int window,
           float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || rep <= 0 || rep > MAX_REP || S <= 0 ||
      n_split != (S + CHUNK - 1) / CHUNK)
    return (int)cudaErrorInvalidValue;
  if (Dh == 64)
    return launch_dh<T, 64>(q, k, v, kv_len, out, scratch, B, Hkv, rep, S, n_split, window,
                            scale, stream);
  if (Dh == 128)
    return launch_dh<T, 128>(q, k, v, kv_len, out, scratch, B, Hkv, rep, S, n_split, window,
                             scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// scratch: B * Hkv * rep * n_split * (Dh + 2) floats, n_split = ceil(S / 64)
extern "C" int gqa_decode_f32(const void* q, const void* k, const void* v, const void* kv_len,
                              void* out, void* scratch, int B, int Hkv, int rep, int S, int Dh,
                              int n_split, int window, float scale, void* stream) {
  return launch<float>(q, k, v, kv_len, out, scratch, B, Hkv, rep, S, Dh, n_split, window,
                       scale, stream);
}

extern "C" int gqa_decode_bf16(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, void* scratch, int B, int Hkv,
                               int rep, int S, int Dh, int n_split, int window, float scale,
                               void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, out, scratch, B, Hkv, rep, S, Dh, n_split,
                               window, scale, stream);
}
