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
// the TPU kernel's p.astype(v.dtype); the denominator sums them unrounded.
//
// Bound on the H100: at the zamba2-1.2b prefill shape (B=4 Hq=Hkv=32 S=512
// Dh=64, bf16, causal) the function moves ~34 MB (~10 µs) and does ~4.3
// GFLOP of causal work (Q·Kᵀ and P·V): ~4 µs at the bf16 tensor-core peak,
// so it is bound by bytes once the products run on the tensor cores, and by
// operations (~64 µs) while they run as f32 FMA on CUDA cores.
//
// bf16 (the serving path), FlashAttention-2 style on the tensor cores:
// 4 warps per block, 16 q rows each (at Dh=64 held to 128 registers, so
// four blocks share an SM); the heaviest causal q tiles are launched first
// (the q tile is the slowest grid index, reversed).  Q is
// loaded once and its mma fragments stay in registers; the k/v tiles are
// double-buffered in shared memory by 16-byte cp.async, so the next tile
// arrives during this tile's math; rows are padded by 16 bytes, so ldmatrix
// reads are free of bank conflicts.  Q·Kᵀ and P·V are
// mma.sync.m16n8k16 bf16 products with f32 accumulators (the TPU kernel's
// bf16 dots with f32 accumulation).  The online softmax runs in registers
// in base 2 (the scale times log2(e) applied after the dot), row max and
// sum reduced across each quad of lanes; masks are applied only on tiles
// that cross the diagonal, the window's edge or Sk.  P is rounded to bf16
// in registers and fed to the P·V mma as its A operand (the m16n8
// accumulator layout is the m16n8k16 A layout), V's fragments come from
// ldmatrix.trans.  The output is staged in shared memory and written with
// 16-byte stores.  wgmma and TMA are later work.
//
// f32 (the zoo's f32 agreement run on the card) keeps CUDA-core f32 FMA:
// tensor cores would round the products to TF32 (~3 digits), which would
// not hold the 1e-5 agreement with the plain version.  256 threads as a
// 16x16 grid, each holding a 4x4 tile of the 64x64 logits and a 4 x Dh/16
// tile of the output; rows of q and k are padded to an odd stride so the
// rows a warp reads fall in distinct banks; row max and sum are reduced
// across the 16 lanes of a row with shuffles.
//
// Both are templated on Dh in {64, 128}.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64, BK = 64;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// The k tiles [t_begin, t_end) that some row of the q tile at q0 can see.
__device__ __forceinline__ void tile_range(int q0, int Sq, int Sk, int causal, int window,
                                           int& t_begin, int& t_end) {
  const int off = Sk - Sq;
  const int qlo = q0 + off, qhi = min(q0 + BQ, Sq) - 1 + off;
  const int n_tiles = (Sk + BK - 1) / BK;
  t_end = n_tiles;
  if (causal && qlo >= 0) t_end = min(n_tiles, qhi / BK + 1);
  t_begin = 0;
  if (window > 0 && qlo - window + 1 > 0) t_begin = (qlo - window + 1) / BK;
}

// ------------------------------------------------------------ f32, CUDA cores
constexpr int F32_THREADS = 256;

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

template <int DH>
__global__ void __launch_bounds__(F32_THREADS) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int Hq, int Hkv, int Sq, int Sk, int causal, int window,
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
  const float* qb = q + ((size_t)b * Hq + hq) * Sq * DH;
  const float* kb = k + ((size_t)b * Hkv + hk) * Sk * DH;
  const float* vb = v + ((size_t)b * Hkv + hk) * Sk * DH;

  for (int i = tid; i < BQ * DH; i += F32_THREADS) {
    const int r = i / DH, d = i - r * DH;
    qs[r * LDQ + d] = q0 + r < Sq ? qb[(size_t)(q0 + r) * DH + d] : 0.f;
  }

  int t_begin, t_end;
  tile_range(q0, Sq, Sk, causal, window, t_begin, t_end);

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
    for (int i = tid; i < BK * DH; i += F32_THREADS) {
      const int r = i / DH, d = i - r * DH;
      const bool in = k0 + r < Sk;
      ks[r * LDQ + d] = in ? kb[(size_t)(k0 + r) * DH + d] : 0.f;
      vs[r * DH + d] = in ? vb[(size_t)(k0 + r) * DH + d] : 0.f;
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
        s[r][c] = kpos >= Sk ? neg_inf() : ok ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max16(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        ps[(ty + 16 * r) * LDP + tx + 16 * c] = p;
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

  float* ob = out + ((size_t)b * Hq + hq) * Sq * DH;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) ob[(size_t)row * DH + tx + 16 * e] = o[r][e] / den;
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
               int Sq, int Sk, int causal, int window, float scale, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (DH + 1) + (size_t)BK * (DH + 1) +
                                       (size_t)BK * DH + (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_f32_kernel<DH><<<grid, F32_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Hq, Hkv, Sq, Sk, causal,
      window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16, tensor cores
constexpr int MMA_THREADS = 128;   // 4 warps x 16 q rows
using bf16 = __nv_bfloat16;

// rows [row0, row0 + 64) of a [rows, DH] matrix into smem rows of stride LD;
// rows past `rows` are zero-filled
template <int DH, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int rows) {
  constexpr int VPR = DH / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += MMA_THREADS) {
    const int r = i / VPR, c = (i - r * VPR) * 8;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * LD + c, src + (size_t)(in ? row0 + r : 0) * DH + c, in);
  }
}

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS, DH == 64 ? 4 : 1) flash_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int Hq, int Hkv, int Sq, int Sk, int causal, int window,
    float scale_log2) {
  constexpr int LD = DH + 8;      // smem row stride: 16 bytes of pad
  constexpr int KSL = DH / 16;    // 16-wide slices of Dh for Q·Kᵀ
  constexpr int NT = DH / 8;      // 8-wide n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD], later the output
  bf16* ks = qs + BQ * LD;                        // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                    // [2][BK][LD]

  const int n_qt = (Sq + BQ - 1) / BQ, heads = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / heads, bh = (int)blockIdx.x % heads;
  const int hq = bh % Hq, b = bh / Hq, hk = hq / (Hq / Hkv);
  const int q0 = qt * BQ, off = Sk - Sq;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* qb = q + ((size_t)b * Hq + hq) * Sq * DH;
  const bf16* kb = k + ((size_t)b * Hkv + hk) * Sk * DH;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * Sk * DH;

  int t_begin, t_end;
  tile_range(q0, Sq, Sk, causal, window, t_begin, t_end);

  load_tile<DH, LD>(qs, qb, q0, Sq);
  cp_async_commit();
  if (t_begin < t_end) {
    load_tile<DH, LD>(ks, kb, t_begin * BK, Sk);
    load_tile<DH, LD>(vs, vb, t_begin * BK, Sk);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 q rows as A fragments, one per 16-wide slice of Dh
  unsigned qf[KSL][4];
#pragma unroll
  for (int kk = 0; kk < KSL; ++kk)
    ldsm_x4(qs + (warp * 16 + lane % 8 + (lane / 8 % 2) * 8) * LD + kk * 16 + lane / 16 * 8,
            qf[kk]);

  // each lane holds rows g and g + 8 of the warp's 16, columns 2(lane%4), +1
  // of every 8-wide n-tile
  const int g = lane / 4;
  const int qp0 = q0 + warp * 16 + g + off, qp1 = qp0 + 8;
  const int qlo = q0 + off, qhi = q0 + BQ - 1 + off;   // over the whole q tile
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile<DH, LD>(ks + (buf ^ 1) * BK * LD, kb, (t + 1) * BK, Sk);
      load_tile<DH, LD>(vs + (buf ^ 1) * BK * LD, vb, (t + 1) * BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + buf * BK * LD;
    const bf16* vt = vs + buf * BK * LD;
    const int k0 = t * BK;

    // S = Q·Kᵀ: 16 x 64 per warp, 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSL; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        unsigned kf[4];   // keys 0-7 / 8-15 of the pair, Dh slice halves 0-7 / 8-15
        ldsm_x4(kt + (np * 16 + lane % 8 + lane / 16 * 8) * LD + kk * 16 + (lane / 8 % 2) * 8,
                kf);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale (base 2), then the masks where the tile crosses an edge
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qlo) ||
                      (window > 0 && k0 <= qhi - window);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const int qpos = e < 2 ? qp0 : qp1;
          bool ok = true;
          if (causal) ok = kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          x = kpos >= Sk ? neg_inf() : ok ? x : NEG_INF;
        }
        s[n][e] = x;
      }

    // online softmax over the quad that shares each row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    unsigned pf[BK / 16][4];   // P rounded to bf16, as A fragments per 16 keys
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = exp2f(s[n][0] - m0), p1 = exp2f(s[n][1] - m0);
      const float p2 = exp2f(s[n][2] - m1), p3 = exp2f(s[n][3] - m1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pf[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + sum0;   // this lane's columns; summed over the quad at the end
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P·V: V fragments by ldmatrix.trans, 16 keys x 16 dims at a time
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        unsigned vf[4];   // keys 0-7 / 8-15, dims 0-7 / 8-15 of the pair
        ldsm_x4_trans(vt + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) * LD + dp * 16 +
                          lane / 16 * 8,
                      vf);
        mma_bf16(o[2 * dp], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  // stage the warp's 16 output rows in its own rows of qs, then 16-byte stores
  bf16* st = qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + (lane % 4) * 2;
    *reinterpret_cast<__nv_bfloat162*>(st + g * LD + c) =
        __floats2bfloat162_rn(o[n][0] / den0, o[n][1] / den0);
    *reinterpret_cast<__nv_bfloat162*>(st + (g + 8) * LD + c) =
        __floats2bfloat162_rn(o[n][2] / den1, o[n][3] / den1);
  }
  __syncwarp();
  bf16* ob = out + ((size_t)b * Hq + hq) * Sq * DH;
  for (int i = lane; i < 16 * (DH / 8); i += 32) {
    const int r = i / (DH / 8), c = (i - r * (DH / 8)) * 8, row = q0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(ob + (size_t)row * DH + c) =
          *reinterpret_cast<const uint4*>(st + r * LD + c);
  }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                int Hkv, int Sq, int Sk, int causal, int window, float scale, void* stream) {
  const size_t smem = sizeof(bf16) * (size_t)(BQ + 4 * BK) * (DH + 8);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * Hq * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float log2e = 1.4426950408889634f;
  flash_attention_bf16_kernel<DH><<<(unsigned)blocks, MMA_THREADS, smem,
                                    (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, Hq, Hkv, Sq, Sk, causal,
      window, scale * log2e);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int Sq, int Sk, int Dh, int causal, int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr bool f32 = sizeof(T) == 4;
  if (Dh == 64)
    return f32 ? launch_f32<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, window, scale, stream)
               : launch_bf16<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, window, scale,
                                 stream);
  if (Dh == 128)
    return f32 ? launch_f32<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, window, scale,
                                 stream)
               : launch_bf16<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, window, scale,
                                  stream);
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
