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

// A row's logsumexp in natural-log units from its running max m (natural
// units, NEG_INF when every key is masked) and sum l: what the forward
// writes under grad for the backward.  A row with every key masked (causal,
// q before the first key) weighs its Sk keys alike: log(l) = log(Sk).
constexpr float LN2 = 0.6931471805599453f;
__device__ __forceinline__ float row_lse(float m, float l) {
  return m == NEG_INF ? logf(l) : m + logf(l);
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
    float* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
    int causal, int window, float scale) {
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
    if (lse && tx == 0)
      lse[((size_t)b * Hq + hq) * Sq + row] = row_lse(m[r], l[r]);
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int Hq, int Hkv, int Sq, int Sk, int causal, int window, float scale,
               void* stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (DH + 1) + (size_t)BK * (DH + 1) +
                                       (size_t)BK * DH + (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_f32_kernel<DH><<<grid, F32_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, Hq, Hkv, Sq, Sk,
      causal, window, scale);
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
    bf16* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
    int causal, int window, float scale_log2) {
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
  if (lse && lane % 4 == 0) {   // m is in base 2: lse = m ln 2 + ln l
    float* lb = lse + ((size_t)b * Hq + hq) * Sq;
    const int r0 = q0 + warp * 16 + g;
    if (r0 < Sq) lb[r0] = row_lse(m0 == NEG_INF ? m0 : m0 * LN2, l0);
    if (r0 + 8 < Sq) lb[r0 + 8] = row_lse(m1 == NEG_INF ? m1 : m1 * LN2, l1);
  }
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
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Hq, int Hkv, int Sq, int Sk, int causal, int window, float scale,
                void* stream) {
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
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, lse, Hq, Hkv, Sq, Sk,
      causal, window, scale * log2e);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Hq,
           int Hkv, int Sq, int Sk, int Dh, int causal, int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr bool f32 = sizeof(T) == 4;
  if (Dh == 64)
    return f32 ? launch_f32<64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale,
                                stream)
               : launch_bf16<64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale,
                                 stream);
  if (Dh == 128)
    return f32 ? launch_f32<128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale,
                                 stream)
               : launch_bf16<128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale,
                                  stream);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ backward
//
// Gradients of the attention above with respect to q, k and v, from the
// forward's output O, the output's gradient dO and each row's logsumexp
// (written by the forward under grad), in closed form:
//
//     P = exp(s - lse),  delta_i = dO_i . O_i,  dS = P (dO Vᵀ - delta),
//     dq = scale dS K,  dk = scale dSᵀ Q,  dv = Pᵀ dO.
//
// There is no TPU kernel to replace: the reference differentiates its XLA
// path (src/repro/models/transformer.py forward_train, use_pallas=False).
// Its plain version is kernels/ref.py::flash_attention_bwd_ref.
//
// Bound on the H100: at zamba2-1.2b's training shape (B=4 Hq=Hkv=32 S=512
// Dh=64, bf16, causal) the function reads q, k, v, O, dO and writes dq, dk,
// dv (~67 MB, ~20 µs) and does five causal products (~10.7 GFLOP, ~11 µs
// at the bf16 tensor-core peak): bytes bound.
//
// Three kernels, no atomics, so two calls give the same bits:
//   1. delta = rowsum(dO ∘ O), a warp per row.
//   2. dk, dv: a block per (key tile of 64, kv head, batch) loops over the
//      kv head's q heads in order and, for each, over the q tiles that see
//      the key tile (tile_range), recomputing S and dP for the 64 x 64 tile
//      and summing Pᵀ dO and dSᵀ Q in registers.
//   3. dq: a block per (q tile of 64, q head, batch) loops over its key
//      tiles (tile_range) and sums dS K in registers.
// Masks as the forward's: a masked key has P = dS = 0, a key past Sk
// counts nothing, and a row with no valid key (causal, q before the first
// key, whose output is the mean of v) has P = 1 / Sk = exp(-lse) on every
// key and dS = 0.
//
// f32 (the zoo's f32 agreement run on the card), the first design: every
// product is f32 FMA on the CUDA cores from shared memory (tensor cores
// would round to TF32).  256 threads as a 16x16 grid, each holding a 4x4
// tile of the 64x64 S and dP and a 4 x Dh/16 tile of its output;
// shared-memory rows padded to an odd stride.
//
// bf16 (zamba2's training), FlashAttention-2's backward on the tensor
// cores, built from the forward's parts: 4 warps a block, 16 rows each;
// tiles double-buffered in shared memory by 16-byte cp.async, rows padded
// by 16 bytes for ldmatrix; all five products mma.sync.m16n8k16 bf16 with
// f32 accumulators.  dk/dv: a warp owns 16 keys; Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
// (K and V fragments loaded once and held in registers at Dh 64; at Dh 128
// read from shared memory each tile, and the q tile taken in two passes
// of 32 rows, so that the 16 x 128 dk and dv accumulators fit without
// spilling); Pᵀ and dSᵀ formed in registers in base 2, rounded to bf16
// and fed as A fragments (the forward's P·V repack) to dV += Pᵀ·dO and
// dK += dSᵀ·Q, dO and Q by ldmatrix.trans; the first key tiles (the
// heaviest under causal) launch first.  dq: a warp owns 16 q rows; Q, dO
// fragments, lse and delta in registers; S and dP by mma, dS rounded to
// bf16, dQ += dS·K with K by ldmatrix.trans (at Dh 128 the key tile in two
// passes of 32); the heaviest causal q tiles launch first.  Values are
// rounded to bf16 where they feed a product (P, dS) and at the outputs,
// and only there (kernels/ref.py::flash_attention_bwd_mma_ref models the
// same).  Takes Dh in {64, 128}.

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// rows [row0, row0 + 64) of a [rows, DH] matrix into f32 smem rows of
// stride DH + 1; rows past `rows` are zero
template <int DH, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0, int rows) {
  for (int i = threadIdx.x; i < 64 * DH; i += F32_THREADS) {
    const int r = i / DH, d = i - r * DH;
    dst[r * (DH + 1) + d] = row0 + r < rows ? to_f32(src[(size_t)(row0 + r) * DH + d]) : 0.f;
  }
}

template <typename T, int DH>
__global__ void flash_attention_bwd_delta_kernel(const T* __restrict__ out,
                                                 const T* __restrict__ dout,
                                                 float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32)
    acc += to_f32(out[row * DH + d]) * to_f32(dout[row * DH + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// One 64 x 64 tile of P and dS (this thread's 4 x 4: q rows ty + 16 r, keys
// tx + 16 c) from the staged q, dO (rows of the q tile), k and v (rows of
// the key tile), and the q rows' lse and delta.
template <int DH>
__device__ __forceinline__ void tile_p_ds(const float* qs, const float* dos, const float* ks,
                                          const float* vs, const float* lse_s,
                                          const float* delta_s, int q0, int k0, int Sq,
                                          int Sk, int causal, int window, float scale,
                                          float p[4][4], float ds[4][4]) {
  constexpr int LD = DH + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qv[r] = qs[(ty + 16 * r) * LD + d];
      ov[r] = dos[(ty + 16 * r) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = ks[(tx + 16 * c) * LD + d];
      vv[c] = vs[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
  }
  const int off = Sk - Sq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = ty + 16 * r, qpos = q0 + qi + off;
    const bool dead = causal && qpos < 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = k0 + tx + 16 * c;
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      if (ok) {
        p[r][c] = expf(s[r][c] * scale - lse_s[qi]);
        ds[r][c] = p[r][c] * (dp[r][c] - delta_s[qi]);
      } else {
        p[r][c] = dead && kpos < Sk ? expf(-lse_s[qi]) : 0.f;
        ds[r][c] = 0.f;
      }
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(F32_THREADS) flash_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Sq, int Sk, int causal,
    int window, float scale) {
  constexpr int LD = DH + 1, LDP = BK + 1, E = DH / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* qs = vs + BK * LD;      // [BQ][LD]
  float* dos = qs + BQ * LD;     // [BQ][LD]
  float* ps = dos + BQ * LD;     // [BQ][LDP]
  float* dss = ps + BQ * LDP;    // [BQ][LDP]
  float* lse_s = dss + BQ * LDP; // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]

  const int t = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, rep = Hq / Hkv;
  const int k0 = t * BK, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  stage_rows<DH>(ks, k + ((size_t)b * Hkv + hk) * Sk * DH, k0, Sk);
  stage_rows<DH>(vs, v + ((size_t)b * Hkv + hk) * Sk * DH, k0, Sk);

  float dka[4][E] = {}, dva[4][E] = {};
  const int n_qt = (Sq + BQ - 1) / BQ;
  for (int r_h = 0; r_h < rep; ++r_h) {
    const int hq = hk * rep + r_h;
    const size_t bh = (size_t)b * Hq + hq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      int t_begin, t_end;
      tile_range(q0, Sq, Sk, causal, window, t_begin, t_end);
      if (t < t_begin || t >= t_end) continue;
      __syncthreads();   // the previous q tile's readers are done
      stage_rows<DH>(qs, q + bh * Sq * DH, q0, Sq);
      stage_rows<DH>(dos, dout + bh * Sq * DH, q0, Sq);
      for (int i = threadIdx.x; i < BQ; i += F32_THREADS) {
        lse_s[i] = q0 + i < Sq ? lse[bh * Sq + q0 + i] : 0.f;
        delta_s[i] = q0 + i < Sq ? delta[bh * Sq + q0 + i] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      tile_p_ds<DH>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, Sq, Sk, causal, window, scale, p,
                    ds);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool row_in = q0 + ty + 16 * r < Sq;   // rows past Sq count nothing
          ps[(ty + 16 * r) * LDP + tx + 16 * c] = row_in ? p[r][c] : 0.f;
          dss[(ty + 16 * r) * LDP + tx + 16 * c] = row_in ? ds[r][c] : 0.f;
        }
      __syncthreads();
      // this thread's keys ty + 16 r, columns tx + 16 e: sums over the tile's q rows
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pv[4], dsv[4], ov[E], qv[E];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = ps[i * LDP + ty + 16 * r];
          dsv[r] = dss[i * LDP + ty + 16 * r];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          ov[e] = dos[i * LD + tx + 16 * e];
          qv[e] = qs[i * LD + tx + 16 * e];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            dva[r][e] = fmaf(pv[r], ov[e], dva[r][e]);
            dka[r][e] = fmaf(dsv[r], qv[e], dka[r][e]);
          }
      }
    }
  }
  const size_t base = ((size_t)b * Hkv + hk) * Sk * DH;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty + 16 * r;
    if (row >= Sk) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[base + (size_t)row * DH + tx + 16 * e] = from_f32<T>(dka[r][e] * scale);
      dv[base + (size_t)row * DH + tx + 16 * e] = from_f32<T>(dva[r][e]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(F32_THREADS) flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int LD = DH + 1, LDP = BK + 1, E = DH / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][LD]
  float* dos = qs + BQ * LD;     // [BQ][LD]
  float* ks = dos + BQ * LD;     // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* dss = vs + BK * LD;     // [BQ][LDP]
  float* lse_s = dss + BQ * LDP; // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]

  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv), tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t bh = (size_t)b * Hq + hq;
  stage_rows<DH>(qs, q + bh * Sq * DH, q0, Sq);
  stage_rows<DH>(dos, dout + bh * Sq * DH, q0, Sq);
  for (int i = threadIdx.x; i < BQ; i += F32_THREADS) {
    lse_s[i] = q0 + i < Sq ? lse[bh * Sq + q0 + i] : 0.f;
    delta_s[i] = q0 + i < Sq ? delta[bh * Sq + q0 + i] : 0.f;
  }
  int t_begin, t_end;
  tile_range(q0, Sq, Sk, causal, window, t_begin, t_end);
  const T* kb = k + ((size_t)b * Hkv + hk) * Sk * DH;
  const T* vb = v + ((size_t)b * Hkv + hk) * Sk * DH;

  float dqa[4][E] = {};
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's readers are done (and q is staged)
    stage_rows<DH>(ks, kb, k0, Sk);
    stage_rows<DH>(vs, vb, k0, Sk);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_p_ds<DH>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, Sq, Sk, causal, window, scale, p,
                  ds);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dss[(ty + 16 * r) * LDP + tx + 16 * c] = ds[r][c];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[4], kv[E];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = dss[(ty + 16 * r) * LDP + j];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = ks[j * LD + tx + 16 * e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) dqa[r][e] = fmaf(dsv[r], kv[e], dqa[r][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int e = 0; e < E; ++e)
      dq[bh * Sq * DH + (size_t)row * DH + tx + 16 * e] = from_f32<T>(dqa[r][e] * scale);
  }
}

template <typename T, int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
               int Hkv, int Sq, int Sk, int causal, int window, float scale, void* stream) {
  constexpr int LD = DH + 1, LDP = BK + 1;
  const size_t smem_kv = sizeof(float) * (4 * (size_t)BK * LD + 2 * (size_t)BQ * LDP + 2 * BQ);
  const size_t smem_q = sizeof(float) * (4 * (size_t)BK * LD + (size_t)BQ * LDP + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * Hq * Sq;
  flash_attention_bwd_delta_kernel<T, DH><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const T*)out, (const T*)dout, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dkdv_kernel<T, DH>
      <<<dim3((Sk + BK - 1) / BK, Hkv, B), F32_THREADS, smem_kv, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv,
          Hq, Hkv, Sq, Sk, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dq_kernel<T, DH>
      <<<dim3((Sq + BQ - 1) / BQ, Hq, B), F32_THREADS, smem_q, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, Hq, Hkv,
          Sq, Sk, causal, window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ backward, bf16, tensor cores
constexpr float LOG2E = 1.4426950408889634f;

// The dk/dv block of key tile t walks items i = r_h n_qt + qt (its kv
// head's q heads in order, then their q tiles); the next one after i that
// sees the tile, or total.  Not every q tile between the first and the last
// that see it does (a q tile with rows before the first key visits every
// key tile; the next one may not).
__device__ __forceinline__ int next_item(int i, int total, int n_qt, int t, int Sq, int Sk,
                                         int causal, int window) {
  for (++i; i < total; ++i) {
    int tb, te;
    tile_range((i % n_qt) * BQ, Sq, Sk, causal, window, tb, te);
    if (t >= tb && t < te) break;
  }
  return i;
}

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS) flash_attention_bwd_dkdv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq,
    int Hkv, int Sq, int Sk, int causal, int window, float scale, float scale_log2) {
  constexpr int LD = DH + 8, KSL = DH / 16, NT = DH / 8;
  constexpr bool KV_REGS = DH == 64;            // K and V fragments held in registers
  constexpr int QH = DH == 64 ? BQ : BQ / 2;    // q rows (columns of Sᵀ) a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][LD], at the end dk's staging
  bf16* vs = ks + BK * LD;                        // [BK][LD], at the end dv's
  bf16* qs = vs + BK * LD;                        // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;                   // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);   // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                              // [2][BQ]

  const int n_kt = (Sk + BK - 1) / BK, heads = gridDim.x / n_kt;
  const int t = (int)blockIdx.x / heads, bh = (int)blockIdx.x % heads;
  const int hk = bh % Hkv, b = bh / Hkv, rep = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t4 = lane % 4;
  const int k0 = t * BK, off = Sk - Sq, n_qt = (Sq + BQ - 1) / BQ, total = rep * n_qt;
  const size_t kvb = ((size_t)b * Hkv + hk) * Sk * DH;
  const int kp0 = k0 + warp * 16 + g, kp1 = kp0 + 8;   // this lane's two keys

  // item i's q and dO rows, lse and delta into stage buf
  const auto load_item = [&](int i, int buf) {
    const size_t bhq = (size_t)b * Hq + hk * rep + i / n_qt;
    const int q0 = (i % n_qt) * BQ, r = tid % BQ;
    load_tile<DH, LD>(qs + buf * BQ * LD, q + bhq * Sq * DH, q0, Sq);
    load_tile<DH, LD>(dos + buf * BQ * LD, dout + bhq * Sq * DH, q0, Sq);
    const bool in = q0 + r < Sq;
    cp_async4((tid < BQ ? lse_s : delta_s) + buf * BQ + r,
              (tid < BQ ? lse : delta) + bhq * Sq + (in ? q0 + r : 0), in);
  };

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  unsigned kf[KSL][4], vf[KSL][4];   // KV_REGS only
  int cur = next_item(-1, total, n_qt, t, Sq, Sk, causal, window);
  if (cur < total) {
    load_tile<DH, LD>(ks, k + kvb, k0, Sk);
    load_tile<DH, LD>(vs, v + kvb, k0, Sk);
    load_item(cur, 0);
    cp_async_commit();
  }
  for (int buf = 0, first = 1; cur < total; buf ^= 1, first = 0) {
    const int nxt = next_item(cur, total, n_qt, t, Sq, Sk, causal, window);
    if (nxt < total) {
      load_item(nxt, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (KV_REGS) {
      if (first) {
#pragma unroll
        for (int kk = 0; kk < KSL; ++kk) {
          frag_a(ks, LD, warp * 16, kk * 16, kf[kk]);
          frag_a(vs, LD, warp * 16, kk * 16, vf[kk]);
        }
      }
    }
    const int q0 = (cur % n_qt) * BQ, qlo = q0 + off, qhi = q0 + BQ - 1 + off;
    const bf16* qt = qs + buf * BQ * LD;
    const bf16* dot = dos + buf * BQ * LD;
    const float* lt = lse_s + buf * BQ;
    const float* dlt = delta_s + buf * BQ;
    const bool edge = k0 + BK > Sk || q0 + BQ > Sq || (causal && k0 + BK - 1 > qlo) ||
                      (window > 0 && k0 <= qhi - window);
#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += QH) {   // the pass's q rows [c0, c0 + QH) of the tile
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys x QH q rows a warp
      float s[QH / 8][4], dp[QH / 8][4];
#pragma unroll
      for (int n = 0; n < QH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSL; ++kk) {
        unsigned ka[4], va[4];
        if constexpr (KV_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kk][e];
            va[e] = vf[kk][e];
          }
        } else {
          frag_a(ks, LD, warp * 16, kk * 16, ka);
          frag_a(vs, LD, warp * 16, kk * 16, va);
        }
#pragma unroll
        for (int np = 0; np < QH / 16; ++np) {
          unsigned qb[4], ob[4];
          frag_b2(qt, LD, c0 + np * 16, kk * 16, qb);
          frag_b2(dot, LD, c0 + np * 16, kk * 16, ob);
          mma_bf16(s[2 * np], ka, qb[0], qb[1]);
          mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * np], va, ob[0], ob[1]);
          mma_bf16(dp[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      // Pᵀ and dSᵀ in base 2, rounded to bf16 as A fragments
      unsigned pa[QH / 16][4], da[QH / 16][4];
#pragma unroll
      for (int n = 0; n < QH / 8; ++n) {
        const int ci = c0 + n * 8 + 2 * t4;   // this lane's two q rows of the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lt + ci);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + ci);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse2 = ((e & 1) ? l2.y : l2.x) * LOG2E;
          p[e] = exp2f(fmaf(s[n][e], scale_log2, -lse2));
          ds[e] = p[e] * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
          if (edge) {
            const int kpos = e < 2 ? kp0 : kp1, qi = q0 + ci + (e & 1), qpos = qi + off;
            bool ok = kpos < Sk && qi < Sq;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) {   // a row with no valid key weighs its Sk keys alike
              p[e] = causal && qpos < 0 && kpos < Sk && qi < Sq ? exp2f(-lse2) : 0.f;
              ds[e] = 0.f;
            }
          }
        }
        pa[n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        da[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
        da[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dV += Pᵀ·dO and dK += dSᵀ·Q over the pass's q rows
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk)
#pragma unroll
        for (int dd = 0; dd < DH / 16; ++dd) {
          unsigned ob[4], qb[4];
          frag_b2_t(dot, LD, c0 + kk * 16, dd * 16, ob);
          frag_b2_t(qt, LD, c0 + kk * 16, dd * 16, qb);
          mma_bf16(dva[2 * dd], pa[kk], ob[0], ob[1]);
          mma_bf16(dva[2 * dd + 1], pa[kk], ob[2], ob[3]);
          mma_bf16(dka[2 * dd], da[kk], qb[0], qb[1]);
          mma_bf16(dka[2 * dd + 1], da[kk], qb[2], qb[3]);
        }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
    cur = nxt;
  }

  // dk = scale dSᵀ·Q and dv, staged in this warp's own rows of ks and vs
  // (no other warp reads them), then 16-byte stores
  bf16* sk = ks + warp * 16 * LD;
  bf16* sv = vs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(sk + g * LD + c) =
        __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(sk + (g + 8) * LD + c) =
        __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
    *reinterpret_cast<__nv_bfloat162*>(sv + g * LD + c) =
        __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(sv + (g + 8) * LD + c) =
        __floats2bfloat162_rn(dva[n][2], dva[n][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * (DH / 8); i += 32) {
    const int r = i / (DH / 8), c = (i - r * (DH / 8)) * 8, row = k0 + warp * 16 + r;
    if (row < Sk) {
      *reinterpret_cast<uint4*>(dk + kvb + (size_t)row * DH + c) =
          *reinterpret_cast<const uint4*>(sk + r * LD + c);
      *reinterpret_cast<uint4*>(dv + kvb + (size_t)row * DH + c) =
          *reinterpret_cast<const uint4*>(sv + r * LD + c);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS) flash_attention_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk,
    int causal, int window, float scale, float scale_log2) {
  constexpr int LD = DH + 8, KSL = DH / 16, NT = DH / 8;
  constexpr int KH = DH == 64 ? BK : BK / 2;    // keys a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD], at the end dq's staging
  bf16* dos = qs + BQ * LD;                       // [BQ][LD]
  bf16* ks = dos + BQ * LD;                       // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                    // [2][BK][LD]

  const int n_qt = (Sq + BQ - 1) / BQ, heads = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / heads, bh = (int)blockIdx.x % heads;
  const int hq = bh % Hq, b = bh / Hq, hk = hq / (Hq / Hkv);
  const int q0 = qt * BQ, off = Sk - Sq;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t4 = lane % 4;
  const size_t bhq = (size_t)b * Hq + hq;
  const bf16* kb = k + ((size_t)b * Hkv + hk) * Sk * DH;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * Sk * DH;

  int t_begin, t_end;
  tile_range(q0, Sq, Sk, causal, window, t_begin, t_end);
  load_tile<DH, LD>(qs, q + bhq * Sq * DH, q0, Sq);
  load_tile<DH, LD>(dos, dout + bhq * Sq * DH, q0, Sq);
  cp_async_commit();
  if (t_begin < t_end) {
    load_tile<DH, LD>(ks, kb, t_begin * BK, Sk);
    load_tile<DH, LD>(vs, vb, t_begin * BK, Sk);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 q and dO rows as A fragments; its lanes' rows' lse and delta
  unsigned qf[KSL][4], of[KSL][4];
#pragma unroll
  for (int kk = 0; kk < KSL; ++kk) {
    frag_a(qs, LD, warp * 16, kk * 16, qf[kk]);
    frag_a(dos, LD, warp * 16, kk * 16, of[kk]);
  }
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float lse0 = r0 < Sq ? lse[bhq * Sq + r0] * LOG2E : 0.f;
  const float lse1 = r1 < Sq ? lse[bhq * Sq + r1] * LOG2E : 0.f;
  const float de0 = r0 < Sq ? delta[bhq * Sq + r0] : 0.f;
  const float de1 = r1 < Sq ? delta[bhq * Sq + r1] : 0.f;
  const int qp0 = r0 + off, qp1 = r1 + off;
  const int qlo = q0 + off, qhi = q0 + BQ - 1 + off;   // over the whole q tile
  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

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
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qlo) ||
                      (window > 0 && k0 <= qhi - window);
#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += KH) {   // the pass's keys [c0, c0 + KH) of the tile
      float s[KH / 8][4], dp[KH / 8][4];
#pragma unroll
      for (int n = 0; n < KH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSL; ++kk)
#pragma unroll
        for (int np = 0; np < KH / 16; ++np) {
          unsigned kb2[4], vb2[4];
          frag_b2(kt, LD, c0 + np * 16, kk * 16, kb2);
          frag_b2(vt, LD, c0 + np * 16, kk * 16, vb2);
          mma_bf16(s[2 * np], qf[kk], kb2[0], kb2[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kb2[2], kb2[3]);
          mma_bf16(dp[2 * np], of[kk], vb2[0], vb2[1]);
          mma_bf16(dp[2 * np + 1], of[kk], vb2[2], vb2[3]);
        }
      // dS in base 2, rounded to bf16 as A fragments
      unsigned da[KH / 16][4];
#pragma unroll
      for (int n = 0; n < KH / 8; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const float p = exp2f(fmaf(s[n][e], scale_log2, -(lo ? lse0 : lse1)));
          ds[e] = p * (dp[n][e] - (lo ? de0 : de1));
          if (edge) {
            const int kpos = k0 + c0 + n * 8 + 2 * t4 + (e & 1), qpos = lo ? qp0 : qp1;
            bool ok = kpos < Sk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) ds[e] = 0.f;
          }
        }
        da[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
        da[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dQ += dS·K, K by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < KH / 16; ++kk)
#pragma unroll
        for (int dd = 0; dd < DH / 16; ++dd) {
          unsigned kb2[4];
          frag_b2_t(kt, LD, c0 + kk * 16, dd * 16, kb2);
          mma_bf16(dqa[2 * dd], da[kk], kb2[0], kb2[1]);
          mma_bf16(dqa[2 * dd + 1], da[kk], kb2[2], kb2[3]);
        }
    }
    __syncthreads();   // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

  // dq = scale dS·K, staged in this warp's own rows of qs, then 16-byte stores
  bf16* st = qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(st + g * LD + c) =
        __floats2bfloat162_rn(dqa[n][0] * scale, dqa[n][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(st + (g + 8) * LD + c) =
        __floats2bfloat162_rn(dqa[n][2] * scale, dqa[n][3] * scale);
  }
  __syncwarp();
  bf16* qb = dq + bhq * Sq * DH;
  for (int i = lane; i < 16 * (DH / 8); i += 32) {
    const int r = i / (DH / 8), c = (i - r * (DH / 8)) * 8, row = q0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(qb + (size_t)row * DH + c) =
          *reinterpret_cast<const uint4*>(st + r * LD + c);
  }
}

// Shared memory of the two bf16 backward blocks: six [64][Dh + 8] bf16
// tiles each (dk/dv: K, V and two stages of q and dO; dq: q, dO and two
// stages of K and V), and dk/dv's two stages of lse and delta.
template <int DH>
constexpr size_t bwd_bf16_smem(bool dkdv) {
  return sizeof(bf16) * 6 * (size_t)BK * (DH + 8) + (dkdv ? sizeof(float) * 4 * BQ : 0);
}

template <int DH>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                    const void* dout, const float* lse, float* delta, void* dq, void* dk,
                    void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                    float scale, void* stream) {
  const long long kv_blocks = (long long)((Sk + BK - 1) / BK) * Hkv * B;
  const long long q_blocks = (long long)((Sq + BQ - 1) / BQ) * Hq * B;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_bf16_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bwd_bf16_smem<DH>(true));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_bf16_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bwd_bf16_smem<DH>(false));
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * Hq * Sq;
  flash_attention_bwd_delta_kernel<bf16, DH><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const bf16*)out, (const bf16*)dout, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dkdv_bf16_kernel<DH>
      <<<(unsigned)kv_blocks, MMA_THREADS, bwd_bf16_smem<DH>(true), st>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta,
          (bf16*)dk, (bf16*)dv, Hq, Hkv, Sq, Sk, causal, window, scale, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dq_bf16_kernel<DH>
      <<<(unsigned)q_blocks, MMA_THREADS, bwd_bf16_smem<DH>(false), st>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta,
          (bf16*)dq, Hq, Hkv, Sq, Sk, causal, window, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_dh(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const float* lse, float* delta, void* dq, void* dk,
                  void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int Dh, int causal,
                  int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || Hkv > 65535 ||
      Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (Dh == 64)
    return launch_bwd<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk,
                             causal, window, scale, stream);
  if (Dh == 128)
    return launch_bwd<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk,
                              causal, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int Dh,
                                   int causal, int window, float scale, void* stream) {
  return launch<float>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, Dh, causal, window, scale,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int Dh,
                                    int causal, int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, Dh, causal, window,
                               scale, stream);
}

extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const float* lse,
                                       float* delta, void* dq, void* dk, void* dv, int B,
                                       int Hq, int Hkv, int Sq, int Sk, int Dh, int causal,
                                       int window, float scale, void* stream) {
  return launch_bwd_dh<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk,
                              Dh, causal, window, scale, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const float* lse,
                                        float* delta, void* dq, void* dk, void* dv, int B,
                                        int Hq, int Hkv, int Sq, int Sk, int Dh, int causal,
                                        int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (Dh == 64)
    return launch_bwd_bf16<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk,
                               causal, window, scale, stream);
  if (Dh == 128)
    return launch_bwd_bf16<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk,
                                causal, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}
