// Mamba2 SSD scan (state-space duality), per head h:
//
//     S_t = exp(dt_t a_h) S_{t-1} + dt_t (b_t ⊗ x_t),    y_t = S_t^T c_t + d_h x_t
//
// evaluated chunk by chunk: within a chunk of Q=64 steps a causal
// decay-weighted "attention" W·x with W = (C·Bᵀ) ∘ exp(cum_i - cum_j) ∘
// causal · dt_j, across chunks an [N, P] f32 state carried in order, plus
// the state's contribution exp(cum_i) (c_i · S).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas
// (body _ssd_kernel).  The TPU runs the chunk axis of its grid in order and
// carries the state in VMEM from one grid step to the next; on Hopper
// nothing carries over between blocks, so a block loops over the chunks
// itself and keeps the state.  A ragged last chunk gets dt=0 and x=b=c=0
// in its padded rows, which makes them exact no-ops, so any S works.  The
// same clip(., -60, 0) guards every exponent as in _ssd_kernel.  d_skip·x is
// fused into the epilogue (one rounding to the output type instead of the
// reference's two).
//
// Bound on the H100: at the zamba2-1.2b prefill shape (B=4 S=512 H=64 P=64
// N=64, bf16) the function moves ~35 MB (a ~10 µs bound) and, in chunks of
// 64, does ~4.3 GFLOP: ~4 µs at the bf16 tensor-core peak, ~64 µs as f32
// FMA on CUDA cores.  So once the products run on the tensor cores, bytes
// and the latency of the chunk chain bound it, not operations.
//
// bf16 (the serving path), on the tensor cores.  The four products (C·Bᵀ,
// W·x, C·S, Bᵀ·x) are mma.sync.m16n8k16 bf16 products with f32
// accumulators.  Values are rounded to bf16 in three places, and only
// there (kernels/ref.py::ssd_scan_mma_ref models the same roundings):
//   - W, computed in f32 from the exact f32 C·Bᵀ of the bf16 inputs, is
//     rounded to feed W·x;
//   - the state S, carried across chunks in f32 registers, is rounded to a
//     bf16 copy in shared memory to feed C·S;
//   - b_j exp(total - cum_j) dt_j, the operand of the state update, is
//     rounded after the scaling.
// The exponents are taken in base 2 (ex2.approx).  A column p of y depends
// only on column p of x and of S, so a block owns 64 columns of one
// (batch, head): a grid of (P/64, H, B), 256 blocks at the serving shape,
// two per SM (~91 KB of shared memory each), so the grid is one wave.  Its
// 8 warps are 2 halves of the 64 columns x 4 row tiles of the chunk: a warp
// computes C·S, W·x and y for chunk rows [16 w, 16 w + 16) and its 32
// columns, and holds state rows [w N/4, (w+1) N/4) of its columns as mma
// accumulators.  The causal mask gives row tile w w + 1 column tiles of W:
// the two warps of a row tile split them by parity and swap the rounded
// fragments through shared memory (a 64-thread named barrier); the second
// half takes the row tiles in reverse, so each scheduler gets a heavy and
// a light warp; and the light warps do the rest: the four of row tiles 0
// and 1 issue the loads, and the first one takes each chunk's prefix sums
// of dt·a once, for all.  x, b, c (bf16) and dt of chunk k+1 are fetched by
// 16-byte (dt: 4-byte) cp.async into the second of two stages while chunk
// k computes; rows are padded by 16 bytes, so ldmatrix reads are free of
// bank conflicts.  The state's bf16 copy is double-buffered, so one
// barrier per chunk suffices.  y is staged per warp and written with
// 16-byte stores.  What bounds it now is the chunk chain (8 chunks in a
// row per block, each ~6,000 cycles with 16 warps per SM), fed by the
// shared-memory traffic of the fragment loads (each warp loads its own
// copy of x, S and b), not bytes or tensor-core operations
// (ssd_scan_probe.py; PERF.md).  Takes N in {64, 128} and P a
// multiple of 8.
//
// f32 (the zoo's f32 agreement run on the card) keeps CUDA-core f32 FMA:
// tensor cores would round the products to TF32 (~3 digits).  One block
// owns one (batch, head) and loops over the chunks, keeping the state in
// shared memory; each chunk's x, b, c and dt are staged in shared memory.
// 256 threads as a 16x16 grid, each computing a 4x4 register tile of every
// [64 x 64] product, so one shared-memory load feeds four FMAs; rows are
// padded to an odd stride so the 16 columns a warp reads fall in distinct
// banks.  Rows of x, b and c are read with 16-byte loads where P and N are
// multiples of 4, with scalar loads otherwise, so any N and P work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int Q = 64;          // chunk length
using bf16 = __nv_bfloat16;

// ------------------------------------------------------ f32, CUDA cores
constexpr int F32_THREADS = 256;   // a 16 x 16 thread grid

__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, -60.f), 0.f));
}

template <bool VEC>
__global__ void __launch_bounds__(F32_THREADS) ssd_scan_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ d_skip,
    float* __restrict__ y, int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ldn = N + 1, ldq = Q + 1;
  float* st = smem;               // [N][P]   carried state
  float* xs = st + N * P;         // [Q][P]   x of the chunk
  float* bs = xs + Q * P;         // [Q][ldn] b
  float* cs = bs + Q * ldn;       // [Q][ldn] c
  float* w = cs + Q * ldn;        // [Q][ldq] intra-chunk weights, dt folded in
  float* dts = w + Q * ldq;       // [Q]      dt
  float* cum = dts + Q;           // [Q]      inclusive cumsum of dt*a
  float* wst = cum + Q;           // [Q]      exp(total - cum_j) * dt_j

  const float ah = a[h];
  const float dh = d_skip != nullptr ? d_skip[h] : 0.f;
  for (int i = tid; i < N * P; i += F32_THREADS) st[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk's readers are done
    if (VEC) {   // 16-byte loads: rows of x, b and c in fours
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = tid; i < Q * P / 4; i += F32_THREADS) {
        const int r = i / (P / 4), c = (i - r * (P / 4)) * 4, t = s0 + r;
        *reinterpret_cast<float4*>(xs + r * P + c) =
            t < S ? *reinterpret_cast<const float4*>(x + (((size_t)b * S + t) * H + h) * P + c)
                  : zero;
      }
      for (int i = tid; i < Q * N / 4; i += F32_THREADS) {
        const int r = i / (N / 4), n = (i - r * (N / 4)) * 4, t = s0 + r;
        const size_t off = ((size_t)b * S + t) * N + n;
        const float4 bv = t < S ? *reinterpret_cast<const float4*>(bm + off) : zero;
        const float4 cv = t < S ? *reinterpret_cast<const float4*>(cm + off) : zero;
        float* bd = bs + r * ldn + n;   // rows of an odd stride: four stores
        float* cd = cs + r * ldn + n;
        bd[0] = bv.x;
        bd[1] = bv.y;
        bd[2] = bv.z;
        bd[3] = bv.w;
        cd[0] = cv.x;
        cd[1] = cv.y;
        cd[2] = cv.z;
        cd[3] = cv.w;
      }
    } else {
      for (int i = tid; i < Q * P; i += F32_THREADS) {
        const int r = i / P, p = i - r * P, t = s0 + r;
        xs[i] = t < S ? x[(((size_t)b * S + t) * H + h) * P + p] : 0.f;
      }
      for (int i = tid; i < Q * N; i += F32_THREADS) {
        const int r = i / N, n = i - r * N, t = s0 + r;
        const size_t off = ((size_t)b * S + t) * N + n;
        bs[r * ldn + n] = t < S ? bm[off] : 0.f;
        cs[r * ldn + n] = t < S ? cm[off] : 0.f;
      }
    }
    if (tid < Q) {
      const int t = s0 + tid;
      dts[tid] = t < S ? dt[((size_t)b * S + t) * H + h] : 0.f;
    }
    __syncthreads();
    if (tid < 32) {  // inclusive prefix sum of dt*a: two steps per lane
      const float v0 = dts[2 * tid] * ah, v1 = dts[2 * tid + 1] * ah;
      float run = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += o;
      }
      const float before = run - (v0 + v1);
      cum[2 * tid] = before + v0;
      cum[2 * tid + 1] = run;
    }
    __syncthreads();
    const float total = cum[Q - 1];
    if (tid < Q) wst[tid] = clip_exp(total - cum[tid]) * dts[tid];

    // W[i][j] = (c_i · b_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * ldn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bs[(tx + 16 * c) * ldn + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          w[i * ldq + j] = j <= i ? acc[r][c] * clip_exp(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y_i = W_i · x + exp(cum_i) (c_i · S) + d x_i, in column tiles of 64
    for (int p0 = 0; p0 < P; p0 += 64) {
      float acc[4][4] = {}, acs[4][4] = {};
      int pc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) pc[c] = min(p0 + tx + 16 * c, P - 1);
      for (int j = 0; j < Q; ++j) {
        float wv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = w[(ty + 16 * r) * ldq + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = xs[j * P + pc[c]];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * ldn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = st[n * P + pc[c]];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acs[r][c] = fmaf(cv[r], sv[c], acs[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r, t = s0 + i;
        if (t >= S) continue;
        const float dec = clip_exp(cum[i]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = p0 + tx + 16 * c;
          if (p >= P) continue;
          y[(((size_t)b * S + t) * H + h) * P + p] =
              acc[r][c] + dec * acs[r][c] + dh * xs[i * P + p];
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S = S exp(total) + Σ_j (b_j exp(total - cum_j) dt_j) ⊗ x_j
    const float dtot = clip_exp(total);
    for (int n0 = 0; n0 < N; n0 += 64) {
      for (int p0 = 0; p0 < P; p0 += 64) {
        float acc[4][4] = {};
        int nr[4], pc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) nr[r] = min(n0 + ty + 16 * r, N - 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) pc[c] = min(p0 + tx + 16 * c, P - 1);
        for (int j = 0; j < Q; ++j) {
          const float wj = wst[j];
          float bv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) bv[r] = bs[j * ldn + nr[r]] * wj;
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = xs[j * P + pc[c]];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(bv[r], xv[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = n0 + ty + 16 * r;
          if (n >= N) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = p0 + tx + 16 * c;
            if (p >= P) continue;
            st[n * P + p] = fmaf(st[n * P + p], dtot, acc[r][c]);
          }
        }
      }
    }
  }
}

int launch_f32(const void* x, const void* dt, const void* a, const void* b, const void* c,
               const void* d_skip, void* y, int B, int S, int H, int P, int N, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)N * P + (size_t)Q * P + 2 * (size_t)Q * (N + 1) +
                                       (size_t)Q * (Q + 1) + 3 * Q);
  // 16-byte loads where every row of x, b and c starts on a 16-byte boundary
  const bool vec = P % 4 == 0 && N % 4 == 0 &&
                   ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(b) |
                     reinterpret_cast<size_t>(c)) & 15) == 0;
  const auto kernel = vec ? ssd_scan_f32_kernel<true> : ssd_scan_f32_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, B), F32_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)b, (const float*)c,
      (const float*)d_skip, (float*)y, S, H, P, N);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16, tensor cores
constexpr int THREADS = 256;       // 8 warps: 2 halves of P x 4 row tiles of the chunk
constexpr int PT = 64;             // columns of P per block
constexpr int LDX = PT + 8;        // smem row stride of x and the state copy: 16 bytes of pad
constexpr float LOG2E = 1.4426950408889634f;
constexpr float CLIP2 = -60.f * LOG2E;   // clip(., -60, 0) of an exponent, in base 2

// 2^v for v in [CLIP2, 0]: never below 2^-87, so flushing denormals loses nothing
__device__ __forceinline__ float clip_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(fminf(fmaxf(v, CLIP2), 0.f)));
  return r;
}
// a bf16 pair times (s0, s1), rounded back to bf16
__device__ __forceinline__ unsigned scale_bf16x2(unsigned v, float s0, float s1) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * s0, f.y * s1);
}

// Shared memory: two stages, each c [Q][N + 8] and b [Q][N + 8], x
// [Q][LDX] (bf16), dt [Q] and its prefix sums cum [Q] and the state
// update's scales wst [Q] (f32); two bf16 copies of the state [N][LDX]
// (the one before this chunk, and the one this chunk writes for the next);
// W's A fragments [row tile][column tile][lane] (uint4); and per warp a
// [16][LDY] tile that stages its part of y.
constexpr int LDY = 32 + 8;
template <int N>
struct Layout {
  static constexpr int LDN = N + 8;
  static constexpr size_t C = 0, B = C + sizeof(bf16) * Q * LDN, X = B + sizeof(bf16) * Q * LDN,
                          DT = X + sizeof(bf16) * Q * LDX, CUM = DT + sizeof(float) * Q,
                          WST = CUM + sizeof(float) * Q, STAGE = WST + sizeof(float) * Q,
                          SS = 2 * STAGE, WB = SS + sizeof(bf16) * 2 * N * LDX,
                          STG = WB + sizeof(uint4) * 4 * 4 * 32,
                          BYTES = STG + sizeof(bf16) * (THREADS / 32) * 16 * LDY;
};

// Chunk s0 into a stage by 16-byte (dt: 4-byte) cp.async, issued by the
// LOADERS threads of the warps with the lightest chunk (row tiles 0 and
// 1), thread li of them; dt by the first warp, which takes its prefix sums
// (chunk_scan).  Rows past S and columns past P are zero-filled, so they
// are exact no-ops.
constexpr int LOADERS = 128;
template <int N>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const bf16* __restrict__ x,
                                           const float* __restrict__ dt,
                                           const bf16* __restrict__ bm,
                                           const bf16* __restrict__ cm, int li, int b, int h,
                                           int p0, int s0, int S, int H, int P) {
  using L = Layout<N>;
  constexpr int CPR = N / 8, XPR = PT / 8;   // 16-byte pieces per row
  bf16* cs = reinterpret_cast<bf16*>(stage + L::C);
  bf16* bs = reinterpret_cast<bf16*>(stage + L::B);
  bf16* xs = reinterpret_cast<bf16*>(stage + L::X);
  float* dts = reinterpret_cast<float*>(stage + L::DT);
  for (int i = li; i < Q * CPR; i += LOADERS) {
    const int r = i / CPR, col = (i - r * CPR) * 8, t = s0 + r;
    const bool in = t < S;
    const size_t off = ((size_t)b * S + (in ? t : 0)) * N + col;
    cp_async16(cs + r * L::LDN + col, cm + off, in);
    cp_async16(bs + r * L::LDN + col, bm + off, in);
  }
  for (int i = li; i < Q * XPR; i += LOADERS) {
    const int r = i / XPR, col = (i - r * XPR) * 8, t = s0 + r, p = p0 + col;
    const bool in = t < S && p < P;
    cp_async16(xs + r * LDX + col, x + (((size_t)b * S + (in ? t : 0)) * H + h) * P + (in ? p : 0),
               in);
  }
  if (li < 32) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * li + e, t = s0 + r;
      const bool in = t < S;
      cp_async4(dts + r, dt + ((size_t)b * S + (in ? t : 0)) * H + h, in);
    }
  }
  cp_async_commit();
}

// The chunk's inclusive prefix sums of dt·a (base 2) and the state
// update's scales exp(total - cum_j) dt_j, by one warp, two steps a lane,
// once dt is in the stage.
template <int N>
__device__ __forceinline__ void chunk_scan(unsigned char* stage, float ah2, int lane) {
  using L = Layout<N>;
  const float2 dtp = *reinterpret_cast<const float2*>(stage + L::DT + 8 * lane);
  const float v0 = dtp.x * ah2, v1 = dtp.y * ah2;
  float run = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += o;
  }
  const float cum0 = run - (v0 + v1) + v0, cum1 = run;
  const float total = __shfl_sync(0xffffffffu, cum1, 31);
  *reinterpret_cast<float2*>(stage + L::CUM + 8 * lane) = make_float2(cum0, cum1);
  *reinterpret_cast<float2*>(stage + L::WST + 8 * lane) =
      make_float2(clip_exp2(total - cum0) * dtp.x, clip_exp2(total - cum1) * dtp.y);
}

// One block: batch b, head h, columns [PT x, PT x + PT).  A warp: columns
// 32 half + [0, 32) of the block's, chunk rows [16 w, 16 w + 16) and state
// rows [w N/4, (w+1) N/4).
template <int N>
__global__ void __launch_bounds__(THREADS, N == 64 ? 2 : 1) ssd_scan_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const bf16* __restrict__ bm, const bf16* __restrict__ cm, const float* __restrict__ d_skip,
    bf16* __restrict__ y, int S, int H, int P) {
  using L = Layout<N>;
  constexpr int LDN = L::LDN;
  constexpr int KN = N / 16;      // 16-deep slices of N
  constexpr int MT = N / 64;      // 16-row tiles of the state per warp
  constexpr int NP = 4;           // 8-wide column tiles of a warp's 32 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the four warps of each half take the four row tiles, the second half's
  // in reverse, so that the two warps on a scheduler (warp % 4) hold row
  // tiles w and 3 - w: the causal mask gives row tile w w + 1 column tiles
  const int half = warp / 4, w = half ? 3 - warp % 4 : warp % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = w * 16;              // this warp's chunk rows
  const int nrow0 = w * (N / 4);        // this warp's state rows
  const int pc = half * 32;             // this warp's columns within the block's
  bf16* ss = reinterpret_cast<bf16*>(smem_raw + L::SS);
  uint4* wb = reinterpret_cast<uint4*>(smem_raw + L::WB) + w * 4 * 32;
  bf16* stg = reinterpret_cast<bf16*>(smem_raw + L::STG) + warp * 16 * LDY;
  const float ah2 = a[h] * LOG2E;
  const float dh = d_skip != nullptr ? d_skip[h] : 0.f;

  float st[MT][NP][4];   // state rows nrow0 + 16 mt + (g, g + 8), columns pc + 8 n + 2 t4 (+1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NP; ++n) st[mt][n][0] = st[mt][n][1] = st[mt][n][2] = st[mt][n][3] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  const bool loader = w < 2;
  const int li = (w * 2 + half) * 32 + lane;
  const bool scanner = warp == 0;   // row tile 0: the lightest chunk
  if (loader) load_chunk<N>(smem_raw, x, dt, bm, cm, li, b, h, p0, 0, S, H, P);
  if (scanner) {
    cp_async_wait<0>();
    chunk_scan<N>(smem_raw, ah2, lane);
  }
  for (int kc = 0; kc < n_chunks; ++kc) {
    if (loader) cp_async_wait<0>();
    // chunk kc has landed, and every warp is done with chunk kc - 1: its
    // stage, and its reads of the state copy this chunk writes
    __syncthreads();
    if (loader && kc + 1 < n_chunks)
      load_chunk<N>(smem_raw + ((kc + 1) & 1) * L::STAGE, x, dt, bm, cm, li, b, h, p0,
                    (kc + 1) * Q, S, H, P);
    const unsigned char* stage = smem_raw + (kc & 1) * L::STAGE;
    const bf16* cs = reinterpret_cast<const bf16*>(stage + L::C);
    const bf16* bs = reinterpret_cast<const bf16*>(stage + L::B);
    const bf16* xs = reinterpret_cast<const bf16*>(stage + L::X) + pc;
    const float* dts = reinterpret_cast<const float*>(stage + L::DT);
    const float* cum = reinterpret_cast<const float*>(stage + L::CUM);
    const float* wst = reinterpret_cast<const float*>(stage + L::WST);
    const int s0 = kc * Q;
    const float total = cum[Q - 1];
    const float ci0 = cum[row0 + g], ci1 = cum[row0 + g + 8];   // this lane's rows

    // S = S exp(total) + (b ∘ exp(total - cum) dt)ᵀ · x, and its bf16 copy
    // for the next chunk's C·S
    if (kc + 1 < n_chunks) {
      const float dtot = clip_exp2(total);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NP; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mt][n][e] *= dtot;
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        // the scales at steps 16 kk + 2 t4 (+1) and 16 kk + 8 + 2 t4 (+1)
        const float2 wa = *reinterpret_cast<const float2*>(wst + 16 * kk + 2 * t4);
        const float2 wb = *reinterpret_cast<const float2*>(wst + 16 * kk + 8 + 2 * t4);
        unsigned xf[NP / 2][4];
#pragma unroll
        for (int np = 0; np < NP / 2; ++np)
          ldsm_x4_trans(xs + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) * LDX + np * 16 +
                            lane / 16 * 8,
                        xf[np]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned af[4];   // Bᵀ rows nrow0 + 16 mt .., steps 16 kk ..
          ldsm_x4_trans(bs + (kk * 16 + lane / 16 * 8 + lane % 8) * LDN + nrow0 + mt * 16 +
                            (lane / 8 % 2) * 8,
                        af);
          af[0] = scale_bf16x2(af[0], wa.x, wa.y);
          af[1] = scale_bf16x2(af[1], wa.x, wa.y);
          af[2] = scale_bf16x2(af[2], wb.x, wb.y);
          af[3] = scale_bf16x2(af[3], wb.x, wb.y);
#pragma unroll
          for (int np = 0; np < NP / 2; ++np) {
            mma_bf16(st[mt][2 * np], af, xf[np][0], xf[np][1]);
            mma_bf16(st[mt][2 * np + 1], af, xf[np][2], xf[np][3]);
          }
        }
      }
      bf16* next = ss + ((kc + 1) & 1) * N * LDX + pc;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          bf16* dst = next + (nrow0 + mt * 16 + g) * LDX + n * 8 + 2 * t4;
          *reinterpret_cast<unsigned*>(dst) = pack_bf16(st[mt][n][0], st[mt][n][1]);
          *reinterpret_cast<unsigned*>(dst + 8 * LDX) = pack_bf16(st[mt][n][2], st[mt][n][3]);
        }
    }

    // this warp's 16 rows of C as A fragments
    unsigned cf[KN][4];
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
      ldsm_x4(cs + (row0 + lane % 8 + (lane / 8 % 2) * 8) * LDN + kk * 16 + lane / 16 * 8, cf[kk]);

    // C·Bᵀ over the column tiles the causal mask keeps (np <= w), then W =
    // (C·Bᵀ) exp(cum_i - cum_j) dt_j for j <= i, rounded to bf16 as A
    // fragments (the m16n8 accumulator layout is the m16n8k16 A layout).
    // The two halves of the head's row tile split the column tiles by
    // parity and swap their fragments through shared memory.
    const auto w_tile = [&](int np) {
      float gacc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        unsigned bf[4];   // steps 16 np + 0-7 / 8-15, N slice halves 0-7 / 8-15
        ldsm_x4(bs + (np * 16 + lane % 8 + lane / 16 * 8) * LDN + kk * 16 + (lane / 8 % 2) * 8,
                bf);
        mma_bf16(gacc[0], cf[kk], bf[0], bf[1]);
        mma_bf16(gacc[1], cf[kk], bf[2], bf[3]);
      }
      unsigned f[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 16 * np + 8 * hf + 2 * t4, i0 = row0 + g, i1 = i0 + 8;
        const float2 cj = *reinterpret_cast<const float2*>(cum + j);
        const float2 dj = *reinterpret_cast<const float2*>(dts + j);
        const float* s = gacc[hf];
        const float w0 = j <= i0 ? s[0] * clip_exp2(ci0 - cj.x) * dj.x : 0.f;
        const float w1 = j + 1 <= i0 ? s[1] * clip_exp2(ci0 - cj.y) * dj.y : 0.f;
        const float w2 = j <= i1 ? s[2] * clip_exp2(ci1 - cj.x) * dj.x : 0.f;
        const float w3 = j + 1 <= i1 ? s[3] * clip_exp2(ci1 - cj.y) * dj.y : 0.f;
        f[2 * hf] = pack_bf16(w0, w1);
        f[2 * hf + 1] = pack_bf16(w2, w3);
      }
      wb[np * 32 + lane] = make_uint4(f[0], f[1], f[2], f[3]);
    };
    // this half's column tiles np <= w of its parity: 2, 1 or none, the
    // two written out in one straight line so that their chains overlap
    if (w >= half + 2) {
      w_tile(half);
      w_tile(half + 2);
    } else if (w >= half) {
      w_tile(half);
    }
    // the two warps of this row tile: named barrier 1 + w
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + w) : "memory");

    // W·x over the steps the causal mask keeps
    float yacc[NP][4];
#pragma unroll
    for (int n = 0; n < NP; ++n) yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (kk > w) break;
      const uint4 v = wb[kk * 32 + lane];
      const unsigned wf[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int np = 0; np < NP / 2; ++np) {
        unsigned xf[4];
        ldsm_x4_trans(xs + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) * LDX + np * 16 +
                          lane / 16 * 8,
                      xf);
        mma_bf16(yacc[2 * np], wf, xf[0], xf[1]);
        mma_bf16(yacc[2 * np + 1], wf, xf[2], xf[3]);
      }
    }

    // C·S with the state before this chunk
    float ycs[NP][4];
#pragma unroll
    for (int n = 0; n < NP; ++n) ycs[n][0] = ycs[n][1] = ycs[n][2] = ycs[n][3] = 0.f;
    if (kc > 0) {
      const bf16* cur = ss + (kc & 1) * N * LDX + pc;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
#pragma unroll
        for (int np = 0; np < NP / 2; ++np) {
          unsigned sf[4];
          ldsm_x4_trans(cur + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) * LDX + np * 16 +
                            lane / 16 * 8,
                        sf);
          mma_bf16(ycs[2 * np], cf[kk], sf[0], sf[1]);
          mma_bf16(ycs[2 * np + 1], cf[kk], sf[2], sf[3]);
        }
    }

    // y = W·x + exp(cum_i) C·S + d x, staged in this warp's tile
    const float e0 = clip_exp2(ci0), e1 = clip_exp2(ci1);
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const int c = n * 8 + 2 * t4;
      const float2 xa = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + (row0 + g) * LDX + c));
      const float2 xb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + (row0 + g + 8) * LDX + c));
      *reinterpret_cast<unsigned*>(stg + g * LDY + c) =
          pack_bf16(yacc[n][0] + e0 * ycs[n][0] + dh * xa.x,
                    yacc[n][1] + e0 * ycs[n][1] + dh * xa.y);
      *reinterpret_cast<unsigned*>(stg + (g + 8) * LDY + c) =
          pack_bf16(yacc[n][2] + e1 * ycs[n][2] + dh * xb.x,
                    yacc[n][3] + e1 * ycs[n][3] + dh * xb.y);
    }
    __syncwarp();
    for (int i = lane; i < 16 * NP; i += 32) {
      const int r = i / NP, c = (i - r * NP) * 8, t = s0 + row0 + r, p = p0 + pc + c;
      if (t < S && p < P)
        *reinterpret_cast<uint4*>(y + (((size_t)b * S + t) * H + h) * P + p) =
            *reinterpret_cast<const uint4*>(stg + r * LDY + c);
    }
    if (scanner && kc + 1 < n_chunks) {   // the next chunk's prefix sums
      cp_async_wait<0>();
      chunk_scan<N>(smem_raw + ((kc + 1) & 1) * L::STAGE, ah2, lane);
    }
  }
}

template <int N>
int launch_bf16(const void* x, const void* dt, const void* a, const void* b, const void* c,
                const void* d_skip, void* y, int B, int S, int H, int P, void* stream) {
  const size_t smem = Layout<N>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bf16_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_bf16_kernel<N><<<dim3((P + PT - 1) / PT, H, B), THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)a, (const bf16*)b, (const bf16*)c,
      (const float*)d_skip, (bf16*)y, S, H, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* d_skip,
                            void* y, int B, int S, int H, int P, int N,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  return launch_f32(x, dt, a, b, c, d_skip, y, B, S, H, P, N, stream);
}

// N in {64, 128} and P a multiple of 8 (the wrapper raises otherwise)
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a,
                             const void* b, const void* c, const void* d_skip,
                             void* y, int B, int S, int H, int P, int N,
                             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 8 != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (N == 64) return launch_bf16<64>(x, dt, a, b, c, d_skip, y, B, S, H, P, stream);
  if (N == 128) return launch_bf16<128>(x, dt, a, b, c, d_skip, y, B, S, H, P, stream);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ backward
//
// Gradients of the chunked scan with respect to x, dt, a, b, c and d_skip,
// in closed form (kernels/ref.py::ssd_scan_bwd_ref, its plain version).
// With cum the within-chunk prefix sum of dt·a, T its last entry,
// L_ij = exp(clip(cum_i - cum_j, -60, 0)) for j <= i, G = C·Bᵀ and
// w_j = exp(clip(T - cum_j)) dt_j, one chunk is
//
//     y_i = Σ_j G_ij L_ij dt_j x_j + exp(clip(cum_i)) c_i·H + D x_i,
//     H'  = exp(clip(T)) H + Σ_j w_j b_j ⊗ x_j,
//
// and every exp(clip(v)) passes a gradient only where v >= -60, as
// jax.grad of the reference's clip does.  There is no TPU kernel to
// replace: the reference differentiates its XLA path (ssd_chunked_ref under
// forward_train, use_pallas=False).
//
// Bound on the H100: at zamba2-1.2b's training shape (B=4 S=512 H=64 P=64
// N=64, bf16) the function reads x, dy, b, c, dt and writes their
// gradients (~52 MB, ~16 µs).
//
// f32 (the zoo's f32 agreement run on the card), the first design: every
// product is f32 FMA from shared memory (tensor cores would round to
// TF32).  One block per (head, sequence), 256 threads (8 warps):
//   1. forward over the chunks, carrying the [N, P] f32 state in shared
//      memory and writing the state before each chunk to scratch (the
//      forward kernel saves nothing);
//   2. the chunks in reverse, carrying the state's gradient R in shared
//      memory: per chunk G, dM = dY·Xᵀ and L (64 x 64, lower), then a warp
//      per row for its dx, db, dc, ddt and d(cum) (lanes over P, N or the
//      chunk, reduced by shuffles), then the prefix sum's reverse for dt and
//      a, then R <- exp(clip(T)) R + Σ_i exp(clip(cum_i)) c_i ⊗ dy_i.
// db and dc (b and c are shared by the heads) are written per head, da and
// dd per sequence, and a second kernel sums them over heads and sequences
// in order.  No atomics: two calls give the same bits.  Rows of shared
// memory are padded to an odd stride, so the lanes of a warp fall in
// distinct banks.  A ragged last chunk has no-op rows (dt = 0, x = b = c =
// dy = 0), whose gradients are not written.  Any N and P whose buffers fit
// a block's 227 KB (kernels/ssd_scan.py::bwd_smem_bytes).  bf16 (zamba2's
// training) is chunk-parallel on the tensor cores, below.

namespace {

constexpr int BWD_THREADS = 256;

template <typename T>
__device__ __forceinline__ float ld_f32(const T* p);
template <>
__device__ __forceinline__ float ld_f32<float>(const float* p) { return *p; }
template <typename T>
__device__ __forceinline__ T st_val(float v);
template <>
__device__ __forceinline__ float st_val<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 st_val<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the block's sum of one value a thread, in a fixed order (warps, then in
// warp order by thread 0); every thread gets it
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < BWD_THREADS / 32; ++w) s += red[w];
  return s;
}

// rows [t0, t0 + Q) of a [.., W] slice (row stride `stride`) into smem rows
// of stride W + 1; rows at or past S are zero
template <typename T>
__device__ __forceinline__ void stage_chunk(float* dst, const T* src, size_t stride, int W,
                                            int t0, int S) {
  for (int i = threadIdx.x; i < Q * W; i += BWD_THREADS) {
    const int r = i / W, c = i - r * W;
    dst[r * (W + 1) + c] = t0 + r < S ? ld_f32(src + (size_t)(t0 + r) * stride + c) : 0.f;
  }
}

// the chunk's prefix sums of dt·a (one thread, in order)
__device__ __forceinline__ void prefix_cum(const float* dt_s, float* cum_s, float ah) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int j = 0; j < Q; ++j) {
      acc += dt_s[j] * ah;
      cum_s[j] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS) ssd_scan_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ b, const T* __restrict__ c, const float* __restrict__ d_skip,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ states, float* __restrict__ db_part, float* __restrict__ dc_part,
    float* __restrict__ sums, int B, int S, int H, int P, int N) {
  const int h = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int LP = P + 1, LN = N + 1, LQ = Q + 1, nc = (S + Q - 1) / Q;
  extern __shared__ float sm[];
  float* xs = sm;                 // [Q][LP]
  float* dys = xs + Q * LP;       // [Q][LP]
  float* bs = dys + Q * LP;       // [Q][LN]
  float* cs = bs + Q * LN;        // [Q][LN]
  float* hs = cs + Q * LN;        // [N][LP] the state before the chunk
  float* rs = hs + N * LP;        // [N][LP] the gradient of the state after it
  float* gs = rs + N * LP;        // [Q][LQ] C·Bᵀ, lower
  float* dms = gs + Q * LQ;       // [Q][LQ] dY·Xᵀ (over P), lower
  float* ls = dms + Q * LQ;       // [Q][LQ] L, lower
  float* dt_s = ls + Q * LQ;      // [Q]
  float* cum_s = dt_s + Q;        // [Q]
  float* w_s = cum_s + Q;         // [Q] w_j = exp(clip(T - cum_j)) dt_j
  float* e_s = w_s + Q;           // [Q] exp(clip(cum_i))
  float* dcum_s = e_s + Q;        // [Q] the gradient of cum
  float* ddt_s = dcum_s + Q;      // [Q] the gradient of dt
  float* dgap_s = ddt_s + Q;      // [Q] the gradient of T - cum_j through w_j
  float* red = dgap_s + Q;        // [Q] block sums

  const float ah = a[h], dh = d_skip ? d_skip[h] : 0.f;
  const size_t xrow = (size_t)H * P;                       // a step of x, dy, dx
  const T* xb = x + (size_t)bb * S * xrow + (size_t)h * P;
  const T* dyb = dy + (size_t)bb * S * xrow + (size_t)h * P;
  T* dxb = dx + (size_t)bb * S * xrow + (size_t)h * P;
  const T* bb_ = b + (size_t)bb * S * N;
  const T* cb = c + (size_t)bb * S * N;
  const float* dtb = dt + (size_t)bb * S * H + h;
  float* st = states + ((size_t)bb * H + h) * nc * N * P;
  float* dbp = db_part + ((size_t)bb * H + h) * S * N;
  float* dcp = dc_part + ((size_t)bb * H + h) * S * N;
  const int NP = N * P;

  // ---- 1. forward over the chunks: the state before each chunk, to scratch
  for (int e = tid; e < NP; e += BWD_THREADS) hs[(e / P) * LP + e % P] = 0.f;
  for (int k = 0; k < nc; ++k) {
    const int t0 = k * Q;
    __syncthreads();
    for (int e = tid; e < NP; e += BWD_THREADS) st[(size_t)k * NP + e] = hs[(e / P) * LP + e % P];
    stage_chunk(xs, xb, xrow, P, t0, S);
    stage_chunk(bs, bb_, N, N, t0, S);
    for (int j = tid; j < Q; j += BWD_THREADS) dt_s[j] = t0 + j < S ? dtb[(size_t)(t0 + j) * H] : 0.f;
    __syncthreads();
    prefix_cum(dt_s, cum_s, ah);
    __syncthreads();
    const float total = cum_s[Q - 1];
    for (int j = tid; j < Q; j += BWD_THREADS) w_s[j] = clip_exp(total - cum_s[j]) * dt_s[j];
    __syncthreads();
    const float et = clip_exp(total);
    for (int e = tid; e < NP; e += BWD_THREADS) {
      const int n = e / P, p = e - n * P;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc = fmaf(w_s[j] * bs[j * LN + n], xs[j * LP + p], acc);
      hs[n * LP + p] = hs[n * LP + p] * et + acc;
    }
  }

  // ---- 2. the chunks in reverse
  for (int e = tid; e < NP; e += BWD_THREADS) rs[(e / P) * LP + e % P] = 0.f;
  float da_acc = 0.f, dd_acc = 0.f;
  for (int k = nc - 1; k >= 0; --k) {
    const int t0 = k * Q;
    __syncthreads();
    stage_chunk(xs, xb, xrow, P, t0, S);
    stage_chunk(dys, dyb, xrow, P, t0, S);
    stage_chunk(bs, bb_, N, N, t0, S);
    stage_chunk(cs, cb, N, N, t0, S);
    for (int e = tid; e < NP; e += BWD_THREADS) hs[(e / P) * LP + e % P] = st[(size_t)k * NP + e];
    for (int j = tid; j < Q; j += BWD_THREADS) dt_s[j] = t0 + j < S ? dtb[(size_t)(t0 + j) * H] : 0.f;
    __syncthreads();
    prefix_cum(dt_s, cum_s, ah);
    __syncthreads();
    const float total = cum_s[Q - 1], et = clip_exp(total);
    for (int j = tid; j < Q; j += BWD_THREADS) {
      w_s[j] = clip_exp(total - cum_s[j]) * dt_s[j];
      e_s[j] = clip_exp(cum_s[j]);
    }
    // G = C·Bᵀ, dM = dY·Xᵀ and L on and below the diagonal
    for (int idx = tid; idx < Q * Q; idx += BWD_THREADS) {
      const int i = idx / Q, j = idx - i * Q;
      float g = 0.f, m = 0.f, l = 0.f;
      if (j <= i) {
        for (int n = 0; n < N; ++n) g = fmaf(cs[i * LN + n], bs[j * LN + n], g);
        for (int p = 0; p < P; ++p) m = fmaf(dys[i * LP + p], xs[j * LP + p], m);
        l = clip_exp(cum_s[i] - cum_s[j]);
      }
      gs[i * LQ + j] = g;
      dms[i * LQ + j] = m;
      ls[i * LQ + j] = l;
    }
    // <H, R>, for the gradient of T through exp(clip(T)) H
    float hr = 0.f;
    for (int e = tid; e < NP; e += BWD_THREADS) {
      const int n = e / P, p = e - n * P;
      hr = fmaf(hs[n * LP + p], rs[n * LP + p], hr);
    }
    hr = block_sum(hr, red);   // also the barrier after G, dM, L, w and e

    // a warp per row r of the chunk
    for (int r = warp; r < Q; r += BWD_THREADS / 32) {
      const int t = t0 + r;
      const float er = e_s[r], wr = w_s[r], dtr = dt_s[r];
      // (a) y_r's inter-chunk term: d(cum_r) += e_r [cum_r >= -60] (c_r·H)·dy_r
      float v = 0.f;
      for (int p = lane; p < P; p += 32) {
        float ch = 0.f;
        for (int n = 0; n < N; ++n) ch = fmaf(cs[r * LN + n], hs[n * LP + p], ch);
        v = fmaf(ch, dys[r * LP + p], v);
      }
      const float d_inter = cum_s[r] >= -60.f ? er * warp_sum(v) : 0.f;
      // (b) dc_r = e_r H dy_r + Σ_{j<=r} dG_rj b_j, dG_rj = dM_rj L_rj dt_j
      // (c) db_r = w_r R x_r + Σ_{i>=r} dG_ir c_i, and dsw_r = b_r·(R x_r)
      float dsw = 0.f;
      for (int n = lane; n < N; n += 32) {
        float hd = 0.f, rx = 0.f, gb = 0.f, gc = 0.f;
        for (int p = 0; p < P; ++p) {
          hd = fmaf(hs[n * LP + p], dys[r * LP + p], hd);
          rx = fmaf(rs[n * LP + p], xs[r * LP + p], rx);
        }
        for (int j = 0; j <= r; ++j)
          gb = fmaf(dms[r * LQ + j] * ls[r * LQ + j] * dt_s[j], bs[j * LN + n], gb);
        for (int i = r; i < Q; ++i)
          gc = fmaf(dms[i * LQ + r] * ls[i * LQ + r], cs[i * LN + n], gc);
        dsw = fmaf(bs[r * LN + n], rx, dsw);
        if (t < S) {
          dcp[(size_t)t * N + n] = er * hd + gb;
          dbp[(size_t)t * N + n] = wr * rx + dtr * gc;
        }
      }
      dsw = warp_sum(dsw);
      // (d) dx_r = w_r Rᵀ b_r + dt_r Σ_{i>=r} G_ir L_ir dy_i + D dy_r
      for (int p = lane; p < P; p += 32) {
        float rb = 0.f, gy = 0.f;
        for (int n = 0; n < N; ++n) rb = fmaf(rs[n * LP + p], bs[r * LN + n], rb);
        for (int i = r; i < Q; ++i)
          gy = fmaf(gs[i * LQ + r] * ls[i * LQ + r], dys[i * LP + p], gy);
        const float dyr = dys[r * LP + p];
        dd_acc = fmaf(dyr, xs[r * LP + p], dd_acc);
        if (t < S) dxb[(size_t)t * xrow + p] = st_val<T>(wr * rb + dtr * gy + dh * dyr);
      }
      // (e) ddt_r (before the prefix sum's part) and d(cum_r): the
      // intra-chunk terms dl_ij = dM_ij G_ij dt_j L_ij [cum_i - cum_j >= -60]
      // below the diagonal (on it the two terms cancel)
      float dw = 0.f, dl_row = 0.f, dl_col = 0.f;
      for (int i = lane; i < Q; i += 32) {
        if (i >= r) {
          const float wgt = gs[i * LQ + r] * ls[i * LQ + r];
          dw = fmaf(dms[i * LQ + r], wgt, dw);
          if (i > r && cum_s[i] - cum_s[r] >= -60.f) dl_col = fmaf(dms[i * LQ + r] * dtr, wgt, dl_col);
        } else if (cum_s[r] - cum_s[i] >= -60.f) {   // i plays j < r
          dl_row = fmaf(dms[r * LQ + i] * gs[r * LQ + i] * dt_s[i], ls[r * LQ + i], dl_row);
        }
      }
      dw = warp_sum(dw);
      dl_row = warp_sum(dl_row);
      dl_col = warp_sum(dl_col);
      if (lane == 0) {
        const float gap = total - cum_s[r];
        const float dgap = gap >= -60.f ? wr * dsw : 0.f;
        dgap_s[r] = dgap;
        ddt_s[r] = clip_exp(gap) * dsw + dw;
        dcum_s[r] = d_inter + dl_row - dl_col - dgap;
      }
    }
    __syncthreads();
    // T = cum_{Q-1}; then the reverse of the prefix sum, for dt and a
    if (tid == 0) {
      float dtotal = total >= -60.f ? et * hr : 0.f;
      for (int j = 0; j < Q; ++j) dtotal += dgap_s[j];
      dcum_s[Q - 1] += dtotal;
      float suf = 0.f;
      for (int j = Q - 1; j >= 0; --j) {
        suf += dcum_s[j];
        ddt_s[j] = fmaf(suf, ah, ddt_s[j]);
        da_acc = fmaf(suf, dt_s[j], da_acc);
      }
    }
    __syncthreads();
    for (int j = tid; j < Q; j += BWD_THREADS)
      if (t0 + j < S) ddt[((size_t)bb * S + t0 + j) * H + h] = ddt_s[j];
    // R <- exp(clip(T)) R + Σ_i e_i c_i ⊗ dy_i: the gradient of this chunk's H
    for (int e = tid; e < NP; e += BWD_THREADS) {
      const int n = e / P, p = e - n * P;
      float acc = 0.f;
      for (int i = 0; i < Q; ++i) acc = fmaf(e_s[i] * cs[i * LN + n], dys[i * LP + p], acc);
      rs[n * LP + p] = rs[n * LP + p] * et + acc;
    }
  }
  dd_acc = block_sum(dd_acc, red);
  if (tid == 0) {
    sums[(size_t)bb * H + h] = da_acc;
    sums[((size_t)B + bb) * H + h] = dd_acc;
  }
}

// db and dc summed over the heads, da and dd over their R rows of sums
// (the sequences; the bf16 kernel's (sequence, chunk) pairs), in order
template <typename T>
__global__ void ssd_scan_bwd_reduce_kernel(const float* __restrict__ db_part,
                                           const float* __restrict__ dc_part,
                                           const float* __restrict__ sums, T* __restrict__ db,
                                           T* __restrict__ dc, float* __restrict__ da,
                                           float* __restrict__ dd, int B, int S, int H, int N,
                                           int R) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_seq = (long long)S * N;
  if (idx < B * per_seq) {
    const long long bb = idx / per_seq, rest = idx - bb * per_seq;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      const size_t o = ((size_t)bb * H + h) * per_seq + rest;
      sb += db_part[o];
      sc += dc_part[o];
    }
    db[idx] = st_val<T>(sb);
    dc[idx] = st_val<T>(sc);
  }
  if (idx < H) {
    float sa = 0.f, sd = 0.f;
    for (int r = 0; r < R; ++r) {
      sa += sums[(size_t)r * H + idx];
      sd += sums[((size_t)R + r) * H + idx];
    }
    da[idx] = sa;
    if (dd) dd[idx] = sd;
  }
}

template <typename T>
int launch_bwd(const void* x, const void* dt, const void* a, const void* b, const void* c,
               const void* d_skip, const void* dy, void* dx, void* ddt, void* da, void* db,
               void* dc, void* dd, void* states, void* db_part, void* dc_part, void* sums, int B,
               int S, int H, int P, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * (size_t)Q * (P + 1) + 2 * (size_t)Q * (N + 1) +
                                       2 * (size_t)N * (P + 1) + 3 * (size_t)Q * (Q + 1) +
                                       8 * (size_t)Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  ssd_scan_bwd_kernel<T><<<dim3(H, B), BWD_THREADS, smem, st>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)b, (const T*)c,
      (const float*)d_skip, (const T*)dy, (T*)dx, (float*)ddt, (float*)states,
      (float*)db_part, (float*)dc_part, (float*)sums, B, S, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = std::max((long long)B * S * N, (long long)H);
  ssd_scan_bwd_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float*)db_part, (const float*)dc_part, (const float*)sums, (T*)db, (T*)dc,
      (float*)da, (float*)dd, B, S, H, N, B);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ backward, bf16, tensor cores
//
// Chunk-parallel: across chunks only the [N, P] state H and its gradient R
// carry, so they are computed first, and then every chunk's gradients at
// once.  Three kernels:
//   1. states: a block per (64 columns of P, head, sequence), the forward
//      kernel's layout, walks the chunks forward writing H_k (the state
//      before chunk k) to f32 scratch, then in reverse writing R_k (the
//      gradient of H_{k+1}): H_{k+1} = exp(clip(T)) H_k + Σ_j w_j b_j ⊗ x_j
//      and R_{k-1} = exp(clip(T)) R_k + Σ_i e_i c_i ⊗ dy_i, each chunk's sum
//      one [N x Q]·[Q x P] mma product into the f32 accumulators that hold
//      the carried state, chunks prefetched by cp.async as in the forward;
//   2. chunk: a block per (chunk, head, sequence), 4 warps of 16 rows,
//      reads the chunk, H_k and R_k (rounded to bf16 in shared memory, their
//      f32 dot <H, R> taken on the way) and does the rest on the tensor
//      cores: G = C·Bᵀ and dM = dY·Xᵀ (rows i of a warp, the tiles j <= i),
//      C·H and dY·Hᵀ (dc's and d(cum)'s inter-chunk terms), X·Rᵀ and B·R
//      (db's and dx's state terms), and the three lower-triangular products
//      dc += (dM∘L∘dt)·B, db += dt (dM∘L)ᵀ·C, dx += dt (G∘L)ᵀ·dY, the last
//      two reading the factors written by the warps of rows i, transposed,
//      by ldmatrix.trans;
//   3. the reduce above: db, dc over the heads, da, dd over the (sequence,
//      chunk) pairs, in order.
// In f32 on the CUDA cores, as the closed form: L, the clip masks, the
// weighted factors before their rounding, dw, dl_row and dl_col (dl_ij's
// two sums cancel in d(cum), so they never see bf16), d(cum)'s prefix-sum
// reverse and the chunk's prefix sums (warp scans), <H, R>, and every
// accumulator.  Rounded to bf16, and only there
// (kernels/ref.py::ssd_scan_bwd_mma_ref models the same): the operands
// b_j w_j and c_i e_i of the state sums, H_k and R_k as operands, the
// factors G∘L, dM∘L and dM∘L∘dt, and the outputs dx, db, dc.  Exponents in
// base 2 (ex2.approx), as the forward.  No atomics: two calls give the same
// bits.  Takes N in {64, 128} and P a multiple of 8 whose buffers fit a
// block (kernels/ssd_scan.py::bwd_mma_smem_bytes).

constexpr int ST_THREADS = 256;   // states: 8 warps, 2 halves of 64 columns x 4 row groups
constexpr int CG_THREADS = 128;   // chunk: 4 warps x 16 rows of the chunk
constexpr int LDQ = Q + 8;        // rows of the chunk-square factors: 16 bytes of pad

// The chunk's inclusive prefix sums of dt·a (base 2), by one warp, two
// steps a lane: cum[2 lane], cum[2 lane + 1].
__device__ __forceinline__ float2 chunk_cum2(const float* dts, float ah2, int lane) {
  const float2 d = *reinterpret_cast<const float2*>(dts + 2 * lane);
  const float v0 = d.x * ah2;
  float run = v0 + d.y * ah2;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += o;
  }
  const float before = __shfl_up_sync(0xffffffffu, run, 1);
  return make_float2((lane > 0 ? before : 0.f) + v0, run);
}

// One stage of the states kernel: the chunk's b or c [Q][N + 8] and x or dy
// [Q][LDX] (the block's 64 columns; bf16), dt, its prefix sums and the
// operand's scales [Q] (f32).
template <int N>
struct StLayout {
  static constexpr int LDN = N + 8;
  static constexpr size_t OP = 0, VAL = OP + sizeof(bf16) * Q * LDN,
                          DT = VAL + sizeof(bf16) * Q * LDX, CUM = DT + sizeof(float) * Q,
                          SC = CUM + sizeof(float) * Q, STAGE = SC + sizeof(float) * Q,
                          BYTES = 2 * STAGE;
};

template <int N>
__device__ __forceinline__ void st_load(unsigned char* stage, const bf16* __restrict__ op,
                                        const bf16* __restrict__ val,
                                        const float* __restrict__ dt, int b, int h, int p0,
                                        int s0, int S, int H, int P) {
  using L = StLayout<N>;
  constexpr int CPR = N / 8, XPR = PT / 8;   // 16-byte pieces a row
  bf16* os = reinterpret_cast<bf16*>(stage + L::OP);
  bf16* vs = reinterpret_cast<bf16*>(stage + L::VAL);
  float* dts = reinterpret_cast<float*>(stage + L::DT);
  for (int i = threadIdx.x; i < Q * CPR; i += ST_THREADS) {
    const int r = i / CPR, col = (i - r * CPR) * 8, t = s0 + r;
    const bool in = t < S;
    cp_async16(os + r * L::LDN + col, op + ((size_t)b * S + (in ? t : 0)) * N + col, in);
  }
  for (int i = threadIdx.x; i < Q * XPR; i += ST_THREADS) {
    const int r = i / XPR, col = (i - r * XPR) * 8, t = s0 + r, p = p0 + col;
    const bool in = t < S && p < P;
    cp_async16(vs + r * LDX + col,
               val + (((size_t)b * S + (in ? t : 0)) * H + h) * P + (in ? p : 0), in);
  }
  if (threadIdx.x < Q) {
    const int t = s0 + threadIdx.x;
    const bool in = t < S;
    cp_async4(dts + threadIdx.x, dt + ((size_t)b * S + (in ? t : 0)) * H + h, in);
  }
  cp_async_commit();
}

// A block: sequence b, head h, columns [PT x, PT x + PT); a warp: columns
// 32 half + [0, 32) of the block's and state rows [w N/4, (w+1) N/4), as
// mma accumulators.  hst and rst: [B, H, nc, N, P] f32.
template <int N>
__global__ void __launch_bounds__(ST_THREADS, N == 64 ? 2 : 1) ssd_scan_bwd_states_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const bf16* __restrict__ bm, const bf16* __restrict__ cm, const bf16* __restrict__ dy,
    float* __restrict__ hst, float* __restrict__ rst, int S, int H, int P) {
  using L = StLayout<N>;
  constexpr int LDN = L::LDN, MT = N / 64, NP = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int half = warp / 4, w = warp % 4, g = lane / 4, t4 = lane % 4;
  const int nrow0 = w * (N / 4), pc = half * 32;
  const float ah2 = a[h] * LOG2E;
  const int nc = (S + Q - 1) / Q;
  const size_t plane = (size_t)N * P;

  for (int pass = 0; pass < 2; ++pass) {
    const bool rev = pass == 1;
    const bf16* op = rev ? cm : bm;
    const bf16* val = rev ? dy : x;
    float* out = (rev ? rst : hst) + ((size_t)b * H + h) * nc * plane;
    float st[MT][NP][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NP; ++n) st[mt][n][0] = st[mt][n][1] = st[mt][n][2] = st[mt][n][3] = 0.f;
    st_load<N>(smem_raw, op, val, dt, b, h, p0, (rev ? nc - 1 : 0) * Q, S, H, P);
    for (int it = 0; it < nc; ++it) {
      const int kc = rev ? nc - 1 - it : it;
      unsigned char* stage = smem_raw + (it & 1) * L::STAGE;
      if (it + 1 < nc) {
        st_load<N>(smem_raw + ((it + 1) & 1) * L::STAGE, op, val, dt, b, h, p0,
                   (rev ? kc - 1 : kc + 1) * Q, S, H, P);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float* cum = reinterpret_cast<float*>(stage + L::CUM);
      float* sc = reinterpret_cast<float*>(stage + L::SC);
      if (warp == 0) {   // prefix sums, and the operand's scales w_j or e_i
        const float* dts = reinterpret_cast<const float*>(stage + L::DT);
        const float2 c2 = chunk_cum2(dts, ah2, lane);
        const float total = __shfl_sync(0xffffffffu, c2.y, 31);
        *reinterpret_cast<float2*>(cum + 2 * lane) = c2;
        *reinterpret_cast<float2*>(sc + 2 * lane) =
            rev ? make_float2(clip_exp2(c2.x), clip_exp2(c2.y))
                : make_float2(clip_exp2(total - c2.x) * dts[2 * lane],
                              clip_exp2(total - c2.y) * dts[2 * lane + 1]);
      }
      __syncthreads();
      // the state before this chunk (forward) or the gradient of the state
      // after it (reverse), to scratch
      float* o = out + (size_t)kc * plane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const int row = nrow0 + mt * 16 + g, col = p0 + pc + n * 8 + 2 * t4;
          if (col < P) {
            *reinterpret_cast<float2*>(o + (size_t)row * P + col) =
                make_float2(st[mt][n][0], st[mt][n][1]);
            *reinterpret_cast<float2*>(o + (size_t)(row + 8) * P + col) =
                make_float2(st[mt][n][2], st[mt][n][3]);
          }
        }
      if (it + 1 < nc) {   // carry: st exp(clip(T)) + (op ∘ sc)ᵀ · val
        const bf16* os = reinterpret_cast<const bf16*>(stage + L::OP);
        const bf16* vs = reinterpret_cast<const bf16*>(stage + L::VAL) + pc;
        const float dtot = clip_exp2(cum[Q - 1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NP; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[mt][n][e] *= dtot;
#pragma unroll
        for (int kk = 0; kk < Q / 16; ++kk) {
          // the scales at steps 16 kk + 2 t4 (+1) and 16 kk + 8 + 2 t4 (+1)
          const float2 wa = *reinterpret_cast<const float2*>(sc + 16 * kk + 2 * t4);
          const float2 wb = *reinterpret_cast<const float2*>(sc + 16 * kk + 8 + 2 * t4);
          unsigned vf[NP / 2][4];
#pragma unroll
          for (int np = 0; np < NP / 2; ++np) frag_b2_t(vs, LDX, kk * 16, np * 16, vf[np]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            unsigned af[4];   // (op ∘ sc)ᵀ rows nrow0 + 16 mt .., steps 16 kk ..
            frag_a_t(os, LDN, nrow0 + mt * 16, kk * 16, af);
            af[0] = scale_bf16x2(af[0], wa.x, wa.y);
            af[1] = scale_bf16x2(af[1], wa.x, wa.y);
            af[2] = scale_bf16x2(af[2], wb.x, wb.y);
            af[3] = scale_bf16x2(af[3], wb.x, wb.y);
#pragma unroll
            for (int np = 0; np < NP / 2; ++np) {
              mma_bf16(st[mt][2 * np], af, vf[np][0], vf[np][1]);
              mma_bf16(st[mt][2 * np + 1], af, vf[np][2], vf[np][3]);
            }
          }
        }
      }
      __syncthreads();   // every warp is done with this stage before it is refilled
    }
  }
}

// Shared memory of the chunk kernel (P rounded up to 16 for the k slices
// over P; its rows padded by 16 bytes): x, dy [Q][kp + 8], b, c [Q][N + 8],
// H, R [N][kp + 8] and the factors G∘L, dM∘L [Q][LDQ] (bf16), and 14
// vectors of the chunk (f32): dt, cum, d_inter, dl_row, dsw, dw and dl_col
// per warp (4 each), block sums.
struct CgSmem {
  int ldp;
  size_t xs, dys, bs, cs, hs, rs, wg, ml, vec, bytes;
  __host__ __device__ CgSmem(int N, int P) {
    ldp = (P + 15) / 16 * 16 + 8;
    const size_t ldn = N + 8;
    xs = 0;
    dys = xs + sizeof(bf16) * Q * ldp;
    bs = dys + sizeof(bf16) * Q * ldp;
    cs = bs + sizeof(bf16) * Q * ldn;
    hs = cs + sizeof(bf16) * Q * ldn;
    rs = hs + sizeof(bf16) * (size_t)N * ldp;
    wg = rs + sizeof(bf16) * (size_t)N * ldp;
    ml = wg + sizeof(bf16) * Q * LDQ;
    vec = ml + sizeof(bf16) * Q * LDQ;
    bytes = vec + sizeof(float) * 14 * Q;
  }
};

template <int N>
__global__ void __launch_bounds__(CG_THREADS) ssd_scan_bwd_chunk_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const bf16* __restrict__ bm, const bf16* __restrict__ cm, const float* __restrict__ d_skip,
    const bf16* __restrict__ dy, const float* __restrict__ hst, const float* __restrict__ rst,
    bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ db_part,
    float* __restrict__ dc_part, float* __restrict__ sums, int B, int S, int H, int P) {
  constexpr int LDN = N + 8, KN = N / 16, NN = N / 8;
  const CgSmem L(N, P);
  const int ldp = L.ldp, kp = ldp - 8;   // P rounded up to 16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + L.xs);
  bf16* dys = reinterpret_cast<bf16*>(smem_raw + L.dys);
  bf16* bs = reinterpret_cast<bf16*>(smem_raw + L.bs);
  bf16* cs = reinterpret_cast<bf16*>(smem_raw + L.cs);
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + L.hs);
  bf16* rs = reinterpret_cast<bf16*>(smem_raw + L.rs);
  bf16* wg = reinterpret_cast<bf16*>(smem_raw + L.wg);   // G∘L, rows i, columns j <= i
  bf16* ml = reinterpret_cast<bf16*>(smem_raw + L.ml);   // dM∘L
  float* dts = reinterpret_cast<float*>(smem_raw + L.vec);
  float* cum = dts + Q;         // base 2
  float* dinter = cum + Q;      // d(cum_i) of y_i's inter-chunk term
  float* dlrow = dinter + Q;    // Σ_j dl_ij
  float* dsw = dlrow + Q;       // b_j · (R x_j)
  float* colw = dsw + Q;        // [4][Q] per warp: Σ_i dM_ij G_ij L_ij
  float* coll = colw + 4 * Q;   // [4][Q] per warp: Σ_i dl_ij
  float* red = coll + 4 * Q;    // block sums: <H, R> and Σ dy x per warp

  const int kc = blockIdx.x, nc = gridDim.x, h = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t4 = lane % 4;
  const int s0 = kc * Q, row0 = warp * 16;
  const float ah = a[h], ah2 = ah * LOG2E, dh = d_skip != nullptr ? d_skip[h] : 0.f;

  // ---- the chunk by cp.async (rows past S and columns past P zero)
  {
    const int XPR = kp / 8;
    for (int i = tid; i < Q * XPR; i += CG_THREADS) {
      const int r = i / XPR, col = (i - r * XPR) * 8, t = s0 + r;
      const bool in = t < S && col < P;
      const size_t o = (((size_t)bb * S + (in ? t : 0)) * H + h) * P + (in ? col : 0);
      cp_async16(xs + r * ldp + col, x + o, in);
      cp_async16(dys + r * ldp + col, dy + o, in);
    }
    constexpr int CPR = N / 8;
    for (int i = tid; i < Q * CPR; i += CG_THREADS) {
      const int r = i / CPR, col = (i - r * CPR) * 8, t = s0 + r;
      const bool in = t < S;
      const size_t o = ((size_t)bb * S + (in ? t : 0)) * N + col;
      cp_async16(bs + r * LDN + col, bm + o, in);
      cp_async16(cs + r * LDN + col, cm + o, in);
    }
    if (tid < Q) {
      const int t = s0 + tid;
      const bool in = t < S;
      cp_async4(dts + tid, dt + ((size_t)bb * S + (in ? t : 0)) * H + h, in);
    }
    cp_async_commit();
  }
  // ---- H_k and R_k rounded to bf16 (columns past P zero), and <H, R> in f32
  float hr = 0.f;
  {
    const size_t base = (((size_t)bb * H + h) * nc + kc) * (size_t)N * P;
    const int PPR = kp / 4;
    for (int i = tid; i < N * PPR; i += CG_THREADS) {
      const int n = i / PPR, col = (i - n * PPR) * 4;
      float4 hv = make_float4(0.f, 0.f, 0.f, 0.f), rv = hv;
      if (col < P) {
        hv = *reinterpret_cast<const float4*>(hst + base + (size_t)n * P + col);
        rv = *reinterpret_cast<const float4*>(rst + base + (size_t)n * P + col);
      }
      hr = fmaf(hv.x, rv.x, hr);
      hr = fmaf(hv.y, rv.y, hr);
      hr = fmaf(hv.z, rv.z, hr);
      hr = fmaf(hv.w, rv.w, hr);
      *reinterpret_cast<uint2*>(hs + n * ldp + col) =
          make_uint2(pack_bf16(hv.x, hv.y), pack_bf16(hv.z, hv.w));
      *reinterpret_cast<uint2*>(rs + n * ldp + col) =
          make_uint2(pack_bf16(rv.x, rv.y), pack_bf16(rv.z, rv.w));
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // Σ dy x over the chunk (for dd), and the chunk's prefix sums
  float dd = 0.f;
  for (int i = tid; i < Q * (kp / 2); i += CG_THREADS) {
    const int r = i / (kp / 2), c = (i - r * (kp / 2)) * 2;
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + r * ldp + c));
    const float2 yv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dys + r * ldp + c));
    dd = fmaf(yv.x, xv.x, dd);
    dd = fmaf(yv.y, xv.y, dd);
  }
  hr = warp_sum(hr);
  dd = warp_sum(dd);
  if (lane == 0) {
    red[warp] = hr;
    red[4 + warp] = dd;
  }
  if (warp == 0) *reinterpret_cast<float2*>(cum + 2 * lane) = chunk_cum2(dts, ah2, lane);
  __syncthreads();
  const float T2 = cum[Q - 1];

  // ---- 1. this warp's rows i = row0 + g (+8) as rows of G and dM
  const int i0 = row0 + g, i1 = i0 + 8;
  const float ci0 = cum[i0], ci1 = cum[i1];
  unsigned cf[KN][4];   // C rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) frag_a(cs, LDN, row0, kk * 16, cf[kk]);
  unsigned dgf[4][4];   // dM∘L∘dt, rounded, as A fragments per 16 columns j <= i
  {
    float gacc[8][4], macc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[n][e] = macc[n][e] = 0.f;
    // G = C·Bᵀ and dM = dY·Xᵀ over the column tiles j <= i
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np > warp) break;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        unsigned bf[4];
        frag_b2(bs, LDN, np * 16, kk * 16, bf);
        mma_bf16(gacc[2 * np], cf[kk], bf[0], bf[1]);
        mma_bf16(gacc[2 * np + 1], cf[kk], bf[2], bf[3]);
      }
    }
    for (int kk = 0; kk < kp / 16; ++kk) {
      unsigned af[4];
      frag_a(dys, ldp, row0, kk * 16, af);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np > warp) break;
        unsigned bf[4];
        frag_b2(xs, ldp, np * 16, kk * 16, bf);
        mma_bf16(macc[2 * np], af, bf[0], bf[1]);
        mma_bf16(macc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    // the f32 elementwise terms: L, the factors, dw and dl (rows and columns)
    float dlr0 = 0.f, dlr1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = 8 * n + 2 * t4;
      float cw0 = 0.f, cw1 = 0.f, cl0 = 0.f, cl1 = 0.f;
      if (n / 2 <= warp) {
        const float2 cj = *reinterpret_cast<const float2*>(cum + j);
        const float2 dj = *reinterpret_cast<const float2*>(dts + j);
        float wv[4], mv[4], dv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = j + (e & 1), ii = e < 2 ? i0 : i1;
          const float cjj = (e & 1) ? cj.y : cj.x, djj = (e & 1) ? dj.y : dj.x;
          float wgt = 0.f, mlv = 0.f, dwv = 0.f, dlv = 0.f;
          if (jj <= ii) {
            const float diff = (e < 2 ? ci0 : ci1) - cjj;
            const float l = clip_exp2(diff);
            wgt = gacc[n][e] * l;
            mlv = macc[n][e] * l;
            dwv = macc[n][e] * wgt;
            if (jj < ii && diff >= CLIP2) dlv = dwv * djj;
          }
          wv[e] = wgt;
          mv[e] = mlv;
          dv[e] = mlv * djj;
          if (e < 2) dlr0 += dlv; else dlr1 += dlv;
          if (e & 1) { cw1 += dwv; cl1 += dlv; } else { cw0 += dwv; cl0 += dlv; }
        }
        *reinterpret_cast<unsigned*>(wg + i0 * LDQ + j) = pack_bf16(wv[0], wv[1]);
        *reinterpret_cast<unsigned*>(wg + i1 * LDQ + j) = pack_bf16(wv[2], wv[3]);
        *reinterpret_cast<unsigned*>(ml + i0 * LDQ + j) = pack_bf16(mv[0], mv[1]);
        *reinterpret_cast<unsigned*>(ml + i1 * LDQ + j) = pack_bf16(mv[2], mv[3]);
        dgf[n / 2][(n % 2) * 2] = pack_bf16(dv[0], dv[1]);
        dgf[n / 2][(n % 2) * 2 + 1] = pack_bf16(dv[2], dv[3]);
      }
      // columns j, j + 1 summed over this warp's 16 rows (the lanes of one t4)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cw0 += __shfl_xor_sync(0xffffffffu, cw0, off);
        cw1 += __shfl_xor_sync(0xffffffffu, cw1, off);
        cl0 += __shfl_xor_sync(0xffffffffu, cl0, off);
        cl1 += __shfl_xor_sync(0xffffffffu, cl1, off);
      }
      if (g == 0) {
        *reinterpret_cast<float2*>(colw + warp * Q + j) = make_float2(cw0, cw1);
        *reinterpret_cast<float2*>(coll + warp * Q + j) = make_float2(cl0, cl1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      dlr0 += __shfl_xor_sync(0xffffffffu, dlr0, off);
      dlr1 += __shfl_xor_sync(0xffffffffu, dlr1, off);
    }
    if (t4 == 0) {
      dlrow[i0] = dlr0;
      dlrow[i1] = dlr1;
    }
  }
  const float e0 = clip_exp2(ci0), e1 = clip_exp2(ci1);
  // dc_i = e_i (dY·Hᵀ)_i + Σ_{j<=i} (dM∘L∘dt)_ij b_j, to this head's part
  {
    float dca[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) dca[n][0] = dca[n][1] = dca[n][2] = dca[n][3] = 0.f;
    for (int kk = 0; kk < kp / 16; ++kk) {
      unsigned af[4];
      frag_a(dys, ldp, row0, kk * 16, af);
#pragma unroll
      for (int nb = 0; nb < N / 16; ++nb) {
        unsigned bf[4];
        frag_b2(hs, ldp, nb * 16, kk * 16, bf);
        mma_bf16(dca[2 * nb], af, bf[0], bf[1]);
        mma_bf16(dca[2 * nb + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      dca[n][0] *= e0;
      dca[n][1] *= e0;
      dca[n][2] *= e1;
      dca[n][3] *= e1;
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np > warp) break;
#pragma unroll
      for (int nb = 0; nb < N / 16; ++nb) {
        unsigned bf[4];
        frag_b2_t(bs, LDN, np * 16, nb * 16, bf);
        mma_bf16(dca[2 * nb], dgf[np], bf[0], bf[1]);
        mma_bf16(dca[2 * nb + 1], dgf[np], bf[2], bf[3]);
      }
    }
    float* dcp = dc_part + ((size_t)bb * H + h) * S * N;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n * 8 + 2 * t4;
      if (s0 + i0 < S)
        *reinterpret_cast<float2*>(dcp + (size_t)(s0 + i0) * N + col) =
            make_float2(dca[n][0], dca[n][1]);
      if (s0 + i1 < S)
        *reinterpret_cast<float2*>(dcp + (size_t)(s0 + i1) * N + col) =
            make_float2(dca[n][2], dca[n][3]);
    }
  }
  // d(cum_i) += [cum_i >= -60] e_i Σ_p (C·H)_ip dy_ip
  {
    float di0 = 0.f, di1 = 0.f;
    for (int pb = 0; pb < kp; pb += 64) {
      float ch[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) ch[n][0] = ch[n][1] = ch[n][2] = ch[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (pb + np * 16 >= kp) break;
          unsigned bf[4];
          frag_b2_t(hs, ldp, kk * 16, pb + np * 16, bf);
          mma_bf16(ch[2 * np], cf[kk], bf[0], bf[1]);
          mma_bf16(ch[2 * np + 1], cf[kk], bf[2], bf[3]);
        }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = pb + n * 8 + 2 * t4;
        if (col < P) {
          const float2 ya = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dys + i0 * ldp + col));
          const float2 yb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dys + i1 * ldp + col));
          di0 = fmaf(ch[n][0], ya.x, fmaf(ch[n][1], ya.y, di0));
          di1 = fmaf(ch[n][2], yb.x, fmaf(ch[n][3], yb.y, di1));
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      di0 += __shfl_xor_sync(0xffffffffu, di0, off);
      di1 += __shfl_xor_sync(0xffffffffu, di1, off);
    }
    if (t4 == 0) {
      dinter[i0] = ci0 >= CLIP2 ? e0 * di0 : 0.f;
      dinter[i1] = ci1 >= CLIP2 ? e1 * di1 : 0.f;
    }
  }
  __syncthreads();   // G∘L and dM∘L of every row tile are in shared memory

  // ---- 2. this warp's rows j = row0 + g (+8) as columns of G and dM
  const int j0 = i0, j1 = i1;
  const float ew0 = clip_exp2(T2 - cum[j0]), ew1 = clip_exp2(T2 - cum[j1]);
  const float dt0 = dts[j0], dt1 = dts[j1];
  // db_j = dt_j (exp(clip(T - cum_j)) (X·Rᵀ)_j + Σ_{i>=j} (dM∘L)_ij c_i),
  // and dsw_j = b_j · (X·Rᵀ)_j
  {
    float dba[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) dba[n][0] = dba[n][1] = dba[n][2] = dba[n][3] = 0.f;
    for (int kk = 0; kk < kp / 16; ++kk) {
      unsigned af[4];
      frag_a(xs, ldp, row0, kk * 16, af);
#pragma unroll
      for (int nb = 0; nb < N / 16; ++nb) {
        unsigned bf[4];
        frag_b2(rs, ldp, nb * 16, kk * 16, bf);
        mma_bf16(dba[2 * nb], af, bf[0], bf[1]);
        mma_bf16(dba[2 * nb + 1], af, bf[2], bf[3]);
      }
    }
    float s0v = 0.f, s1v = 0.f;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n * 8 + 2 * t4;
      const float2 ba = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bs + j0 * LDN + col));
      const float2 bb2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bs + j1 * LDN + col));
      s0v = fmaf(dba[n][0], ba.x, fmaf(dba[n][1], ba.y, s0v));
      s1v = fmaf(dba[n][2], bb2.x, fmaf(dba[n][3], bb2.y, s1v));
      dba[n][0] *= ew0;
      dba[n][1] *= ew0;
      dba[n][2] *= ew1;
      dba[n][3] *= ew1;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0v += __shfl_xor_sync(0xffffffffu, s0v, off);
      s1v += __shfl_xor_sync(0xffffffffu, s1v, off);
    }
    if (t4 == 0) {
      dsw[j0] = s0v;
      dsw[j1] = s1v;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < warp) continue;
      unsigned af[4];   // (dM∘L)ᵀ rows j, columns i of tile kk
      frag_a_t(ml, LDQ, row0, kk * 16, af);
#pragma unroll
      for (int nb = 0; nb < N / 16; ++nb) {
        unsigned bf[4];
        frag_b2_t(cs, LDN, kk * 16, nb * 16, bf);
        mma_bf16(dba[2 * nb], af, bf[0], bf[1]);
        mma_bf16(dba[2 * nb + 1], af, bf[2], bf[3]);
      }
    }
    float* dbp = db_part + ((size_t)bb * H + h) * S * N;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n * 8 + 2 * t4;
      if (s0 + j0 < S)
        *reinterpret_cast<float2*>(dbp + (size_t)(s0 + j0) * N + col) =
            make_float2(dt0 * dba[n][0], dt0 * dba[n][1]);
      if (s0 + j1 < S)
        *reinterpret_cast<float2*>(dbp + (size_t)(s0 + j1) * N + col) =
            make_float2(dt1 * dba[n][2], dt1 * dba[n][3]);
    }
  }
  // dx_j = dt_j (exp(clip(T - cum_j)) (B·R)_j + Σ_{i>=j} (G∘L)_ij dy_i) + D dy_j
  for (int pb = 0; pb < kp; pb += 64) {
    float xa[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) xa[n][0] = xa[n][1] = xa[n][2] = xa[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      unsigned af[4];
      frag_a(bs, LDN, row0, kk * 16, af);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (pb + np * 16 >= kp) break;
        unsigned bf[4];
        frag_b2_t(rs, ldp, kk * 16, pb + np * 16, bf);
        mma_bf16(xa[2 * np], af, bf[0], bf[1]);
        mma_bf16(xa[2 * np + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      xa[n][0] *= ew0;
      xa[n][1] *= ew0;
      xa[n][2] *= ew1;
      xa[n][3] *= ew1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < warp) continue;
      unsigned af[4];   // (G∘L)ᵀ rows j, columns i of tile kk
      frag_a_t(wg, LDQ, row0, kk * 16, af);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (pb + np * 16 >= kp) break;
        unsigned bf[4];
        frag_b2_t(dys, ldp, kk * 16, pb + np * 16, bf);
        mma_bf16(xa[2 * np], af, bf[0], bf[1]);
        mma_bf16(xa[2 * np + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = pb + n * 8 + 2 * t4;
      if (col >= P) continue;
      const float2 ya = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dys + j0 * ldp + col));
      const float2 yb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dys + j1 * ldp + col));
      if (s0 + j0 < S)
        *reinterpret_cast<__nv_bfloat162*>(dx + (((size_t)bb * S + s0 + j0) * H + h) * P + col) =
            __floats2bfloat162_rn(fmaf(dt0, xa[n][0], dh * ya.x), fmaf(dt0, xa[n][1], dh * ya.y));
      if (s0 + j1 < S)
        *reinterpret_cast<__nv_bfloat162*>(dx + (((size_t)bb * S + s0 + j1) * H + h) * P + col) =
            __floats2bfloat162_rn(fmaf(dt1, xa[n][2], dh * yb.x), fmaf(dt1, xa[n][3], dh * yb.y));
    }
  }
  __syncthreads();   // dsw, dl_row, d_inter and the column sums are in shared memory

  // ---- 3. d(cum), its prefix sum's reverse, ddt, and the chunk's da and dd (warp 0)
  if (warp == 0) {
    float dc2[2], ddt0[2], dgap[2], dtv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * lane + e;
      const float dw = colw[r] + colw[Q + r] + colw[2 * Q + r] + colw[3 * Q + r];
      const float dlc = coll[r] + coll[Q + r] + coll[2 * Q + r] + coll[3 * Q + r];
      const float gap = T2 - cum[r], ew = clip_exp2(gap);
      dtv[e] = dts[r];
      dgap[e] = gap >= CLIP2 ? ew * dtv[e] * dsw[r] : 0.f;
      dc2[e] = dinter[r] + dlrow[r] - dlc - dgap[e];
      ddt0[e] = ew * dsw[r] + dw;
    }
    const float hrs = red[0] + red[1] + red[2] + red[3];
    const float dds = red[4] + red[5] + red[6] + red[7];
    // T = cum_{Q-1}: exp(clip(T)) H and every w_j
    const float dtotal = (T2 >= CLIP2 ? clip_exp2(T2) * hrs : 0.f) + warp_sum(dgap[0] + dgap[1]);
    if (lane == 31) dc2[1] += dtotal;
    // suffix sums of d(cum): lanes from the last
    float run = dc2[0] + dc2[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, run, off);
      if (lane + off < 32) run += o;
    }
    const float after = __shfl_down_sync(0xffffffffu, run, 1);
    const float suf1 = dc2[1] + (lane < 31 ? after : 0.f), suf0 = dc2[0] + suf1;
    const float da = warp_sum(fmaf(suf0, dtv[0], suf1 * dtv[1]));
    float* ddb = ddt + ((size_t)bb * S + s0) * H + h;
    if (s0 + 2 * lane < S) ddb[(size_t)(2 * lane) * H] = fmaf(suf0, ah, ddt0[0]);
    if (s0 + 2 * lane + 1 < S) ddb[(size_t)(2 * lane + 1) * H] = fmaf(suf1, ah, ddt0[1]);
    if (lane == 0) {
      sums[((size_t)bb * nc + kc) * H + h] = da;
      sums[(((size_t)B + bb) * nc + kc) * H + h] = dds;
    }
  }
}

template <int N>
int launch_bwd_bf16(const void* x, const void* dt, const void* a, const void* b, const void* c,
                    const void* d_skip, const void* dy, void* dx, void* ddt, void* da, void* db,
                    void* dc, void* dd, void* states, void* db_part, void* dc_part, void* sums,
                    int B, int S, int H, int P, void* stream) {
  const size_t st_smem = StLayout<N>::BYTES, cg_smem = CgSmem(N, P).bytes;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_bwd_states_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)st_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_scan_bwd_chunk_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cg_smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + Q - 1) / Q;
  float* hst = (float*)states;
  float* rst = hst + (size_t)B * H * nc * N * P;
  ssd_scan_bwd_states_kernel<N><<<dim3((P + PT - 1) / PT, H, B), ST_THREADS, st_smem, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)a, (const bf16*)b, (const bf16*)c,
      (const bf16*)dy, hst, rst, S, H, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_bwd_chunk_kernel<N><<<dim3(nc, H, B), CG_THREADS, cg_smem, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)a, (const bf16*)b, (const bf16*)c,
      (const float*)d_skip, (const bf16*)dy, hst, rst, (bf16*)dx, (float*)ddt,
      (float*)db_part, (float*)dc_part, (float*)sums, B, S, H, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = std::max((long long)B * S * N, (long long)H);
  ssd_scan_bwd_reduce_kernel<bf16><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float*)db_part, (const float*)dc_part, (const float*)sums, (bf16*)db, (bf16*)dc,
      (float*)da, (float*)dd, B, S, H, N, B * nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* a, const void* b,
                                const void* c, const void* d_skip, const void* dy, void* dx,
                                void* ddt, void* da, void* db, void* dc, void* dd, void* states,
                                void* db_part, void* dc_part, void* sums, int B, int S, int H,
                                int P, int N, void* stream) {
  return launch_bwd<float>(x, dt, a, b, c, d_skip, dy, dx, ddt, da, db, dc, dd, states, db_part,
                           dc_part, sums, B, S, H, P, N, stream);
}

extern "C" int ssd_scan_bwd_bf16(const void* x, const void* dt, const void* a, const void* b,
                                 const void* c, const void* d_skip, const void* dy, void* dx,
                                 void* ddt, void* da, void* db, void* dc, void* dd,
                                 void* states, void* db_part, void* dc_part, void* sums, int B,
                                 int S, int H, int P, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 8 != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (N == 64)
    return launch_bwd_bf16<64>(x, dt, a, b, c, d_skip, dy, dx, ddt, da, db, dc, dd, states,
                               db_part, dc_part, sums, B, S, H, P, stream);
  if (N == 128)
    return launch_bwd_bf16<128>(x, dt, a, b, c, d_skip, dy, dx, ddt, da, db, dc, dd, states,
                                db_part, dc_part, sums, B, S, H, P, stream);
  return (int)cudaErrorInvalidValue;
}
