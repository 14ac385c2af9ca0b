// Mamba2 SSD scan (state-space duality), per head h:
//
//     S_t = exp(dt_t a_h) S_{t-1} + dt_t (b_t ⊗ x_t),    y_t = S_t^T c_t + d_h x_t
//
// evaluated chunk by chunk: within a chunk of Q=64 steps a causal
// decay-weighted "attention" (C·Bᵀ ∘ decay ∘ causal)·(dt·x), across chunks
// an [N, P] f32 state carried in order, plus the state's contribution
// exp(cum_t)·(c_t · S).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas
// (body _ssd_kernel).  The TPU runs the chunk axis of its grid in order and
// carries the state in VMEM from one grid step to the next; on Hopper
// nothing carries over between blocks, so one block owns one (batch, head)
// pair and loops over the chunks itself, keeping the state in shared memory
// (16 KB at N=P=64, 32 KB at N=128).  Each chunk's x, b, c and dt are
// staged in dynamic shared memory as f32 (~84 KB in all at N=P=64, ~133 KB
// at N=128).  A ragged last chunk gets dt=0 and x=b=c=0 in its padded rows,
// which makes them exact no-ops, so any S works.  The same
// clip(., -60, 0) guards every exponent as in _ssd_kernel.  d_skip·x is
// fused into the epilogue (one rounding to the output type instead of the
// reference's two).
//
// Bound on the H100: at the zamba2-1.2b prefill shape (B=4 S=512 H=64 P=64
// N=64, bf16) the function moves ~35 MB (a ~10 µs bound) and, in chunks of
// 64, does ~4.3 GFLOP: ~4 µs at the bf16 tensor-core peak, but ~64 µs as
// the f32 FMA on CUDA cores this kernel uses, so its operations bound it.
// Design: 256 threads as a 16x16 grid, each computing a 4x4
// register tile of every [64 x 64] product (C·Bᵀ, W·x, C·S, Bᵀ·x), so one
// shared-memory load feeds four FMAs; rows are padded to an odd stride so
// the 16 columns a warp reads fall in distinct banks.  Plain FMA on CUDA
// cores; tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;          // chunk length
constexpr int THREADS = 256;   // a 16 x 16 thread grid

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, -60.f), 0.f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ d_skip,
    T* __restrict__ y, int S, int H, int P, int N) {
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
  for (int i = tid; i < N * P; i += THREADS) st[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < Q * P; i += THREADS) {
      const int r = i / P, p = i - r * P, t = s0 + r;
      xs[i] = t < S ? to_f32(x[(((size_t)b * S + t) * H + h) * P + p]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += THREADS) {
      const int r = i / N, n = i - r * N, t = s0 + r;
      const size_t off = ((size_t)b * S + t) * N + n;
      bs[r * ldn + n] = t < S ? to_f32(bm[off]) : 0.f;
      cs[r * ldn + n] = t < S ? to_f32(cm[off]) : 0.f;
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
          const float v = acc[r][c] + dec * acs[r][c] + dh * xs[i * P + p];
          store(y + (((size_t)b * S + t) * H + h) * P + p, v);
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

size_t smem_bytes(int P, int N) {
  return sizeof(float) *
         ((size_t)N * P + (size_t)Q * P + 2 * (size_t)Q * (N + 1) + (size_t)Q * (Q + 1) + 3 * Q);
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, const void* d_skip, void* y, int B, int S, int H,
           int P, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<dim3(H, B), THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)b, (const T*)c,
      (const float*)d_skip, (T*)y, S, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* d_skip,
                            void* y, int B, int S, int H, int P, int N,
                            void* stream) {
  return launch<float>(x, dt, a, b, c, d_skip, y, B, S, H, P, N, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a,
                             const void* b, const void* c, const void* d_skip,
                             void* y, int B, int S, int H, int P, int N,
                             void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, b, c, d_skip, y, B, S, H, P, N, stream);
}
