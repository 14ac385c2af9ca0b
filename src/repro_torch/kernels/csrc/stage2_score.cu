// Fused online stage-2 scoring, the speed layer's whole computation for a
// micro-batch of checkouts in one launch:
//
//   towers  e   = relu(e0 @ Wt[t] + bt[t]) on slots of type t   (typed only;
//                 every type's tower reads the ORIGINAL embedding e0)
//   tower   h   = relu(feats @ W_in + b_in + type_emb[ORDER]),
//                 then (L-1) x relu(h @ W_l + b_l)
//   agg     a   = masked mean over the K slots (gcn/sage), or masked
//                 single-head attention in z = e @ W space (gat, -1e9 mask)
//   combine g   = relu(h @ W_self + a @ W_nbr + b)     (gat: a + h @ W_self)
//   head    y   = MLP([g ; feats]), W0 split by rows so no concat is formed
//
// Replaces the TPU kernel src/repro/kernels/stage2_score.py::
// stage2_score_pallas (body _make_stage2_kernel).  The argument struct
// carries the weights in the order of flatten_stage2_params, the kernel ABI
// shared with the Pallas kernel.
//
// Bound on the H100: the launch and the chain of dependent layers.  At the
// main path's widths (H=64, F<=48, K=8, MLP 64/32) the weights are ~120 KB
// and a 16-row micro-batch adds ~40 KB of embeddings, a memory bound of
// ~50 ns; the FLOPs (~2 MFLOP) are below a microsecond on the f32 units.
// Design: one block of 256 threads per few rows (`rows`, 4 by default) of
// the micro-batch, so the ragged tail of any B is masked by the block
// itself.  Every activation lives in shared memory.  Each layer stages its
// weight matrix in shared memory (in row tiles when it does not fit whole)
// with asynchronous copies (cp.async: every copy of a tile is in flight at
// once, so a layer waits out one memory latency, not one per element), and
// a thread owns one output column for a group of rows, so each weight is
// read once per block and reused from a register across the rows.  The
// final width-1 MLP layer and the GAT a_src/a_dst projections are row
// reductions (warp shuffles).  All arithmetic is f32.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#define S2_MAX_MLP 8
#define S2_THREADS 256
#define S2_ACC 8
#define S2_WCAP_MAX 16384

struct S2Args {
  const float* emb;        // [B, K, H]
  const float* mask;       // [B, K]
  const float* feats;      // [B, F]
  const int* slot_type;    // [B, K] or null (untyped)
  const float* w_in;       // [F, H]
  const float* b_in;       // [H]
  const float* type_row;   // [H]
  const float* tower_w;    // [n_tower, H, H]
  const float* tower_b;    // [n_tower, H]
  const float* typed_w;    // [n_types, H, H] or null
  const float* typed_b;    // [n_types, H] or null
  const float* w_self;     // [H, H]
  const float* w_nbr;      // [H, H] (gcn/sage)
  const float* b_last;     // [H]
  const float* w_gat;      // [H, H] (gat)
  const float* a_src;      // [H]    (gat)
  const float* a_dst;      // [H]    (gat)
  const float* a_et;       // [1]    (gat)
  const float* w0g;        // [H, m0]
  const float* w0f;        // [F, m0]
  const float* b0;         // [m0]
  const float* mlp_w[S2_MAX_MLP];  // extra layer i+1: [m_i, m_{i+1}]
  const float* mlp_b[S2_MAX_MLP];
  float* out;              // [B]
  int mlp_dim[S2_MAX_MLP + 1];     // output width of MLP layer i
  int B, K, H, F, n_tower, n_types, gat, n_extra, rows, wcap;
};

namespace {

// Start dst[e] = src[e] for e < n by the whole block as asynchronous copies
// (cp.async), all in flight at once; copy_wait() completes them.
__device__ void copy_issue(float* dst, const float* __restrict__ src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    __pipeline_memcpy_async(dst + e, src + e, sizeof(float));
}

// Wait for this thread's copies, then make every thread's visible.
__device__ void copy_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// y[r, j] = act(add[r, j] + (x[r, :] @ W)[j] + b[j] + b2[j]) for r < nrows,
// skipping rows r with sel[r] != selv.  W is [in, out] row-major in global
// memory, staged through wsm (wcap floats) in tiles of whole rows.  Thread
// tid owns column tid % out for rows tid / out + G * q, q < ACC, so each
// weight read from shared memory feeds ACC rows.  y may alias add, never x.
// Called by every thread of the block (through dense()).
template <int ACC>
__device__ void dense_rows(const float* x, int nrows, int ldx, int in,
                           const float* __restrict__ W, int out,
                           const float* __restrict__ b,
                           const float* __restrict__ b2, const float* add,
                           int ldadd, float* y, int ldy, bool relu,
                           const int* sel, int selv, float* wsm, int wcap) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int G = nt / out;
  const int g = tid / out, j = tid - g * out;
  const bool active = g < G;
  const int ti = max(1, min(in, wcap / out));
  for (int rc = 0; rc < nrows; rc += G * ACC) {
    float acc[ACC];
#pragma unroll
    for (int q = 0; q < ACC; ++q) acc[q] = 0.f;
    for (int i0 = 0; i0 < in; i0 += ti) {
      const int ni = min(ti, in - i0);
      __syncthreads();
      copy_issue(wsm, W + (size_t)i0 * out, ni * out);
      copy_wait();
      if (active) {
#pragma unroll 8
        for (int i = 0; i < ni; ++i) {
          const float wv = wsm[i * out + j];
#pragma unroll
          for (int q = 0; q < ACC; ++q) {
            const int r = rc + g + G * q;
            if (r < nrows) acc[q] = fmaf(x[r * ldx + i0 + i], wv, acc[q]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < ACC; ++q) {
        const int r = rc + g + G * q;
        if (r < nrows && (sel == nullptr || sel[r] == selv)) {
          float v = acc[q];
          if (add != nullptr) v = add[r * ldadd + j] + v;
          if (b != nullptr) v += b[j];
          if (b2 != nullptr) v += b2[j];
          y[r * ldy + j] = relu ? fmaxf(v, 0.f) : v;
        }
      }
    }
  }
  __syncthreads();
}

// dense_rows with as few accumulators per thread as the rows need (the
// choice is uniform across the block, so its barriers stay uniform).
__device__ void dense(const float* x, int nrows, int ldx, int in,
                      const float* __restrict__ W, int out,
                      const float* __restrict__ b,
                      const float* __restrict__ b2, const float* add,
                      int ldadd, float* y, int ldy, bool relu, const int* sel,
                      int selv, float* wsm, int wcap) {
  const int G = blockDim.x / out;
  const int per = (nrows + G - 1) / G;
  if (per <= 1)
    dense_rows<1>(x, nrows, ldx, in, W, out, b, b2, add, ldadd, y, ldy, relu,
                  sel, selv, wsm, wcap);
  else if (per <= 2)
    dense_rows<2>(x, nrows, ldx, in, W, out, b, b2, add, ldadd, y, ldy, relu,
                  sel, selv, wsm, wcap);
  else if (per <= 4)
    dense_rows<4>(x, nrows, ldx, in, W, out, b, b2, add, ldadd, y, ldy, relu,
                  sel, selv, wsm, wcap);
  else
    dense_rows<S2_ACC>(x, nrows, ldx, in, W, out, b, b2, add, ldadd, y, ldy,
                       relu, sel, selv, wsm, wcap);
}

// y[r] = x[r, :n] . v for r < nrows: one warp per row, shuffle reduction.
__device__ void rowdot(const float* x, int nrows, int ldx, int n,
                       const float* __restrict__ v, float* y) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < nrows; r += nw) {
    float s = 0.f;
    for (int i = lane; i < n; i += 32) s = fmaf(x[r * ldx + i], v[i], s);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) y[r] = s;
  }
  __syncthreads();
}

// agg[r, c] = sum_k e[(r*K + k), c] * wk[r*K + k]
__device__ void slot_sum(const float* e, const float* wk, int R, int K, int H,
                         float* agg, int ldagg) {
  for (int t = threadIdx.x; t < R * H; t += blockDim.x) {
    const int r = t / H, c = t - r * H;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      acc = fmaf(e[(r * K + k) * H + c], wk[r * K + k], acc);
    agg[r * ldagg + c] = acc;
  }
  __syncthreads();
}

__host__ __device__ int widest(const S2Args& a) {
  int w = a.H > a.F ? a.H : a.F;
  for (int i = 0; i <= a.n_extra; ++i) w = a.mlp_dim[i] > w ? a.mlp_dim[i] : w;
  return w;
}

// Shared-memory floats for a block of `rows` rows; the carve in the kernel
// follows the same order.
__host__ __device__ size_t smem_floats(const S2Args& a, int rows) {
  const size_t rk = (size_t)rows * a.K;
  const size_t n_emb = 1 + (a.typed_w != nullptr) + (a.gat != 0);
  return (size_t)rows * a.F + 3 * (size_t)rows * widest(a) +
         n_emb * rk * a.H + 4 * rk + 2 * (size_t)rows + a.wcap;
}

__global__ void __launch_bounds__(S2_THREADS) stage2_kernel(S2Args a) {
  extern __shared__ float sm[];
  const int r0 = blockIdx.x * a.rows;
  const int R = min(a.rows, a.B - r0);
  const int K = a.K, H = a.H, F = a.F, W = widest(a);
  const int RK = R * K;
  const int rk_cap = a.rows * K;
  const bool typed = a.typed_w != nullptr;

  float* feats_s = sm;
  float* hA = feats_s + a.rows * F;
  float* hB = hA + a.rows * W;
  float* hC = hB + a.rows * W;
  float* e0 = hC + a.rows * W;
  float* e1 = e0 + rk_cap * H;
  float* zb = e1 + (typed ? rk_cap * H : 0);
  float* mask_s = zb + (a.gat ? rk_cap * H : 0);
  float* wk_s = mask_s + rk_cap;
  float* ssrc = wk_s + rk_cap;
  float* rv1 = ssrc + rk_cap;
  float* rv2 = rv1 + a.rows;
  int* st_s = (int*)(rv2 + a.rows);
  float* wsm = (float*)(st_s + rk_cap);

  for (int e = threadIdx.x; e < RK; e += blockDim.x)
    st_s[e] = a.slot_type != nullptr ? a.slot_type[(size_t)r0 * K + e] : -1;
  copy_issue(feats_s, a.feats + (size_t)r0 * F, R * F);
  copy_issue(mask_s, a.mask + (size_t)r0 * K, RK);
  copy_issue(e0, a.emb + (size_t)r0 * K * H, RK * H);
  copy_wait();

  // ---- per-type entity towers, each over the original embedding ----
  const float* ent = e0;
  if (typed) {
    for (int e = threadIdx.x; e < RK * H; e += blockDim.x) e1[e] = e0[e];
    for (int t = 0; t < a.n_types; ++t)
      dense(e0, RK, H, H, a.typed_w + (size_t)t * H * H, H,
            a.typed_b + (size_t)t * H, nullptr, nullptr, 0, e1, H, true, st_s,
            t, wsm, a.wcap);
    ent = e1;
  }

  // ---- order tower: input projection + stage-1 self transforms ----
  float* h = hA;
  float* hs = hB;
  dense(feats_s, R, F, F, a.w_in, H, a.b_in, a.type_row, nullptr, 0, h, W,
        true, nullptr, 0, wsm, a.wcap);
  for (int l = 0; l < a.n_tower; ++l) {
    dense(h, R, W, H, a.tower_w + (size_t)l * H * H, H,
          a.tower_b + (size_t)l * H, nullptr, nullptr, 0, hs, W, true, nullptr,
          0, wsm, a.wcap);
    float* t = h; h = hs; hs = t;
  }

  // ---- masked aggregation over the K slots + last-layer combine ----
  float* agg = hs;
  float* g = hC;
  if (!a.gat) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float cnt = 0.f;
      for (int k = 0; k < K; ++k) cnt += mask_s[r * K + k];
      cnt = fmaxf(cnt, 1.f);
      for (int k = 0; k < K; ++k) wk_s[r * K + k] = mask_s[r * K + k] / cnt;
    }
    __syncthreads();
    slot_sum(ent, wk_s, R, K, H, agg, W);
    dense(h, R, W, H, a.w_self, H, nullptr, nullptr, nullptr, 0, g, W, false,
          nullptr, 0, wsm, a.wcap);
    dense(agg, R, W, H, a.w_nbr, H, a.b_last, nullptr, g, W, g, W, true,
          nullptr, 0, wsm, a.wcap);
  } else {
    dense(ent, RK, H, H, a.w_gat, H, nullptr, nullptr, nullptr, 0, zb, H,
          false, nullptr, 0, wsm, a.wcap);
    dense(h, R, W, H, a.w_gat, H, nullptr, nullptr, nullptr, 0, agg, W, false,
          nullptr, 0, wsm, a.wcap);
    rowdot(agg, R, W, H, a.a_dst, rv1);   // s_dst
    rowdot(zb, RK, H, H, a.a_src, ssrc);  // s_src
    const float aet = a.a_et[0];
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float* lg = wk_s + r * K;
      const float* mk = mask_s + r * K;
      float m = -INFINITY;
      for (int k = 0; k < K; ++k) {
        float x = ssrc[r * K + k] + rv1[r] + aet;
        x = x >= 0.f ? x : 0.2f * x;
        x = mk[k] > 0.f ? x : -1e9f;
        lg[k] = x;
        m = fmaxf(m, x);
      }
      float s = 0.f;
      for (int k = 0; k < K; ++k) {
        lg[k] = expf(lg[k] - m);
        s += lg[k];
      }
      for (int k = 0; k < K; ++k) lg[k] = lg[k] / s * mk[k];
    }
    __syncthreads();
    slot_sum(zb, wk_s, R, K, H, agg, W);
    dense(h, R, W, H, a.w_self, H, nullptr, nullptr, nullptr, 0, g, W, false,
          nullptr, 0, wsm, a.wcap);
    for (int t = threadIdx.x; t < R * H; t += blockDim.x) {
      const int r = t / H, c = t - r * H;
      g[r * W + c] = fmaxf(agg[r * W + c] + g[r * W + c] + a.b_last[c], 0.f);
    }
    __syncthreads();
  }

  // ---- risk head: MLP([g ; feats]) with W0 split by rows ----
  const int m0 = a.mlp_dim[0];
  if (a.n_extra == 0 && m0 == 1) {
    rowdot(g, R, W, H, a.w0g, rv1);
    rowdot(feats_s, R, F, F, a.w0f, rv2);
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      a.out[r0 + r] = rv1[r] + rv2[r] + a.b0[0];
    return;
  }
  float* y = h;
  float* ys = hs;
  dense(g, R, W, H, a.w0g, m0, nullptr, nullptr, nullptr, 0, y, W, false,
        nullptr, 0, wsm, a.wcap);
  dense(feats_s, R, F, F, a.w0f, m0, a.b0, nullptr, y, W, y, W,
        a.n_extra > 0, nullptr, 0, wsm, a.wcap);
  for (int i = 1; i <= a.n_extra; ++i) {
    const int in = a.mlp_dim[i - 1], out = a.mlp_dim[i];
    const bool last = i == a.n_extra;
    if (last && out == 1) {
      rowdot(y, R, W, in, a.mlp_w[i - 1], rv1);
      for (int r = threadIdx.x; r < R; r += blockDim.x)
        a.out[r0 + r] = rv1[r] + a.mlp_b[i - 1][0];
      return;
    }
    dense(y, R, W, in, a.mlp_w[i - 1], out, a.mlp_b[i - 1], nullptr, nullptr,
          0, ys, W, !last, nullptr, 0, wsm, a.wcap);
    float* t = y; y = ys; ys = t;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) a.out[r0 + r] = y[r * W];
}

int max_matrix_floats(const S2Args& a) {
  const int H = a.H;
  int m = a.F * H > H * H ? a.F * H : H * H;
  const int m0 = a.mlp_dim[0];
  m = H * m0 > m ? H * m0 : m;
  m = a.F * m0 > m ? a.F * m0 : m;
  for (int i = 1; i <= a.n_extra; ++i) {
    const int s = a.mlp_dim[i - 1] * a.mlp_dim[i];
    m = s > m ? s : m;
  }
  return m;
}

}  // namespace

extern "C" int stage2_score_f32(const S2Args* args, void* stream) {
  S2Args a = *args;
  if (a.B <= 0 || a.K <= 0 || a.H <= 0 || a.F <= 0 || a.rows <= 0 ||
      a.n_tower < 0 || a.n_extra < 0 || a.n_extra >= S2_MAX_MLP ||
      a.H > S2_THREADS)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= a.n_extra; ++i)
    if (a.mlp_dim[i] <= 0 || a.mlp_dim[i] > S2_THREADS)
      return (int)cudaErrorInvalidValue;
  int cap = max_matrix_floats(a);
  cap = cap < S2_WCAP_MAX ? cap : S2_WCAP_MAX;
  a.wcap = cap > S2_THREADS ? cap : S2_THREADS;

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  size_t bytes = 0;
  while (a.rows > 0) {
    bytes = smem_floats(a, a.rows) * sizeof(float);
    if (bytes <= (size_t)optin) break;
    a.rows /= 2;
  }
  if (a.rows == 0) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(stage2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + a.rows - 1) / a.rows);
  stage2_kernel<<<grid, S2_THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
