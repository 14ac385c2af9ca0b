// Fused online stage-2 scoring, the speed layer's whole computation for a
// micro-batch of checkouts in one launch:
//
//   towers  e   = relu(e0 @ Wt[t] + bt[t]) on slots of type t   (typed only;
//                 every type's tower reads the ORIGINAL embedding e0)
//   tower   h   = relu(feats @ W_in + b_in + type_emb[ORDER]),
//                 then (L-1) x relu(h @ W_l + b_l)
//   agg     a   = masked mean over the K slots (gcn/sage), or masked
//                 single-head attention (gat, -1e9 mask): scores
//                 e_k . (W a_src) + h . (W a_dst), weights on the e_k
//   combine g   = relu([h | a] @ [W_self; W_nbr] + b)   (gat: W_nbr = W)
//   head    y   = MLP([g | feats])
//
// Replaces the TPU kernel src/repro/kernels/stage2_score.py::
// stage2_score_pallas (body _make_stage2_kernel).  The weights come packed
// once per model by kernels/stage2_score.py::pack_stage2_params: a vector
// region (biases, GAT's score vectors), then every weight matrix in
// the order this kernel consumes it, each on a 16-byte boundary.  The
// shared-memory plan (rows per block, resident or streamed, tile sizes,
// bytes) comes from stage2_plan in the same file, through the argument
// struct, with each layer's row of the matrix table (S2Seg).
//
// Bound on the H100: the chain of dependent layers.  At the main path's
// widths (H=64, F=12, K=8, MLP 64/32, 3 GNN layers) the weights are ~100 KB
// and a 16-row micro-batch adds ~35 KB of embeddings, a memory bound of
// ~40 ns, and the FLOPs (~1 MFLOP) are far below a microsecond; every layer
// waits for the one before it, and what one warp does between two layers
// (addresses, a butterfly, the epilogue) is a serial chain of instructions.
// The design:
//  * One thread issues a bulk copy (TMA, cp.async.bulk) of every matrix
//    into shared memory at the start, each completing on its own mbarrier,
//    so a layer waits only for its own weights while the later ones are
//    still arriving.  Where the matrices do not fit together, they stream
//    in tiles of whole rows through a ring of stages; a tile goes in when
//    every warp is done with the tile before it in the same stage (the
//    phase bit of a stage's barrier flips on every reuse).
//  * One warp per row of the micro-batch, so no block barrier sits between
//    two layers (only between two tiles of the ring); the block's warps
//    share the weights.  A lane owns column quads (one 16-byte load of a
//    weight row feeds 4 FMAs per row) and `slices` lanes split each dot
//    product, summed by a shuffle butterfly, so no lane runs a long chain
//    of dependent FMAs.  The slot rows of the typed towers go up to 8 at a
//    time, each weight reused from a register.
//  * Two products are merged by stacking their weights in the pack (the
//    combine's h and agg, the head's g and feats): fewer layers.  GAT's
//    projection moves past the attention sum (sum_k w_k (e_k W) =
//    (sum_k w_k e_k) W, and its scores use W a_src and W a_dst from the
//    pack), so it projects one row, not K + 1, in the combine.  The typed
//    towers run only the slots of their type.
//  * A row's arithmetic (slices, order of the sums, tiles) depends on the
//    widths alone, never on B or on the row's place in its block, so a
//    request's score is the same bits at any batch size.
// All arithmetic is f32.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

#define S2_MAX_ROWS 4  // warps per block, one row of the micro-batch each

// What a layer reads and writes; the kernel's loop over the layers picks
// its buffers and the work between layers by it.
enum S2Role {
  S2_TYPED = 0,  // one type's entity tower: slot rows of that type
  S2_INPUT,      // order tower input projection
  S2_TOWER,      // order tower self transform
  S2_COMBINE,    // [h | agg] @ [W_self; W_nbr]
  S2_HEAD,       // [g | feats] @ W0
  S2_MLP,        // the head's later layers
};

struct S2Seg {
  int off;          // floats into the pack
  int rows, cols, stride;
  int slices;       // lanes that share one output's dot product (4, 8, 16 or 32)
  int tile;         // rows per tile (rows itself when resident)
  int bias, bias2;  // the layer's biases: floats into the pack, or -1
  int relu;
  int role;         // S2Role
  int quads;        // column quads (4 columns) a lane owns per pass: 1, 2 or 4
};

struct S2Args {
  const float* emb;        // [B, K, H]
  const float* mask;       // [B, K]
  const float* feats;      // [B, F]
  const int* slot_type;    // [B, K] or null (untyped)
  const float* pack;       // pack_stage2_params' buffer
  float* out;              // [B]
  const int* table;        // S2Seg of every layer, in the order they are consumed
  int seg0_floats;         // size of the first matrix (it follows the vectors)
  int v_u_src, v_u_dst, v_a_et;  // GAT's score vectors W a_src, W a_dst and a_et
  int B, K, H, F, gat, ld, n_seg;
  int vec_floats, mat_floats;
  int rows, act_floats, whole, depth, stage_floats, n_tiles, smem_bytes;
};

namespace {

// ---- mbarriers and bulk copies (TMA, 1-D) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of copies, then the copy itself.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait for the phase `parity` of the barrier to complete.  A wait that
// never ends (a wrong phase or byte count) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned addr = smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}

// The weight stream.  Tile k of the n_tiles goes into stage k % depth and
// completes phase (k / depth) & 1 of barrier 1 + k % depth (barrier 0 is
// the vector region's).  Resident (whole): depth = n_tiles, one tile per
// matrix, at the matrix's own place, all issued at the start.  Thread 0
// issues; every thread consumes, in the same order.  Every function here
// is inlined into the kernel, so the stream lives in registers.
struct Stream {
  const float* pack;
  float* mats;             // the matrix region (whole) or the ring
  uint64_t* bar;
  const S2Seg* seg;        // the matrix table, in shared memory
  int depth, stage_floats, vec_floats, n_tiles, whole;
  int slot, phase;         // the next tile to consume: its stage and phase
  int p_k, p_seg, p_row;   // producer cursor (thread 0 only)
};

__device__ __forceinline__ void produce(Stream& s) {
  const S2Seg& g = s.seg[s.p_seg];
  const int n = min(g.tile, g.rows - s.p_row);
  const int slot = s.p_k % s.depth;
  bulk_load(s.mats + slot * s.stage_floats, s.pack + g.off + (size_t)s.p_row * g.stride,
            (unsigned)(n * g.stride * sizeof(float)), s.bar + 1 + slot);
  ++s.p_k;
  s.p_row += n;
  if (s.p_row >= g.rows) {
    s.p_row = 0;
    ++s.p_seg;
  }
}

// Wait for the next tile of matrix g; returns where it lies.
__device__ __forceinline__ const float* tile_wait(Stream& s, const S2Seg& g) {
  mbar_wait(s.bar + 1 + s.slot, s.phase);
  return s.whole ? s.mats + (g.off - s.vec_floats) : s.mats + s.slot * s.stage_floats;
}

// Every thread is done with the tile: thread 0 refills its stage with the
// tile `depth` further on.
__device__ __forceinline__ void tile_release(Stream& s) {
  if (!s.whole) {  // every warp is done with the stage before it is refilled
    __syncthreads();
    if (threadIdx.x == 0 && s.p_k < s.n_tiles) produce(s);
  }
  if (++s.slot == s.depth) {
    s.slot = 0;
    s.phase ^= 1;
  }
}

// Rows rc .. rc+NR-1 (clamped to nr; only those below nr are stored) of
// one warp's layer over one tile w of rows [i0, i0 + ni) of W: see wdense.
// Every pointer here is to shared memory and none aliases another but y
// (read back for the sums of earlier tiles), so the biases and x can be
// loaded ahead of the stores.
template <int QL, int NR>
__device__ __noinline__ void wrows(const float* __restrict__ w, int cols, int stride, int slices,
                                   int flags, int i0, int ni, int q0,
                                   const float* __restrict__ x, int ldx, float* y, int ldy,
                                   const int* __restrict__ ridx, int rc, int nr,
                                   const float* __restrict__ b, const float* __restrict__ b2) {
  const bool first = flags & 1, last = flags & 2, relu = flags & 4;
  const int lane = threadIdx.x & 31;
  const int ls = 31 - __clz(slices), CL = 32 >> ls;  // slices and column lanes, powers of 2
  const int c = lane & (CL - 1), s = lane >> (5 - ls);
  const int quads = (cols + 3) >> 2;
  const float* xr[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int row = min(rc + q, nr - 1);
    xr[q] = x + (ridx != nullptr ? ridx[row] : row) * ldx + i0;
  }
  int j0[QL];
  float4 bias[QL], bias2[QL];
#pragma unroll
  for (int p = 0; p < QL; ++p) {
    j0[p] = 4 * min(q0 + c + CL * p, quads - 1);
    bias[p] = bias2[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (last && b != nullptr) bias[p] = *reinterpret_cast<const float4*>(b + j0[p]);
    if (last && b2 != nullptr) bias2[p] = *reinterpret_cast<const float4*>(b2 + j0[p]);
  }
  float4 acc[NR][QL];
#pragma unroll
  for (int q = 0; q < NR; ++q)
#pragma unroll
    for (int p = 0; p < QL; ++p) acc[q][p] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = s; i < ni; i += slices) {
    float4 wv[QL];
#pragma unroll
    for (int p = 0; p < QL; ++p) wv[p] = *reinterpret_cast<const float4*>(w + i * stride + j0[p]);
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const float xv = xr[q][i];
#pragma unroll
      for (int p = 0; p < QL; ++p) {
        acc[q][p].x = fmaf(xv, wv[p].x, acc[q][p].x);
        acc[q][p].y = fmaf(xv, wv[p].y, acc[q][p].y);
        acc[q][p].z = fmaf(xv, wv[p].z, acc[q][p].z);
        acc[q][p].w = fmaf(xv, wv[p].w, acc[q][p].w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {  // the butterfly over the slices: lane bits 4 down to log2(CL)
    const int m = 16 >> k;
    if (m < CL) break;
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int p = 0; p < QL; ++p) {
        acc[q][p].x += __shfl_xor_sync(0xffffffffu, acc[q][p].x, m);
        acc[q][p].y += __shfl_xor_sync(0xffffffffu, acc[q][p].y, m);
        acc[q][p].z += __shfl_xor_sync(0xffffffffu, acc[q][p].z, m);
        acc[q][p].w += __shfl_xor_sync(0xffffffffu, acc[q][p].w, m);
      }
  }
  // every slice lane holds the sums; lane s stores the rows q = s (mod slices)
  const bool vec4 = (ldy & 3) == 0 && (reinterpret_cast<size_t>(y) & 15) == 0;
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int r = rc + q;
    if ((q & (slices - 1)) != s || r >= nr) continue;
    float* yr = y + (ridx != nullptr ? ridx[r] : r) * ldy;
#pragma unroll
    for (int p = 0; p < QL; ++p) {
      if (q0 + c + CL * p >= quads) break;
      const int j = j0[p];
      float4 o = acc[q][p];
      if (vec4 && j + 3 < cols) {
        if (!first) {
          const float4 t = *reinterpret_cast<const float4*>(yr + j);
          o.x = t.x + o.x, o.y = t.y + o.y, o.z = t.z + o.z, o.w = t.w + o.w;
        }
        if (last) {
          o.x += bias[p].x, o.y += bias[p].y, o.z += bias[p].z, o.w += bias[p].w;
          o.x += bias2[p].x, o.y += bias2[p].y, o.z += bias2[p].z, o.w += bias2[p].w;
          if (relu) o.x = fmaxf(o.x, 0.f), o.y = fmaxf(o.y, 0.f), o.z = fmaxf(o.z, 0.f),
                    o.w = fmaxf(o.w, 0.f);
        }
        *reinterpret_cast<float4*>(yr + j) = o;
      } else {
        const float ov[4] = {o.x, o.y, o.z, o.w};
        const float bv[4] = {bias[p].x, bias[p].y, bias[p].z, bias[p].w};
        const float bv2[4] = {bias2[p].x, bias2[p].y, bias2[p].z, bias2[p].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e >= cols) break;
          float v = ov[e];
          if (!first) v = yr[j + e] + v;
          if (last) {
            v += bv[e];
            v += bv2[e];
            if (relu) v = fmaxf(v, 0.f);
          }
          yr[j + e] = v;
        }
      }
    }
  }
}

// One warp's layer: y[q, :] = act(x[q, :] @ W + b + b2) for the warp's nr
// rows q (row q at x + idx(q) * ldx, idx(q) = ridx[q], or q without ridx),
// W the next matrix of the stream.  Lane layout: lane = c + CL * s, with CL
// = 32 / slices column lanes, each owning QL column quads per pass (one
// 16-byte load of a weight row feeds 4 FMAs per row), and `slices` lanes
// sharing each dot product: slice s sums terms i = s, s + slices, ... of
// the tile in order, and a butterfly over the slices adds them in a fixed
// order.  A lane keeps NR rows' sums at a time, reusing each weight from a
// register; rows past the last full group of NR go one at a time, with the
// same sums.  Nothing depends on the batch: a row's sums are the same in
// any block, at any place.  With several tiles the sums of the earlier ones
// wait in y.  y never aliases x.
template <int QL, int NR>
__device__ __forceinline__ void wdense(Stream& st, const S2Seg& g, const float* x, int ldx,
                                       float* y, int ldy, const int* ridx, int nr,
                                       const float* b, const float* b2) {
  const int quads = (g.cols + 3) >> 2, per_pass = (32 >> (31 - __clz(g.slices))) * QL;
  for (int i0 = 0; i0 < g.rows; i0 += g.tile) {
    const int ni = min(g.tile, g.rows - i0);
    const float* w = tile_wait(st, g);
    const bool first = i0 == 0, last = i0 + ni >= g.rows;
    const int flags = first | last << 1 | (g.relu != 0) << 2;
    for (int q0 = 0; q0 < quads; q0 += per_pass) {
      int rc = 0;
      for (; rc + NR <= nr; rc += NR)
        wrows<QL, NR>(w, g.cols, g.stride, g.slices, flags, i0, ni, q0, x, ldx, y, ldy, ridx,
                      rc, nr, b, b2);
      for (; rc < nr; ++rc)
        wrows<QL, 1>(w, g.cols, g.stride, g.slices, flags, i0, ni, q0, x, ldx, y, ldy, ridx,
                     rc, nr, b, b2);
    }
    __syncwarp();
    tile_release(st);
  }
}

// wdense for the layer's rows (up to 8 at a time when `many`) and column
// quads per lane (g.quads); the kernel's one call site.
__device__ __forceinline__ void layer(Stream& st, const S2Seg& g, bool many, const float* x,
                                      int ldx, float* y, int ldy, const int* ridx, int nr,
                                      const float* b, const float* b2) {
  if (many) {
    if (g.quads == 1)
      wdense<1, 8>(st, g, x, ldx, y, ldy, ridx, nr, b, b2);
    else
      wdense<2, 8>(st, g, x, ldx, y, ldy, ridx, nr, b, b2);
  } else if (g.quads == 1) {
    wdense<1, 1>(st, g, x, ldx, y, ldy, ridx, nr, b, b2);
  } else if (g.quads == 2) {
    wdense<2, 1>(st, g, x, ldx, y, ldy, ridx, nr, b, b2);
  } else {
    wdense<4, 1>(st, g, x, ldx, y, ldy, ridx, nr, b, b2);
  }
}

// sum of f(k) for k < n over the warp: each lane sums k = lane, lane + 32,
// ... in order, then a butterfly in a fixed order; every lane gets the sum.
template <typename Fn>
__device__ __forceinline__ float warp_sum(int n, Fn f) {
  float v = 0.f;
  for (int k = threadIdx.x & 31; k < n; k += 32) v += f(k);
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sc[k] = e[k, :] . u_src for k < K and sc[K] = h . u_dst, by one warp:
// 4 lanes per row, each summing every 4th term in order, then a butterfly
// over the 4.
__device__ __forceinline__ void gat_scores(const float* e, const float* h, const float* u_src,
                                           const float* u_dst, int K, int H, float* sc) {
  const int lane = threadIdx.x & 31, part = lane & 3;
  for (int k0 = 0; k0 <= K; k0 += 8) {
    const int k = min(k0 + (lane >> 2), K);
    const float* row = k < K ? e + k * H : h;
    const float* u = k < K ? u_src : u_dst;
    float v = 0.f;
    for (int i = part; i < H; i += 4) v = fmaf(row[i], u[i], v);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (part == 0 && k0 + (lane >> 2) <= K) sc[k] = v;
  }
  __syncwarp();
}

// agg[c] = sum_k e[k*H + c] * wk[k], one row, by one warp
__device__ __forceinline__ void slot_sum(const float* e, const float* wk, int K, int H,
                                         float* agg) {
  for (int c = threadIdx.x & 31; c < H; c += 32) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(e[k * H + c], wk[k], acc);
    agg[c] = acc;
  }
  __syncwarp();
}

// One warp per row of the micro-batch; the block's warps share the weights.
__global__ void __launch_bounds__(32 * S2_MAX_ROWS, 1)
    stage2_kernel(const __grid_constant__ S2Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, H = a.H, F = a.F, ld = a.ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * a.rows + warp;
  const int r = min(row, a.B - 1);  // a warp past B repeats the last row and stores nothing
  const bool typed = a.slot_type != nullptr;

  // carve: barriers, the matrix table, vectors, matrices (or the ring),
  // then each warp's activations; the same order and sizes as stage2_plan
  const int head = (((a.depth + 1) * 8 + 15) & ~15);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  S2Seg* seg_s = reinterpret_cast<S2Seg*>(smem + head);
  float* vec = reinterpret_cast<float*>(smem + head + ((a.n_seg * (int)sizeof(S2Seg) + 15) & ~15));
  float* mats = vec + a.vec_floats;
  float* xa = mats + (a.whole ? a.mat_floats : a.depth * a.stage_floats) + warp * a.act_floats;
  float* xb = xa + ld;
  float* xc = xb + ld;  // [g | feats]
  float* e0 = xc + ld;
  float* e1 = e0 + K * H;
  float* sd = e1 + (typed ? K * H : 0);  // GAT's scores
  float* mask_s = sd + (a.gat ? K + 1 : 0);
  float* wk = mask_s + K;
  int* st_s = reinterpret_cast<int*>(wk + K);
  int* ridx = st_s + K;  // the typed towers' slot list

  Stream st{a.pack, mats, bar, seg_s, a.depth, a.stage_floats, a.vec_floats, a.n_tiles,
            a.whole, 0, 0, 0, 0, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i <= a.depth; ++i) mbar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(vec, a.pack, (unsigned)(a.vec_floats * sizeof(float)), bar);
    if (a.whole)  // the first matrix now; the rest once the table is in shared memory
      bulk_load(mats, a.pack + a.vec_floats, (unsigned)(a.seg0_floats * sizeof(float)), bar + 1);
  }
  // the matrix table into shared memory, from its copy in device memory, and
  // this warp's row: asynchronous copies, all in flight at once
  for (int e = threadIdx.x; e < a.n_seg * (int)(sizeof(S2Seg) / sizeof(int)); e += blockDim.x)
    __pipeline_memcpy_async(reinterpret_cast<int*>(seg_s) + e, a.table + e, sizeof(int));
  for (int e = lane; e < F; e += 32)
    __pipeline_memcpy_async(xc + H + e, a.feats + (size_t)r * F + e, sizeof(float));
  for (int e = lane; e < K; e += 32) {
    __pipeline_memcpy_async(mask_s + e, a.mask + (size_t)r * K + e, sizeof(float));
    if (typed) __pipeline_memcpy_async(st_s + e, a.slot_type + (size_t)r * K + e, sizeof(int));
    else st_s[e] = -1;
  }
  for (int e = lane; e < K * H; e += 32)
    __pipeline_memcpy_async(e0 + e, a.emb + (size_t)r * K * H + e, sizeof(float));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (a.whole) {
      for (int i = 1; i < a.n_seg; ++i)
        bulk_load(mats + (seg_s[i].off - a.vec_floats), a.pack + seg_s[i].off,
                  (unsigned)(seg_s[i].rows * seg_s[i].stride * sizeof(float)), bar + 1 + i);
      st.p_k = a.n_tiles;
    } else {  // the ring's first stages
      while (st.p_k < min(a.depth, a.n_tiles)) produce(st);
    }
  }
  mbar_wait(bar, 0);

  // ---- the chain: one pass over the layers, each picking its buffers ----
  float* h = xa;    // order tower
  float* hs = xb;
  float* ent = e0;  // slot embeddings after the typed towers
  int typ = 0;
  for (int li = 0; li < a.n_seg; ++li) {
    const S2Seg g = seg_s[li];
    const float* x = h;  // the order tower's default: h -> hs
    float* y = hs;
    int ldx = 0, ldy = 0, nr = 1;
    const int* rows = nullptr;
    bool many = false;
    switch (g.role) {
      case S2_TYPED:  // the slots of one type; every type's tower reads e0
        if (typ == 0) {
          for (int e = lane; e < K * H; e += 32) e1[e] = e0[e];
          ent = e1;
        }
        nr = 0;  // the slots of this type, in order
        for (int k0 = 0; k0 < K; k0 += 32) {
          const bool mine = k0 + lane < K && st_s[k0 + lane] == typ;
          const unsigned m = __ballot_sync(0xffffffffu, mine);
          if (mine) ridx[nr + __popc(m & ((1u << lane) - 1u))] = k0 + lane;
          nr += __popc(m);
        }
        __syncwarp();
        x = e0, ldx = H, y = e1, ldy = H, rows = ridx, many = true;
        ++typ;
        break;
      case S2_INPUT:
        x = xc + H, y = h;
        break;
      case S2_COMBINE:  // h's row becomes [h | masked mean or attention sum of the slots]
        if (a.gat) {  // masked softmax of the scores, a slot per lane
          gat_scores(ent, h, vec + a.v_u_src, vec + a.v_u_dst, K, H, sd);
          const float aet = vec[a.v_a_et], s_dst = sd[K];
          for (int k = lane; k < K; k += 32) {
            float v = sd[k] + s_dst + aet;
            v = v >= 0.f ? v : 0.2f * v;
            wk[k] = mask_s[k] > 0.f ? v : -1e9f;
          }
          __syncwarp();
          float m = -INFINITY;
          for (int k = lane; k < K; k += 32) m = fmaxf(m, wk[k]);
          for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          for (int k = lane; k < K; k += 32) wk[k] = expf(wk[k] - m);
          __syncwarp();
          const float sum = warp_sum(K, [&](int k) { return wk[k]; });
          for (int k = lane; k < K; k += 32) wk[k] = wk[k] / sum * mask_s[k];
        } else {
          const float cnt = fmaxf(warp_sum(K, [&](int k) { return mask_s[k]; }), 1.f);
          for (int k = lane; k < K; k += 32) wk[k] = mask_s[k] / cnt;
        }
        __syncwarp();
        slot_sum(ent, wk, K, H, h + H);
        y = xc;  // g into xc: [g | feats]
        break;
      case S2_HEAD:
        x = xc, y = xa, h = xa, hs = xb;
        break;
      default:  // S2_TOWER, S2_MLP
        break;
    }
    layer(st, g, many, x, ldx, y, ldy, rows, nr, g.bias >= 0 ? vec + g.bias : nullptr,
          g.bias2 >= 0 ? vec + g.bias2 : nullptr);
    if (g.role == S2_TOWER || g.role == S2_MLP) {
      float* t = h;
      h = hs;
      hs = t;
    }
  }
  if (lane == 0 && row < a.B) a.out[row] = h[0];
}

}  // namespace

// Allow up to `bytes` of dynamic shared memory (above 48 KB needs the
// opt-in); called once per card by the wrapper.
extern "C" int stage2_score_configure(int bytes) {
  return (int)cudaFuncSetAttribute(stage2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

extern "C" int stage2_score_f32(const S2Args* args, void* stream) {
  const S2Args& a = *args;
  if (a.B <= 0 || a.K <= 0 || a.rows <= 0 || a.rows > S2_MAX_ROWS || a.n_seg <= 0 ||
      a.depth <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.B + a.rows - 1) / a.rows);
  stage2_kernel<<<grid, 32 * a.rows, a.smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
