// Rotary position embedding (rotate-half RoPE) of one tensor, one launch:
//
//     y[b, h, s, i]        = x1 * cos(a) - x2 * sin(a)
//     y[b, h, s, i + Dh/2] = x2 * cos(a) + x1 * sin(a)
//
// with x1 = x[b, h, s, i], x2 = x[b, h, s, i + Dh/2], a = (pos0 + s) * freq[i]
// for i < Dh/2, in f32, rounded once to x's type.  With `inverse` the sine
// is negated: the rotation by -a, which is the rotation's gradient (it is
// orthogonal).
//
// Replaces no TPU kernel: the reference leaves RoPE to XLA, which fuses it.
// Its plain version, kernels/ref.py::rope_ref (models/common.py::apply_rope
// over positions pos0 .. pos0 + S - 1), is an eager chain of ~17 kernels
// through f32 temporaries a call.
//
// Bound on the H100: memory.  At granite-3-2b's prefill (q: B=4, 32 heads,
// S=2,048, Dh 64, bf16) a call reads and writes 33.5 MB each, ~20 µs at
// 3.35 TB/s; the angles' cosines and sines are ~4 FLOP a byte if each
// element computed its own.
// Design: a thread owns V consecutive pairs (16 bytes of x1 and of x2, one
// vector load each) of one position for ROWS (batch, head) rows: it issues
// the 2 * ROWS loads, computes its V angles, cosines and sines while they
// are in flight, then rotates and stores.  So the trigonometry is done once
// per ROWS rows, and a warp reads whole 128-byte lines.  ROWS = 2 keeps the
// bf16 kernel at 64 registers (4 blocks an SM): at granite's q shape it
// took 30.3 µs on the H100 (66% of the bytes bound) against 33.3 µs at ROWS = 4 (103
// registers), 42.5 µs at 8, and 54.6 µs at 4 held to 64 registers (local
// memory).  x is read through its strides (the
// projection's [B, S, H, Dh] seen as [B, H, S, Dh]) and y written through
// its own (contiguous in the forward; in the backward the layout x came in).
// Bits: the plain chain on the card rounds the angle once (float(p) * freq),
// takes CUDA's accurate cosf/sinf (PyTorch's cos and sin kernels), rounds
// each product and the difference or sum, then rounds to the output type;
// the kernel spells each rounding with __fmul_rn/__fsub_rn/__fadd_rn, so
// nvcc contracts nothing into an FMA, and gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, ROWS = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// V elements of T, aligned so that a load or store of one is one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

struct Layout {
  int64_t in_b, in_h, in_s;     // element strides of x (Dh's is 1)
  int64_t out_b, out_h, out_s;  // ... of y
};

// Thread t: pair group j = t % (half / V), position s, row group t / (S * groups).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
rope_kernel(const T* __restrict__ x, const float* __restrict__ freq, T* __restrict__ y,
            int rows, int H, int S, int half, Layout L, long long pos0, int inverse,
            long long total) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int groups = half / V;
  const int j = (int)(t % groups) * V;
  const long long rest = t / groups;
  const int s = (int)(rest % S);
  const int r0 = (int)(rest / S) * ROWS;

  // the loads first, so that the trigonometry runs while they are in flight
  Pack<T, V> x1[ROWS], x2[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = r0 + k;
    if (r < rows) {
      const T* src = x + (r / H) * L.in_b + (r % H) * L.in_h + s * L.in_s + j;
      x1[k] = *reinterpret_cast<const Pack<T, V>*>(src);
      x2[k] = *reinterpret_cast<const Pack<T, V>*>(src + half);
    }
  }
  const float p = __ll2float_rn(pos0 + s);
  float c[V], sn[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float a = __fmul_rn(p, __ldg(freq + j + e));
    c[e] = cosf(a);
    sn[e] = inverse ? -sinf(a) : sinf(a);
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = r0 + k;
    if (r < rows) {
      Pack<T, V> y1, y2;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float a1 = to_f32(x1[k].v[e]), a2 = to_f32(x2[k].v[e]);
        from_f32(__fsub_rn(__fmul_rn(a1, c[e]), __fmul_rn(a2, sn[e])), &y1.v[e]);
        from_f32(__fadd_rn(__fmul_rn(a2, c[e]), __fmul_rn(a1, sn[e])), &y2.v[e]);
      }
      T* dst = y + (r / H) * L.out_b + (r % H) * L.out_h + s * L.out_s + j;
      *reinterpret_cast<Pack<T, V>*>(dst) = y1;
      *reinterpret_cast<Pack<T, V>*>(dst + half) = y2;
    }
  }
}

template <typename T>
int launch(const void* x, const void* freq, void* y, int B, int H, int S, int Dh,
           const Layout& L, long long pos0, int inverse, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Dh <= 0 || Dh % 2) return (int)cudaErrorInvalidValue;
  const int half = Dh / 2, rows = B * H;
  // 16-byte packs where every start is 16-byte aligned, else one element
  constexpr int VEC = 16 / sizeof(T);
  const int64_t steps[] = {half, L.in_b, L.in_h, L.in_s, L.out_b, L.out_h, L.out_s};
  bool wide = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  for (int64_t st : steps) wide = wide && st % VEC == 0;
  const long long groups = wide ? half / VEC : half;
  const long long total = (long long)((rows + ROWS - 1) / ROWS) * S * groups;
  const long long blocks = (total + THREADS - 1) / THREADS;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    rope_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)x, (const float*)freq, (T*)y, rows, H, S, half, L, pos0, inverse, total);
  else
    rope_kernel<T, 1><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)x, (const float*)freq, (T*)y, rows, H, S, half, L, pos0, inverse, total);
  return (int)cudaGetLastError();
}

}  // namespace

// x and y: [B, H, S, Dh] with Dh's stride 1 and the other strides (in
// elements) given; freq: [Dh / 2] f32.  x and y must not overlap.
extern "C" int rope_f32(const void* x, const void* freq, void* y, int B, int H, int S, int Dh,
                        long long in_b, long long in_h, long long in_s, long long out_b,
                        long long out_h, long long out_s, long long pos0, int inverse,
                        void* stream) {
  return launch<float>(x, freq, y, B, H, S, Dh, Layout{in_b, in_h, in_s, out_b, out_h, out_s},
                       pos0, inverse, stream);
}

extern "C" int rope_bf16(const void* x, const void* freq, void* y, int B, int H, int S, int Dh,
                         long long in_b, long long in_h, long long in_s, long long out_b,
                         long long out_h, long long out_s, long long pos0, int inverse,
                         void* stream) {
  return launch<__nv_bfloat16>(x, freq, y, B, H, S, Dh,
                               Layout{in_b, in_h, in_s, out_b, out_h, out_s}, pos0, inverse,
                               stream);
}
