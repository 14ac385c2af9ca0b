#!/usr/bin/env python3
"""Where the bf16 ``ssd_scan`` kernel's time goes, on one NVIDIA card.

Builds variants of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` (nvcc,
sm_90a, in a patched copy under ``build/ssd_probe/``), each with one part
of the chunk loop switched off by a macro, and times each at the
zamba2-1.2b serving shape (B=4 S=512 H=64 P=64 N=64, bf16) as
``chip_smoke.py`` times kernels (CUDA events over CUDA-graph replays,
median).  A variant with a part switched off computes a wrong result and is
only timed.  Then it records a ``clock64`` trace of the phases of one block
(8 warps x 8 chunks) and measures the card's ``mma.sync`` m16n8k16 bf16
rate with 16 warps per SM.  Needs the card and nvcc; exits non-zero
without them.  Run from the root of the repository:

    python3 ssd_scan_probe.py
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SHAPE = (4, 512, 64, 64, 64)   # B, S, H, P, N
OUT = ROOT / "build" / "ssd_probe"

# (text in the kernel, its replacement): each part behind a macro, and the
# trace points, in the order of one chunk
PATCHES = [
    ("    if (kc + 1 < n_chunks) {\n      const float dtot",
     "    if (kc + 1 < n_chunks && !NO_UPDATE) {\n      const float dtot"),
    ("    if (w >= half + 2) {", "    if (NO_INTRA) {\n    } else if (w >= half + 2) {"),
    ("      if (kk > w) break;", "      if (kk > w || NO_INTRA) break;"),
    ("    if (kc > 0) {", "    if (kc > 0 && !NO_CS) {"),
    ("      if (t < S && p < P)\n", "      if (t < S && p < P && !NO_STORE)\n"),
    ("    if (loader) cp_async_wait<0>();\n", "    TR(0);\n    if (loader) cp_async_wait<0>();\n"),
    ("    if (loader && kc + 1 < n_chunks)\n",
     "    TR(1);\n    if (loader && kc + 1 < n_chunks)\n"),
    ("    // S = S exp(total) + (b", "    TR(2);\n    // S = S exp(total) + (b"),
    ("    // this warp's 16 rows of C", "    TR(3);\n    // this warp's 16 rows of C"),
    ("    // the two warps of this row tile", "    TR(4);\n    // the two warps of this row tile"),
    ("    // W·x over the steps", "    TR(5);\n    // W·x over the steps"),
    ("    // C·S with the state before", "    TR(6);\n    // C·S with the state before"),
    ("    // y = W·x + exp(cum_i) C·S", "    TR(7);\n    // y = W·x + exp(cum_i) C·S"),
    ("            *reinterpret_cast<const uint4*>(stg + r * LDY + c);\n    }\n",
     "            *reinterpret_cast<const uint4*>(stg + r * LDY + c);\n    }\n    TR(8);\n"),
]
PHASES = ["barrier, loads issued, chunk waited, prefix sums", "state update", "C·Bᵀ and W",
          "named barrier", "W·x", "C·S", "y"]
HEADER = """
#ifndef NO_UPDATE
#define NO_UPDATE 0
#endif
#ifndef NO_INTRA
#define NO_INTRA 0
#endif
#ifndef NO_CS
#define NO_CS 0
#endif
#ifndef NO_STORE
#define NO_STORE 0
#endif
#ifndef TRACE
#define TRACE 0
#endif
__device__ long long g_trace[8 * 8 * 9];   // warp, chunk, trace point
// one block (x 0, head 5, batch 1), lane 0 of each warp, the first 8 chunks
#define TR(k)                                                                      \\
  do {                                                                             \\
    if (TRACE && blockIdx.x == 0 && blockIdx.y == 5 && blockIdx.z == 1 &&          \\
        threadIdx.x % 32 == 0 && kc < 8)                                           \\
      g_trace[((threadIdx.x / 32) * 8 + kc) * 9 + (k)] = clock64();                \\
  } while (0)
"""
FOOTER = """
extern "C" int probe_trace(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
"""
VARIANTS = {
    "whole kernel": [],
    "without the state update": ["-DNO_UPDATE=1"],
    "without C·Bᵀ, W and W·x": ["-DNO_INTRA=1"],
    "without C·S": ["-DNO_CS=1"],
    "without the y stores": ["-DNO_STORE=1"],
    "loads, prefix sums and y stores only": ["-DNO_UPDATE=1", "-DNO_INTRA=1", "-DNO_CS=1"],
    "trace": ["-DTRACE=1"],
}
MMA_BENCH = r"""
#include "mma_bf16.cuh"
// 16 warps per SM, each issuing 8 independent m16n8k16 products per step
__global__ void __launch_bounds__(512, 1) mma_rate(float* out, int steps) {
  unsigned a[4] = {threadIdx.x, 1u, 2u, 3u};
  float d[8][4] = {};
  for (int i = 0; i < steps; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_bf16(d[j], a, 0x3f803f80u + j, 0x3f803f80u);
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" float mma_rate_ms(float* out, int sms, int steps) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  mma_rate<<<sms, 512>>>(out, steps);
  cudaEventRecord(e0);
  mma_rate<<<sms, 512>>>(out, steps);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}
"""


def build(sources: dict) -> dict:
    """nvcc every (name -> (source path, flags)) side by side into a library
    under ``OUT``; return name -> the loaded library, or raise with the log
    of any build that fails."""
    from repro_torch.kernels._build import CSRC, NVCC_FLAGS, _nvcc

    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(CSRC), *flags, str(src),
         "-o", str(OUT / f"{i}.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (name, (src, flags)) in enumerate(sources.items())}
    libs = {}
    for i, (name, p) in enumerate(procs.items()):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{i}.so"))
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        print("ssd_scan_probe: CUDA is not available; this script needs the card", file=sys.stderr)
        return 1
    from chip_smoke import time_ms
    from repro_torch.kernels import ref

    src = (ROOT / "src/repro_torch/kernels/csrc/ssd_scan.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"ssd_scan_probe: the kernel no longer has {old!r} once")
        src = src.replace(old, new)
    src = src.replace('#include "mma_bf16.cuh"\n', '#include "mma_bf16.cuh"\n' + HEADER, 1) + FOOTER
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "ssd_scan_probe.cu").write_text(src)
    (OUT / "mma_rate.cu").write_text(MMA_BENCH)
    libs = build({**{name: (OUT / "ssd_scan_probe.cu", flags) for name, flags in VARIANTS.items()},
                  "mma": (OUT / "mma_rate.cu", [])})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    b, s, h, p, n = SHAPE
    x = torch.randn(b, s, h, p, generator=gen).to(dev, torch.bfloat16)
    bm = torch.randn(b, s, n, generator=gen).to(dev, torch.bfloat16)
    cm = torch.randn(b, s, n, generator=gen).to(dev, torch.bfloat16)
    dt = (torch.rand(b, s, h, generator=gen) * 0.19 + 0.01).to(dev)
    a = -(torch.rand(h, generator=gen) * 1.5 + 0.5).to(dev)
    d = torch.randn(h, generator=gen).to(dev)
    want = ref.ssd_scan_mma_ref(x, dt, a, bm, cm, d).float()
    scale = float(want.abs().max())
    y = torch.empty_like(x)
    for name in VARIANTS:
        fn = libs[name].ssd_scan_bf16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

        def run(fn=fn):
            rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                    d.data_ptr(), y.data_ptr(), b, s, h, p, n,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        run()
        torch.cuda.synchronize()
        err = float((y.float() - want).abs().max()) / scale
        print(f"ssd_scan bf16 B={b} S={s} H={h} P={p} N={n}, {name:<38} "
              f"{time_ms(run) * 1e3:8.2f} us  (max|d| {err:.1e} of scale)")

    trace = np.zeros(8 * 8 * 9, np.int64)
    libs["trace"].probe_trace(trace.ctypes.data_as(ctypes.c_void_p))
    trace = trace.reshape(8, 8, 9)
    per_chunk = np.diff(trace[:, :, 0], axis=1).mean()
    print(f"trace of one block: {per_chunk:.0f} cycles per chunk; mean cycles per phase and warp "
          "(a barrier's wait shows in the phase after it):")
    phase = np.diff(trace[:, :, 1:9], axis=2).mean(axis=1)   # [warp, phase]
    for i, name in enumerate(PHASES):
        print(f"  {name:<48} " + " ".join(f"{v:6.0f}" for v in phase[:, i]))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = libs["mma"]
    lib.mma_rate_ms.restype = ctypes.c_float
    buf = torch.empty(sms * 512, device=dev)
    steps = 4096
    ms = lib.mma_rate_ms(ctypes.c_void_p(buf.data_ptr()), sms, steps)
    flops = sms * 16 * steps * 8 * 2 * 16 * 8 * 16
    print(f"mma.sync m16n8k16 bf16, 16 warps per SM on {sms} SMs: {flops / ms / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
