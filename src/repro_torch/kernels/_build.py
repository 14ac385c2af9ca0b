"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together), linked into one shared
library with a plain C interface, and loaded with ``ctypes``.  The build
runs at first use, into ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``), under a name that hashes the sources and flags,
so an edited kernel is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module of the
package on hosts that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches of each kernel, one per successful launch by its wrapper; a run
#: sets them to 0 and reads them to show which kernels a path went through.
#: ``moe_experts`` counts one per call of the MoE's grouped expert products
#: (``kernels/moe_experts.py``: three grouped GEMMs, one per projection);
#: ``rope`` one per rotated tensor and ``rope_bwd`` one per its gradient.
#: Wrappers may launch from several host threads (the streaming engine's
#: refresh thread), so every update holds ``_LAUNCH_LOCK``
LAUNCHES = {"csr_spmm": 0, "edge_softmax": 0, "stage2_score": 0,
            "ssd_scan": 0, "flash_attention": 0, "gqa_decode": 0,
            "csr_spmm_bwd": 0, "edge_softmax_bwd": 0,
            "flash_attention_bwd": 0, "ssd_scan_bwd": 0, "moe_experts": 0,
            "rope": 0, "rope_bwd": 0}


_LAUNCH_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()       # one build, however many threads ask first


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float      # build (or load) time of the first call
    built: bool         # False when an up-to-date library was loaded
    log: str            # nvcc output, including ptxas register/spill lines


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(sources: list[Path]) -> str:
    """A hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"$ {' '.join(c)}\n{o}" for c, o in failed))
    return "\n".join(outs)


def _compile(sources: list[Path], out: Path) -> str:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(sources, objs)])
        lib_tmp = Path(tmp) / out.name
        log += _run_all([[nvcc, "-shared", "-Xcompiler", "-fPIC",
                          *map(str, objs), "-o", str(lib_tmp)]])
        os.replace(lib_tmp, out)
    return log


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("csr_spmm_f32", "csr_spmm_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = i
    lib.csr_spmm_etype_mean_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.csr_spmm_etype_mean_f32.restype = i
    lib.csr_spmm_etype_mean_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.csr_spmm_etype_mean_bf16.restype = i
    lib.edge_softmax_agg_f32.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
    lib.edge_softmax_agg_f32.restype = i
    lib.csr_spmm_bwd_f32.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.csr_spmm_bwd_f32.restype = i
    lib.csr_spmm_etype_mean_bwd_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.csr_spmm_etype_mean_bwd_f32.restype = i
    lib.edge_softmax_agg_bwd_f32.argtypes = [p] * 15 + [i, i, i, p]
    lib.edge_softmax_agg_bwd_f32.restype = i
    lib.stage2_score_f32.argtypes = [p, p]
    lib.stage2_score_f32.restype = i
    for name in ("ssd_scan_f32", "ssd_scan_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
    for name in ("ssd_scan_bwd_f32", "ssd_scan_bwd_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 17 + [i, i, i, i, i, p]
        fn.restype = i
    for name in ("flash_attention_f32", "flash_attention_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    for name in ("flash_attention_bwd_f32", "flash_attention_bwd_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 10 + [i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    for name in ("gqa_decode_f32", "gqa_decode_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    ll = ctypes.c_longlong
    for name in ("rope_f32", "rope_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, i, p]
        fn.restype = i


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process.
    A thread that asks while another builds waits for that build."""
    with _LOAD_LOCK:
        return _load_library()


@functools.cache
def _load_library() -> KernelLibrary:
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"librepro_torch_{_digest(sources)}.so"
    t0 = time.perf_counter()
    built, log = not out.exists(), ""
    if built:
        log = _compile(sources, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return KernelLibrary(lib, out, time.perf_counter() - t0, built, log)


def check_launch(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    count_launch(name)


def count_launch(name: str) -> None:
    """Count one launch of ``name``."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _is_dtensor(t: torch.Tensor) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def check_tensor(t, name: str, dtypes, shape=None, device=None, contiguous=True) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of an allowed dtype
    (and of ``shape`` and on ``device`` when given), not a ``DTensor`` —
    what a kernel takes.  ``contiguous=False`` for a kernel that reads
    ``t`` through its strides."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if _is_dtensor(t):
        raise TypeError(f"{name} is a DTensor: a kernel takes one device's plain tensor, "
                        "so call it on the local shard (DTensor.to_local())")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rev(rev_ptr, rev_slot, n: int, device) -> None:
    """Raise unless ``(rev_ptr, rev_slot)`` is a reverse-slot index of a
    graph of ``n`` rows on ``device`` (``kernels.ref.reverse_slots_ref``)."""
    check_tensor(rev_ptr, "rev_ptr", (torch.int32,), (n + 1,), device)
    if not isinstance(rev_slot, torch.Tensor) or rev_slot.dim() != 1:
        raise ValueError("rev_slot must be a 1-D tensor")
    check_tensor(rev_slot, "rev_slot", (torch.int32,), None, device)


def check_differentiable(name: str, x: torch.Tensor, rev, **fixed: torch.Tensor) -> None:
    """Raise unless autograd can take ``name``'s gradient on the card through
    its backward kernel: ``x`` float32 (the backward kernels are f32 only),
    the graph's reverse-slot index given, and no gradient wanted for the
    ``fixed`` inputs, which come from the graph."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the backward kernel takes float32, got {x.dtype}")
    if rev is None:
        raise ValueError(f"{name}: a gradient on the card needs the graph's reverse-slot "
                         "index (rev_ptr, rev_slot), which PaddedGraph.with_rev builds")
    for what, t in fixed.items():
        if t.requires_grad:
            raise ValueError(f"{name}: no gradient with respect to {what}, which comes from "
                             "the graph; detach it")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary, as a kernel
    that reads it with 16-byte vector loads needs."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must start on a 16-byte boundary")
