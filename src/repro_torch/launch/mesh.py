"""Device meshes of the dry-run and the H100's roofline constants.

The reference's ``repro.launch.mesh`` (TPU v5e pods of 16 x 16 chips) on
H100s.  The production mesh is a ``torch.distributed`` ``DeviceMesh`` over
a *fake* process group (``torch.testing._internal.distributed.fake_pg``):
one process plays rank 0 of 256 or 512, every collective is counted and
none moves data, and the arguments are meta ``DTensor``s (``launch.steps``),
so nothing is allocated on any device.  The group is started inside
:func:`make_production_mesh`, never at import, and ended by
:func:`release_production_mesh` or by leaving :func:`production_mesh`.
The mesh's device type is ``cuda`` (what it stands for): ``DTensor`` then
takes its collective path for every redistribution (on a ``cpu`` mesh it
emulates an all-to-all by an all-gather, which would miscount one as the
other).  Creating it allocates nothing on a card.

The host mesh is a real one-device mesh: the card by default, the CPU when
asked; the steps on it are the port's one-card code on plain tensors.

H100 SXM constants (NVIDIA H100 Tensor Core GPU data sheet, SXM5 part,
dense rates at the 700 W limit):

* ``PEAK_FLOPS_BF16`` 989.4e12 FLOP/s, bf16 on the tensor cores, no sparsity;
* ``HBM_BW`` 3.35e12 B/s, HBM3;
* ``HBM_BYTES`` 80e9 B of HBM;
* ``LINK_BW`` 50e9 B/s, the rate of the collective term.  A 16-wide mesh
  axis spans two 8-GPU NVLink nodes, so its ring crosses the node boundary
  on one 400 Gb/s NDR InfiniBand port per GPU (ConnectX-7, one per GPU in
  a DGX/HGX H100 node): 400e9 / 8 = 50e9 B/s, the slowest link on the ring.
  (NVLink 4 inside a node, 900 GB/s, does not bound a 16-wide ring.)

None of the reference's v5e constants carries over.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch

PEAK_FLOPS_BF16 = 989.4e12       # per card, dense bf16
HBM_BW = 3.35e12                 # bytes/s per card
HBM_BYTES = 80e9                 # bytes per card
LINK_BW = 50e9                   # bytes/s per card across the node boundary (one NDR port)

#: the fake group this module started: (world size), or None
_FAKE_GROUP: dict = {"world": None}


@dataclass(frozen=True)
class Mesh:
    """A named mesh: ``axis_names`` and ``shape`` (axis name -> size), as the
    sharding policy reads them, plus the ``torch.distributed`` mesh of a
    production mesh (``device_mesh``; None for the one-device host mesh)
    and the device the host mesh's tensors live on."""

    axis_names: tuple
    shape: dict
    device_mesh: object = None
    device: torch.device = field(default_factory=lambda: torch.device("meta"))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={self.shape[a]}" for a in self.axis_names)
        where = "fake group" if self.device_mesh is not None else str(self.device)
        return f"Mesh({dims}; {where})"


def _start_fake_group(world: int) -> None:
    """The default process group as a fake group of ``world`` ranks, this
    process rank 0.  Refuses to replace a group this module did not start."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        if _FAKE_GROUP["world"] is None:
            raise RuntimeError("a process group that the dry-run did not start is running")
        if _FAKE_GROUP["world"] == world:
            return
        release_production_mesh()
    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    _FAKE_GROUP["world"] = world


def make_production_mesh(*, multi_pod: bool = False, layout: str = "16x16") -> Mesh:
    """layout: '16x16' (the production mesh) or another (data, model)
    factorization of the same 256 cards — e.g. '32x8' for expert-parallel
    MoE (the model axis must divide num_experts for EP to engage).
    ``multi_pod``: two such meshes, 512 cards, ``("pod", "data", "model")``.

    Starts (or reuses) the fake process group of that many ranks; end it
    with :func:`release_production_mesh`, or use :func:`production_mesh`."""
    if multi_pod:
        shape, axes = (2, 16, 16), ("pod", "data", "model")
    else:
        d, m = (int(x) for x in layout.split("x"))
        if d * m != 256:
            raise ValueError(f"layout {layout} is not a 256-card mesh")
        shape, axes = (d, m), ("data", "model")
    return make_fake_mesh(shape, axes)


def make_fake_mesh(shape: tuple, axes: tuple) -> Mesh:
    """A mesh of ``shape`` (one size per name of ``axes``) over a fake
    process group of as many ranks, this process rank 0 (the production
    meshes, and the small ones of the tests)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = math.prod(shape)
    _start_fake_group(world)
    dm = DeviceMesh("cuda", torch.arange(world).reshape(shape), mesh_dim_names=tuple(axes))
    return Mesh(tuple(axes), dict(zip(axes, shape)), dm)


def release_production_mesh() -> None:
    """End the fake process group :func:`make_production_mesh` started, if
    any; the process is left as it was found."""
    import torch.distributed as dist

    if _FAKE_GROUP["world"] is not None:
        if dist.is_initialized():
            dist.destroy_process_group()
        _FAKE_GROUP["world"] = None


@contextlib.contextmanager
def production_mesh(**kwargs):
    """``make_production_mesh(**kwargs)`` for the ``with`` block, the fake
    group ended after it."""
    try:
        yield make_production_mesh(**kwargs)
    finally:
        release_production_mesh()


@contextlib.contextmanager
def fake_mesh(shape: tuple, axes: tuple):
    """``make_fake_mesh(shape, axes)`` for the ``with`` block, the fake
    group ended after it."""
    try:
        yield make_fake_mesh(shape, axes)
    finally:
        release_production_mesh()


def make_host_mesh(device=None) -> Mesh:
    """The one-device mesh ``(data=1, model=1)`` of the card (default) or of
    ``device`` (``"cpu"`` for the plain path), for real runs of the same
    step builders."""
    from repro_torch.utils.device import resolve_device

    return Mesh(("data", "model"), {"data": 1, "model": 1}, None, resolve_device(device))
