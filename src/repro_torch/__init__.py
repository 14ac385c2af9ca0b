"""PyTorch/CUDA port of the fraud-detection Lambda system.

The JAX package ``repro`` is the reference; this package mirrors its module
names and is held against it by ``tests/test_torch_*.py``.  It imports
``torch`` and numpy only.  Entry points (``core.lnn.lnn_init``,
``params.from_numpy``, ``serve.BatchLayer``/``SpeedLayer``,
``PaddedGraph.to``) run on the CUDA card unless the caller passes
``device="cpu"``; the tensor's device then picks the path: hand-written
kernels (``kernels/csrc``) on CUDA, their plain PyTorch versions on the CPU.
"""
