"""repro_torch — the BSPS system ported to PyTorch and CUDA on an NVIDIA H100.

A second package beside the JAX reference ``repro``, mirroring it module for
module: the BSP accelerator model, pseudo-streams and hypersteps, the Eq. 1 /
Eq. 2 cost model, and the dense decoder served through hand-written CUDA
kernels (``kernels/csrc``). It imports torch, numpy and the standard library
only. Every entry point runs on the CUDA card unless its caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
