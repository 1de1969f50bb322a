"""Hand-written CUDA kernels for the BSPS hot spots (paper §3 algorithms).

Each kernel: ``<name>.py`` declares its streaming structure as a
:class:`repro_torch.core.plan.StreamPlan` and wraps its CUDA source in
``csrc/``; :mod:`repro_torch.kernels.pipeline` is the single point that
lowers a plan to a launch. Public entry points live in ops.py and the plain
PyTorch versions in ref.py.
"""

from repro_torch.kernels import ops, pipeline, ref

__all__ = ["ops", "pipeline", "ref"]
