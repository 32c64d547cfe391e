"""hybridrenderer_tpu_torch — the hybrid renderer on PyTorch and CUDA.

A port of ``hybridrenderer_tpu`` (JAX/Pallas on a TPU) to PyTorch, with
hand-written CUDA kernels for an NVIDIA Hopper card (sm_90a). The layout
mirrors the JAX package module for module; the JAX package stays the
reference that the port's tests hold it against.

Every kernel sits beside a plain PyTorch version of the same function.
A wrapper dispatches on the device of its input tensors: CPU tensors go
to the plain version, CUDA tensors to the kernel (or the call raises).
Importing this package allocates no device memory and builds nothing;
kernels and the native BVH builder are compiled at first use into
``build/`` at the repository root (hybridrenderer_tpu_torch/native.py).
"""

__version__ = "0.1.0"

from .core.config import RenderSettings
from .core.types import DisplayMode, MaterialType, RenderFlags, RenderPathType

__all__ = [
    "RenderSettings",
    "DisplayMode",
    "MaterialType",
    "RenderFlags",
    "RenderPathType",
]
