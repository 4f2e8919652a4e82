"""radnerf_tpu_torch: the PyTorch/CUDA port of radnerf_tpu for NVIDIA Hopper.

The JAX package ``radnerf_tpu`` is the reference; this package mirrors its
module names (``ops/``, ``models/``, ``data/``) so each function has a
counterpart there. The hot-path kernels are CUDA C++ sources under
``csrc/``, compiled with ``nvcc`` at first use (``ops/_kernels.py``);
importing the package never builds or needs ``nvcc``.

Entry points that create tensors default to ``device="cuda"`` and raise
without a card unless the caller passes ``device="cpu"``. Functions on
tensors run where their inputs lie: on the CPU each kernel wrapper runs its
plain PyTorch twin, on a CUDA tensor it launches the kernel or raises.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
