"""buildingsegment_tpu_torch — the PyTorch/CUDA port of buildingsegment_tpu.

The JAX package ``buildingsegment_tpu`` stays the reference; this package
re-implements its window segmentation path in PyTorch, with the Pallas
kernels of that path rewritten by hand in CUDA C++ for Hopper
(``csrc/``).  Module names follow the JAX package so each module's
counterpart is easy to find.

Every function takes its tensors on an explicit device.  The kernel path
is chosen by ``tensor.is_cuda`` alone: a CUDA tensor launches the CUDA
kernel (or raises), a CPU tensor runs the kernel's plain PyTorch version.

The host modules of the JAX package that import no jax (``config``,
``io``, ``native``, ``utils.synthetic``, ``utils.quality``) are used as
they are.

Public entry points:
    - :mod:`buildingsegment_tpu_torch.pipeline` — ``segment_cloud`` /
      ``segment_file``
"""

from buildingsegment_tpu.config import PipelineConfig

__version__ = "0.1.0"

__all__ = ["PipelineConfig", "__version__"]
