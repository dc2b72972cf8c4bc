"""buildingsegment_tpu_torch — the PyTorch/CUDA port of buildingsegment_tpu.

The JAX package ``buildingsegment_tpu`` stays the reference; this package
re-implements its segmentation paths (window, multigrid, exact kNN) in
PyTorch, with the Pallas kernels of those paths rewritten by hand in
CUDA C++ for Hopper (``csrc/``).  Module names follow the JAX package so each module's
counterpart is easy to find.

Every function takes its tensors on an explicit device.  The kernel path
is chosen by ``tensor.is_cuda`` alone: a CUDA tensor launches the CUDA
kernel (or raises), a CPU tensor runs the kernel's plain PyTorch version.

The package imports nothing of ``buildingsegment_tpu``: the host
modules it needs (``config``, ``io.ply``, ``utils.synthetic``,
``utils.quality``) are its own copies.

Public entry points:
    - :mod:`buildingsegment_tpu_torch.pipeline` — ``segment_cloud`` /
      ``segment_file``
    - :mod:`buildingsegment_tpu_torch.cli` — the command line
"""

from buildingsegment_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig

__version__ = "0.1.0"

__all__ = ["DEFAULT_CONFIG", "PipelineConfig", "__version__"]
