"""structure_from_motion_tpu_torch — the PyTorch/CUDA port of
``structure_from_motion_tpu`` for one NVIDIA H100.

Module names follow the JAX package, so each counterpart is found under the
same path. Plain tensor code is PyTorch; the six TPU kernels of the JAX
package are hand-written CUDA C++ for sm_90a under ``csrc/``, built and
loaded by :mod:`structure_from_motion_tpu_torch.kernels` at first use:

    ops/blur_cuda.py      B1  separable Gaussian pyramid blur
    ops/features_cuda.py  B2  fused DoG candidate response
    ops/matching.py       B3  fused L2 distance + top-2 matcher
    ops/ba_cuda.py        B4  fused BA residual/Jacobian/block assembly
    ops/ba_matvec.py      B5  PCG matvec camera expand
                          B6  PCG matvec camera reduce (global BA)

Each kernel's wrapper runs its plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors. Entry points that take a ``device``
default to ``"cuda"``. The port imports neither JAX nor any module of the
JAX package: the configuration dataclasses (``config.py``) and the rendered
test scene (``io/synthetic.py``) are its own copies, field for field and bit
for bit, so configurations and checkpoints pass between the two packages.
"""

from structure_from_motion_tpu_torch import device  # noqa: F401  (f32 policy)
