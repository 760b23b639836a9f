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
launches the kernel for CUDA tensors. The configuration dataclasses are
shared with the JAX package (``structure_from_motion_tpu.config``, pure
Python). Nothing here imports JAX.
"""

from structure_from_motion_tpu_torch import device  # noqa: F401  (f32 policy)
