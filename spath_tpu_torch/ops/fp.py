"""Correctly rounded float32 arithmetic where PyTorch's CPU kernels are
not.

PyTorch's CPU kernel for the float32 square root is a vectorised
approximation, one ulp off on some inputs; the JAX package, numpy
and the CUDA kernels (``sqrtf`` without fast math) round correctly, and a
one-ulp difference in a sampled direction or a light's area can flip a
path or a light choice. The float64 root of a float32, rounded once to
float32, is the correctly rounded float32 root (53 >= 2·24 + 2 bits), on
any device, and autograd differentiates through it.
"""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor."""
    return torch.sqrt(x.double()).to(x.dtype)
