"""Correctly rounded float32 arithmetic where PyTorch's CPU kernels are
not.

PyTorch's CPU kernel for the float32 square root is a vectorised
approximation, one ulp off on some inputs; the JAX package, numpy
and the CUDA kernels (``sqrtf`` without fast math) round correctly, and a
one-ulp difference in a sampled direction or a light's area can flip a
path or a light choice. PyTorch's CPU float64 root rounded to float32 is
right almost everywhere but was one ulp off in rare elements of large
tensors (above PyTorch's parallel grain), so ``sqrt_rn`` checks it with
one exact step: the result r is right when x lies between the squares
of the midpoints of r and its float32 neighbours, and those squares are
exact in float64 (a midpoint has 25 significant bits, its square 50).
Autograd differentiates through the float64 root.

``fma_rn`` is the fused multiply-add ``a·b + c`` rounded once, which
XLA's CPU programs use where they contract a product into a sum (as in
``jnp.cross``); PyTorch has no float32 FMA of its own on the CPU.
"""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor."""
    r = torch.sqrt(x.double()).to(x.dtype)
    with torch.no_grad():
        x64, r32 = x.double(), r.detach()
        up = torch.nextafter(r32, torch.full_like(r32, float("inf")))
        down = torch.nextafter(r32, torch.zeros_like(r32))
        hi = (r32.double() + up.double()) * 0.5
        lo = (r32.double() + down.double()) * 0.5
        pos = x64 > 0.0
        step = torch.where(pos & (x64 > hi * hi), up - r32,
                           torch.where(pos & (x64 < lo * lo), down - r32,
                                       torch.zeros_like(r32)))
    # r ± one ulp is exact in float32; the gradient is the root's
    return r + step


def fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` of float32 tensors, rounded once to float32 (no
    gradient). The product is exact in float64 and the float64 sum s is
    exact up to its error e (two-sum); rounding s to float32 is right
    except where s lies exactly on a float32 midpoint with e != 0, when
    the result is the neighbour on e's side."""
    with torch.no_grad():
        p = a.double() * b.double()
        c64 = c.double()
        s = p + c64
        t = s - p
        e = (p - (s - t)) + (c64 - t)
        r = s.float()
        up = torch.nextafter(r, torch.full_like(r, float("inf")))
        down = torch.nextafter(r, torch.full_like(r, float("-inf")))
        r64 = r.double()
        to_up = (s == (r64 + up.double()) * 0.5) & (e > 0)
        to_down = (s == (r64 + down.double()) * 0.5) & (e < 0)
        return torch.where(to_up, up, torch.where(to_down, down, r))
