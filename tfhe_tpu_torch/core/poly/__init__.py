"""Polynomial algebra over Z_q[X]/(X^N + 1) on int64 tensors.

Counterpart of `tfhe_tpu/core/poly/__init__.py`: the monomial rotation and
the exact CRT-NTT engine of `ntt.py`."""
from __future__ import annotations

import torch

from . import ntt
from .ntt import NttPlan, get_plan, negacyclic_polymul

__all__ = ["ntt", "NttPlan", "get_plan", "negacyclic_polymul", "monomial_mul",
           "monomial_mul128"]


def monomial_mul(poly: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """X^t * poly mod X^N + 1 for integer t (any sign; reduced mod 2N).

    poly: [..., N]; t: integer tensor whose shape broadcasts against the
    leading axes of poly.  out[j] = ±poly[(j - t) mod N], negated where the
    rotation wraps (X^N = -1)."""
    n = poly.shape[-1]
    t_red = torch.remainder(t, 2 * n)
    flip = t_red >= n
    rot = torch.where(flip, t_red - n, t_red)
    idx = torch.arange(n, device=poly.device)
    batch = torch.broadcast_shapes(poly.shape[:-1], rot.shape)
    src = torch.remainder(idx - rot.unsqueeze(-1), n).expand(batch + (n,))
    shifted = torch.gather(poly.expand(batch + (n,)), -1, src)
    sign_neg = (idx < rot.unsqueeze(-1)) ^ flip.unsqueeze(-1)
    return torch.where(sign_neg, -shifted, shifted)


def monomial_mul128(poly128: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """X^t * poly for 128-bit polynomials [..., N, 2] (tfhe_tpu
    pbs128.py:226 monomial_mul128): `monomial_mul`'s gather on both limbs,
    the wrapped coefficients negated mod 2^128."""
    from ..u128 import neg128, where128
    n = poly128.shape[-2]
    t_red = torch.remainder(t, 2 * n)
    flip = t_red >= n
    rot = torch.where(flip, t_red - n, t_red)
    idx = torch.arange(n, device=poly128.device)
    batch = torch.broadcast_shapes(poly128.shape[:-2], rot.shape)
    src = torch.remainder(idx - rot.unsqueeze(-1), n).expand(batch + (n,))
    src = src.unsqueeze(-1).expand(batch + (n, 2))
    shifted = torch.gather(poly128.expand(batch + (n, 2)), -2, src)
    sign_neg = (idx < rot.unsqueeze(-1)) ^ flip.unsqueeze(-1)
    return where128(sign_neg, neg128(shifted), shifted)
