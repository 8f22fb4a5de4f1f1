"""LWE and GLWE linear algebra on batched int64 torus tensors (counterpart of
`tfhe_tpu/core/algorithms/linear.py`; reference algorithms/
lwe_linear_algebra.rs, glwe_linear_algebra.rs): int64 add, sub, neg and mul
wrap mod 2^64, so each is one tensor op."""
from __future__ import annotations

import torch

from ..entities import GlweCiphertext, LweCiphertext
from ..numeric import as_i64


def _torus(value, like: torch.Tensor) -> torch.Tensor:
    """A clear value or tensor as int64 torus words on `like`'s device (Python
    ints at or above 2^63 as their int64 patterns)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=torch.int64)
    if isinstance(value, int):
        return torch.tensor(as_i64(value), dtype=torch.int64, device=like.device)
    return torch.as_tensor(value, device=like.device).to(torch.int64)


def lwe_add(a: LweCiphertext, b: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(data=a.data + b.data)


def lwe_sub(a: LweCiphertext, b: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(data=a.data - b.data)


def lwe_neg(a: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(data=-a.data)


def lwe_add_plaintext(a: LweCiphertext, pt) -> LweCiphertext:
    data = a.data.clone()
    data[..., -1] += _torus(pt, data)
    return LweCiphertext(data=data)


def lwe_sub_plaintext(a: LweCiphertext, pt) -> LweCiphertext:
    data = a.data.clone()
    data[..., -1] -= _torus(pt, data)
    return LweCiphertext(data=data)


def lwe_mul_cleartext(a: LweCiphertext, c) -> LweCiphertext:
    return LweCiphertext(data=a.data * _torus(c, a.data))


def glwe_add(a: GlweCiphertext, b: GlweCiphertext) -> GlweCiphertext:
    return GlweCiphertext(data=a.data + b.data)


def glwe_sub(a: GlweCiphertext, b: GlweCiphertext) -> GlweCiphertext:
    return GlweCiphertext(data=a.data - b.data)


def glwe_add_plaintext_poly(a: GlweCiphertext, poly) -> GlweCiphertext:
    data = a.data.clone()
    data[..., -1, :] += _torus(poly, data)
    return GlweCiphertext(data=data)


__all__ = ["lwe_add", "lwe_sub", "lwe_neg", "lwe_add_plaintext", "lwe_sub_plaintext",
           "lwe_mul_cleartext", "glwe_add", "glwe_sub", "glwe_add_plaintext_poly"]
