"""Torus arithmetic on int64 tensors.

The 64-bit discretized torus is stored as `torch.int64`: torch has no
uint64 arithmetic on every device, while int64 add, sub and mul wrap mod
2^64 exactly as the unsigned ops would.  Four things differ from unsigned
arithmetic and each has a helper here:

  * `>>` on int64 is arithmetic: use `shr` (logical shift);
  * `<` / `>=` compare signed: use `ult` / `uge` (sign bit flipped);
  * division by a torus constant: use `udiv` (unsigned floor division);
  * numpy interchange: `to_numpy_u64` / `from_numpy_u64` reinterpret bits.

Counterpart of `tfhe_tpu/core/numeric.py` for the 64-bit torus.
"""
from __future__ import annotations

import numpy as np
import torch

LOG_Q = 64
_SIGN = -(1 << 63)          # int64 bit pattern of 2^63


def as_i64(value: int) -> int:
    """Python int taken mod 2^64 → the int64 with the same bits."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >= 1 << 63 else value


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by a constant s in [0, 64)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def uge(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a >= b on int64 bit patterns."""
    return (a ^ _SIGN) >= (b ^ _SIGN)


def udiv(x: torch.Tensor, d: int) -> torch.Tensor:
    """Unsigned floor(x / d) for int64 bit patterns x and a constant d >= 1.

    A power of two is a logical shift; otherwise halve x first so the
    signed floor division sees a non-negative value, then fix the last bit:
    x = 2h + b, h = q0*d + r0, so floor(x/d) = 2*q0 + [2*r0 + b >= d]."""
    assert 1 <= d < 1 << 64
    if d & (d - 1) == 0:
        return shr(x, d.bit_length() - 1)
    if d > 1 << 63:                       # the quotient is 0 or 1
        return uge(x, as_i64(d)).to(torch.int64)
    q = (shr(x, 1) // d) << 1
    rem = x - q * as_i64(d)
    return q + uge(rem, as_i64(d)).to(torch.int64)


def to_numpy_u64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().view(np.uint64)


def from_numpy_u64(a, device=None) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def float_round_to_torus(x: torch.Tensor) -> torch.Tensor:
    """Round a float64 tensor (units of q, signed representative) onto the
    torus."""
    return torch.round(x).to(torch.int64)
