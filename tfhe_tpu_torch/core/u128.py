"""Two-limb (hi, lo) arithmetic for the 2^128 ciphertext modulus.

Counterpart of `tfhe_tpu/core/u128.py`.  A 128-bit torus element is a
trailing limb axis `[..., 2]` of int64 bit patterns, limb 0 the high 64
bits and limb 1 the low 64 bits.  int64 add, sub and mul wrap mod 2^64 as
the unsigned ops do; every carry and borrow is an unsigned compare
(`numeric.ult`) and every right shift of a limb is logical
(`numeric.shr`).
"""
from __future__ import annotations

import numpy as np
import torch

from . import threefry
from .numeric import as_i64, shr, ult

_M32 = (1 << 32) - 1


def make128(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(hi, lo), dim=-1)


def hi_lo(x: torch.Tensor) -> tuple:
    return x[..., 0], x[..., 1]


def from_python_int(v: int, shape, device) -> torch.Tensor:
    """The value v mod 2^128 in every element of `shape`: [*shape, 2] on
    `device`."""
    v %= 1 << 128
    out = torch.empty(tuple(shape) + (2,), dtype=torch.int64, device=device)
    out[..., 0] = as_i64(v >> 64)
    out[..., 1] = as_i64(v)
    return out


def from_python_ints(values, device) -> torch.Tensor:
    """A sequence (or nested numpy object array) of Python ints → [..., 2]
    on `device`."""
    arr = np.asarray(values, dtype=object) % (1 << 128)
    hi = (arr >> 64).astype(np.uint64)
    lo = (arr & ((1 << 64) - 1)).astype(np.uint64)
    both = np.stack([hi, lo], axis=-1).view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(both)).to(device)


def to_python_ints(x: torch.Tensor) -> np.ndarray:
    """An object-dtype numpy array of Python ints in [0, 2^128) (host side)."""
    both = x.detach().cpu().numpy().view(np.uint64)
    return (both[..., 0].astype(object) << 64) | both[..., 1].astype(object)


def zeros128(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (2,), dtype=torch.int64, device=device)


def add128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, al = hi_lo(a)
    bh, bl = hi_lo(b)
    lo = al + bl
    return make128(ah + bh + ult(lo, al).to(torch.int64), lo)


def sub128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, al = hi_lo(a)
    bh, bl = hi_lo(b)
    return make128(ah - bh - ult(al, bl).to(torch.int64), al - bl)


def neg128(a: torch.Tensor) -> torch.Tensor:
    ah, al = hi_lo(a)
    return make128(~ah + (al == 0).to(torch.int64), -al)


def where128(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond.unsqueeze(-1), a, b)


def mul_u64_by_u128(t: torch.Tensor, c_hi: int, c_lo: int) -> torch.Tensor:
    """t (int64 values in [0, 2^32)) times the constant c_hi * 2^64 + c_lo,
    mod 2^128; the high half of t * c_lo from a 32-bit split of c_lo."""
    mid = t * (c_lo >> 32)
    mid_sh = mid << 32
    lo = mid_sh + t * (c_lo & _M32)
    hi = shr(mid, 32) + t * as_i64(c_hi) + ult(lo, mid_sh).to(torch.int64)
    return make128(hi, lo)


def mul_small_signed_by_128(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d (integers, |d| < 2^31) times x [..., 2], mod 2^128."""
    mag = d.abs().to(torch.int64)
    xh, xl = hi_lo(x)
    mid = mag * shr(xl, 32)
    mid_sh = mid << 32
    lo = mid_sh + mag * (xl & _M32)
    hi = shr(mid, 32) + mag * xh + ult(lo, mid_sh).to(torch.int64)
    prod = make128(hi, lo)
    return where128(d < 0, neg128(prod), prod)


def sum128(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of [..., 2] values along value axis `dim` (counted without the
    limb axis: -1 is the last axis before it), carry-exact for up to 2^31
    terms: the low limbs are summed as two 32-bit halves."""
    hi, lo = hi_lo(x)
    lo_l = (lo & _M32).sum(dim=dim)
    lo_h = shr(lo, 32).sum(dim=dim)
    total_h = lo_h + (lo_l >> 32)
    out_lo = (lo_l & _M32) | (total_h << 32)
    return make128(hi.sum(dim=dim) + (total_h >> 32), out_lo)


def uniform128(key: torch.Tensor, shape) -> torch.Tensor:
    """Uniform 128-bit words under threefry keys [..., 2]: those of tfhe_tpu
    u128.uniform128(key, shape) for each key, bit for bit ([..., *shape,
    2])."""
    words = threefry.uniform_torus(key, (2,) + tuple(shape))      # [..., 2, *shape]
    hi, lo = words.unbind(dim=key.dim() - 1)
    return make128(hi, lo)


def gaussian_noise128(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    """Rounded gaussian with std-dev `std` in units of 2^-128 q (std may
    exceed 2^64), sampled in float64 from `gen` (tfhe_tpu
    u128.gaussian_noise128's formula; the draws are the generator's)."""
    if std == 0.0:
        return zeros128(shape, gen.device)
    v = torch.randn(tuple(shape), generator=gen, dtype=torch.float64, device=gen.device) * std
    hi_f = torch.floor(v * 2.0 ** -64)
    frac = v * 2.0 ** -64 - hi_f
    lo_f = torch.clamp(torch.floor(frac * 2.0 ** 64), max=2.0 ** 64 - 2 ** 11)
    # lo_f is in [0, 2^64): above 2^63 it is taken through its offset
    big = lo_f >= 2.0 ** 63
    lo = torch.where(big, lo_f - 2.0 ** 63, lo_f).to(torch.int64)
    lo = torch.where(big, lo ^ (-(1 << 63)), lo)
    return make128(hi_f.to(torch.int64), lo)


__all__ = ["make128", "hi_lo", "from_python_int", "from_python_ints", "to_python_ints",
           "zeros128", "add128", "sub128", "neg128", "where128", "mul_u64_by_u128",
           "mul_small_signed_by_128", "sum128", "uniform128", "gaussian_noise128"]
