"""Torus arithmetic on int64 tensors.

The 64-bit discretized torus is stored as `torch.int64`: torch has no
uint64 arithmetic on every device, while int64 add, sub and mul wrap mod
2^64 exactly as the unsigned ops would.  Four things differ from unsigned
arithmetic and each has a helper here:

  * `>>` on int64 is arithmetic: use `shr` (logical shift);
  * `<` / `>=` compare signed: use `ult` / `uge` (sign bit flipped);
  * division by a torus constant: use `udiv` (unsigned floor division);
  * numpy interchange: `to_numpy_u64` / `from_numpy_u64` reinterpret bits.

Counterpart of `tfhe_tpu/core/numeric.py`.  The 32-bit torus (log_q = 32,
the boolean `TEST_PARAMS_BOOLEAN_U32` and the reference's own boolean
width) is held lifted: a 32-bit word x is the 64-bit word x * 2^32
(`lift32`, `drop32`).  Every sum and product mod 2^64 of lifted words is
the 32-bit one shifted up by 32, the signed decomposition at
base_log * level <= 31 reads the same digits and the modulus switch the same
top bits, so the 64-bit keyswitch and PBS serve both widths bit for bit.
Randomness is drawn at 32 bits and lifted; whatever leaves the port (files,
`interop`) drops the low 32 bits again (`to_numpy_torus`).
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


def check_log_q(log_q: int) -> int:
    """log_q if the port holds that torus width (64, or 32 lifted)."""
    if log_q not in (32, 64):
        raise ValueError(f"unsupported torus width {log_q}")
    return log_q


def lift32(x: torch.Tensor) -> torch.Tensor:
    """32-bit torus words (any int64 whose low 32 bits are the word, uint32
    or int32 values alike) → the lifted 64-bit words x * 2^32."""
    return x.to(torch.int64) << 32


def drop32(x: torch.Tensor) -> torch.Tensor:
    """Lifted words → the 32-bit words, uint32 values in int64."""
    return shr(x, 32)


def to_signed(x: torch.Tensor, log_q: int = LOG_Q) -> torch.Tensor:
    """The signed representative in [-q/2, q/2) of each torus word (tfhe_tpu
    numeric.to_signed): the int64 itself at 64 bits, the int32 value of a
    lifted word at 32 (its top bit is the int64's sign bit)."""
    return x if check_log_q(log_q) == 64 else x >> 32


def to_numpy_torus(x: torch.Tensor, log_q: int = LOG_Q) -> np.ndarray:
    """Torus words as the JAX package holds them: uint64 at 64 bits, the
    dropped uint32 words at 32."""
    if check_log_q(log_q) == 64:
        return to_numpy_u64(x)
    return drop32(x).detach().cpu().numpy().astype(np.uint32)


def from_numpy_torus(a, device=None) -> torch.Tensor:
    """The JAX package's torus words → the port's: uint32 words (the 32-bit
    torus) lifted, anything else read as uint64 bit patterns."""
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        return lift32(torch.from_numpy(arr.astype(np.int64))).to(device)
    return from_numpy_u64(arr, device)


def float_round_to_torus(x: torch.Tensor) -> torch.Tensor:
    """Round a float64 tensor (units of q, signed representative) onto the
    torus."""
    return torch.round(x).to(torch.int64)
