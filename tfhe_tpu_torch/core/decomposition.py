"""Signed (balanced) gadget decomposition on int64 torus tensors.

Counterpart of `tfhe_tpu/core/decomposition.py`: round the torus element to
the closest multiple of q/B^L, then emit L balanced base-B digits
d_l in [-B/2, B/2] with x ~ sum_l d_l * q/B^(l+1).  Every right shift of a
torus value is logical (`numeric.shr`): the JAX version shifts uint64.
"""
from __future__ import annotations

import torch

from .numeric import LOG_Q, shr
from .params import DecompParams


def signed_decompose(x: torch.Tensor, decomp: DecompParams,
                     log_q: int = LOG_Q) -> torch.Tensor:
    """x: int64 torus [...] → int64 digits [..., L], level-major (index 0 is
    the most significant digit, weight q/B)."""
    b_log, levels = decomp.base_log, decomp.level
    shift = log_q - b_log * levels
    s = shr(x + (1 << (shift - 1)), shift) if shift > 0 else x
    return _balanced_digits(s, b_log, levels)


def _balanced_digits(s: torch.Tensor, b_log: int, levels: int) -> torch.Tensor:
    """Rounded top-bits value s → L balanced base-2^b_log digits, level-major."""
    mask = (1 << b_log) - 1
    half = 1 << (b_log - 1)
    digits_lsb = []
    for _ in range(levels):
        raw = s & mask
        carry = (raw + half) >> b_log            # 1 iff raw >= B/2
        digits_lsb.append(raw - (carry << b_log))
        s = shr(s, b_log) + carry
    return torch.stack(digits_lsb[::-1], dim=-1)


def signed_decompose128(x128: torch.Tensor, decomp: DecompParams) -> torch.Tensor:
    """2^128-modulus decomposition (tfhe_tpu decomposition.py:47): x128
    [..., 2] (hi, lo) → int64 digits [..., L].  base_log * level <= 64, so
    every digit lies in the high limb: below 64 the digits are the 64-bit
    decomposition of hi alone (the rounding constant sits in hi, nothing
    carries out of lo); at exactly 64 lo's top bit is the rounding bit."""
    b_log, levels = decomp.base_log, decomp.level
    shift = 128 - b_log * levels
    if shift < 64:
        raise ValueError(f"base_log * level = {b_log * levels}: at most 64 at a 2^128 modulus")
    hi, lo = x128[..., 0], x128[..., 1]
    if shift > 64:
        s = shr(hi + (1 << (shift - 65)), shift - 64)
    else:
        s = hi + shr(lo, 63)
    return _balanced_digits(s, b_log, levels)
