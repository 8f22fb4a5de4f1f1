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
