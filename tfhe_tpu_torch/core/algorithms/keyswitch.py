"""LWE keyswitching, with the contraction as the CUDA kernel K2.

Counterpart of `tfhe_tpu/core/algorithms/keyswitch.py:68 keyswitch_lwe`:
out = (0, b) - sum_{i,l} d_{i,l} * KSK[i, l].  The JAX package contracts
with an int8-limb XLA dot (`_neg_digit_mac`, :41); the port's contraction is
`csrc/keyswitch.cu` (exact 64-bit multiply-adds, see its header for the
design and what bounds it), with `neg_digit_mac_plain` beside it.
"""
from __future__ import annotations

import torch

from ... import cuda_lib
from ..decomposition import signed_decompose
from ..entities import LweCiphertext, LweKeyswitchKey

# Kernel launches of `neg_digit_mac` (the CUDA branch only).
launches = 0


def neg_digit_mac_plain(digits: torch.Tensor, key: torch.Tensor,
                        body: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """-sum_k digits[b, k] * key[k, m] mod 2^64, plus body[b] at the last
    column.  digits [B, K] integer, key [K, M] int64, body [B] int64 →
    [B, M] int64.  Chunked over K to bound the product buffer, like the
    JAX package's `_neg_digit_mac_chunked` (keyswitch.py:24)."""
    acc = torch.zeros((digits.shape[0], key.shape[1]), dtype=torch.int64,
                      device=key.device)
    d = digits.to(torch.int64)
    for start in range(0, key.shape[0], chunk):
        acc += (d[:, start:start + chunk, None] * key[start:start + chunk]).sum(dim=1)
    out = -acc
    out[:, -1] += body
    return out


def neg_digit_mac(digits: torch.Tensor, key: torch.Tensor,
                  body: torch.Tensor) -> torch.Tensor:
    """K2's wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (or an error: there is no fallback)."""
    if key.device.type == "cpu":
        return neg_digit_mac_plain(digits, key, body)
    if key.device.type != "cuda":
        raise ValueError(f"no keyswitch kernel for device {key.device}")
    global launches
    B, K = digits.shape
    M = key.shape[1]
    if key.shape[0] != K or body.shape != (B,):
        raise ValueError(f"shapes digits {tuple(digits.shape)}, key "
                         f"{tuple(key.shape)}, body {tuple(body.shape)} disagree")
    if key.dtype != torch.int64 or body.dtype != torch.int64:
        raise TypeError("key and body must be int64 torus tensors")
    d32 = digits.to(torch.int32).contiguous()
    key, body = key.contiguous(), body.contiguous()
    for t in (d32, body):
        if t.device != key.device:
            raise ValueError("all operands must be on one device")
    out = torch.empty((B, M), dtype=torch.int64, device=key.device)
    lib = cuda_lib.library()
    code = lib.tfhe_keyswitch_mac(d32.data_ptr(), key.data_ptr(), body.data_ptr(),
                                  out.data_ptr(), B, K, M, cuda_lib.stream_of(key))
    launches += 1
    cuda_lib.check(code, "tfhe_keyswitch_mac")
    return out


def keyswitch_lwe(ct: LweCiphertext, ksk: LweKeyswitchKey) -> LweCiphertext:
    """LWE(n_in) → LWE(n_out)."""
    digits = signed_decompose(ct.mask, ksk.decomp)               # [..., n_in, l]
    batch = tuple(digits.shape[:-2])
    flat = digits.reshape(-1, digits.shape[-2] * digits.shape[-1])
    key = ksk.data.reshape(flat.shape[1], -1)
    out = neg_digit_mac(flat, key, ct.body.reshape(-1))
    return LweCiphertext(data=out.reshape(batch + (key.shape[1],)))
