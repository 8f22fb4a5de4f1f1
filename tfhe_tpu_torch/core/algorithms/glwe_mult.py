"""GLWE x GLWE multiplication with relinearization (the gadget fork's).

Counterpart of `tfhe_tpu/core/algorithms/glwe_mult.py` (reference
tfhe/src/core_crypto/algorithms/custom_glwe_glwe_product.rs and
custom_relinearization_key_generation.rs).  Both operands are switched
down by 32 - log_p/2 bits with rounding (2^(shift-1) added to each word,
wrapping mod 2^64, then a logical shift of the int64 torus words,
`numeric.shr`), multiplied as a tensor product over Z_q[X]/(X^N + 1), and
the s_i*s_j cofactor polynomials are gadget-decomposed and contracted with
the relinearization key.  Every product is `negacyclic_polymul` with the
JAX package's `log_bound`, so the CRT width (and the exact result mod
2^64) is the same.  These are plain torch ops on any device: the JAX
package computes them in XLA, not in a Pallas kernel.

A deliberate deviation from the JAX function (ROADMAP C12): it shifts with
a floor, whose error on the mask words (mean ~kN/4 on every phase
coefficient) the tensor product multiplies by the other phase's wrap
count; at k = 3, N = 512 (AES_PARAMETERS_40) that passes the half slot of
p = 16.  The JAX function reads the operands only through the shift, so
this one equals it on words offset by 2^(shift-1), bit for bit.

RLK block n = i(i+1)/2 + j holds, for the key-polynomial pair (i, j <= i),
`level` GLWE encryptions of s_i*s_j * q/B^(l+1) (level l of weight
q/B^(l+1), as every key layout here).
"""
from __future__ import annotations

import numpy as np
import torch

from ..decomposition import signed_decompose
from ..entities import GlweCiphertext, GlweRelinearizationKey, GlweSecretKey
from ..numeric import LOG_Q, as_i64, shr
from ..params import DecompParams
from ..poly import negacyclic_polymul
from .encryption import encrypt_glwe

__all__ = ["pair_index", "generate_relinearization_key", "glwe_mult"]


def pair_index(i: int, j: int) -> int:
    """n = T_i + j for j <= i."""
    return i * (i + 1) // 2 + j


def generate_relinearization_key(gen: torch.Generator, glwe_sk: GlweSecretKey,
                                 decomp: DecompParams,
                                 noise_std: float) -> GlweRelinearizationKey:
    """Each pair's l GLWE encryptions of s_i*s_j * q/B^(l+1), masks and
    noise from `gen`, on the key's device: data [pairs, l, k+1, N]."""
    k, n = glwe_sk.glwe_dimension, glwe_sk.polynomial_size
    g = torch.tensor([as_i64(1 << (LOG_Q - decomp.base_log * (l + 1)))
                      for l in range(decomp.level)], dtype=torch.int64,
                     device=glwe_sk.bits.device)
    blocks = []
    for i in range(k):
        for j in range(i + 1):
            prod = negacyclic_polymul(glwe_sk.bits[i], glwe_sk.bits[j],
                                      log_bound=np.log2(n) + 2)           # s_i*s_j
            pts = prod.unsqueeze(0) * g.unsqueeze(-1)                     # [l, N]
            blocks.append(encrypt_glwe(gen, glwe_sk, pts, noise_std).data)
    return GlweRelinearizationKey(data=torch.stack(blocks), decomp=decomp)


def glwe_mult(lhs: GlweCiphertext, rhs: GlweCiphertext, rlk: GlweRelinearizationKey,
              log_p: int) -> GlweCiphertext:
    """GLWE(m1) x GLWE(m2) → GLWE(m1*m2) at scale q/2^log_p, for
    power-of-two encodings with log_p even (reference assert).  Operands
    [..., k+1, N] int64."""
    assert log_p % 2 == 0, "log_p must be even (reference assert)"
    shift = 32 - log_p // 2
    # rounded, not truncated (ROADMAP C12): a carry out of the top is the
    # smaller torus wrapping
    half = 1 << (shift - 1)
    a, b = shr(lhs.data + half, shift), shr(rhs.data + half, shift)
    k, n = lhs.data.shape[-2] - 1, lhs.polynomial_size
    # the operands are below 2^(64 - shift): an exact bound for the products
    pair_bound = 2 * (64 - shift) + np.log2(n) + 1

    def mul(x, y):
        return negacyclic_polymul(x, y, log_bound=pair_bound)

    a_mask, a_body = a[..., :k, :], a[..., k, :]
    b_mask, b_body = b[..., :k, :], b[..., k, :]
    # a'_i = a1_i*b2 + a2_i*b1 ; b' = b1*b2
    out_mask = torch.stack([mul(a_mask[..., i, :], b_body) + mul(b_mask[..., i, :], a_body)
                            for i in range(k)], dim=-2)
    out = torch.cat([out_mask, mul(a_body, b_body).unsqueeze(-2)], dim=-2)
    decomp = rlk.decomp
    mac_bound = (decomp.base_log - 1) + LOG_Q + np.log2(n) + 1
    for i in range(k):
        for j in range(i + 1):
            if i == j:
                cof = mul(a_mask[..., i, :], b_mask[..., i, :])
            else:
                cof = (mul(a_mask[..., i, :], b_mask[..., j, :])
                       + mul(a_mask[..., j, :], b_mask[..., i, :]))
            digits = signed_decompose(cof, decomp)                    # [..., N, l]
            block = rlk.data[pair_index(i, j)]                        # [l, k+1, N]
            for l in range(decomp.level):
                out = out + negacyclic_polymul(digits[..., l].unsqueeze(-2), block[l],
                                               log_bound=mac_bound)
    return GlweCiphertext(data=out)
