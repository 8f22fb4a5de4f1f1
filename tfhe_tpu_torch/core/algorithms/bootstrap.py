"""Programmable bootstrapping: modulus switch, blind rotation, sample
extraction and the PBS entry point (classic keys).

Counterpart of `tfhe_tpu/core/algorithms/bootstrap.py`.  The blind rotation
is one of the JAX package's kernel routes, chosen as it chooses them
(`config.py`): the fused delta form (K1), the per-step delta form (K4) or
the per-step paired form (K5), never the rotate-subtract form of the JAX
XLA `blind_rotate`, which differs in low bits (hazard C4 in ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from ... import config
from ..entities import GlweCiphertext, LweCiphertext, NttBootstrapKey
from ..params import DecompParams
from ..poly.ntt import required_num_primes
from ..poly.rotation import blind_rotate_fused, blind_rotate_steps, modulus_switch

__all__ = ["external_product_num_primes", "modulus_switch", "sample_extract",
           "programmable_bootstrap"]


def external_product_num_primes(n: int, glwe_size: int, decomp: DecompParams,
                                log_q: int = 64) -> int:
    """CRT width for the external-product MAC: per output coefficient the
    integer convolution is bounded by N * J * B/2 * 2^log_q."""
    j = decomp.level * glwe_size
    log_bound = np.log2(n) + np.log2(j) + (decomp.base_log - 1) + log_q
    return required_num_primes(log_bound, n)


def sample_extract(glwe: GlweCiphertext, index: int = 0) -> LweCiphertext:
    """Coefficient `index` as an LWE ciphertext under the flattened GLWE key:
    a_{i*N + j} = mask_i[index - j] for j <= index, -mask_i[N + index - j]
    for j > index; body = body_poly[index]."""
    n = glwe.polynomial_size
    j = torch.arange(n, device=glwe.data.device)
    src = torch.remainder(index - j, n)
    rows = glwe.mask[..., :, src]                            # [..., k, N]
    rows = torch.where(j > index, -rows, rows)
    flat = rows.reshape(tuple(rows.shape[:-2]) + (-1,))
    body = glwe.body[..., index]
    return LweCiphertext(data=torch.cat([flat, body.unsqueeze(-1)], dim=-1))


def programmable_bootstrap(lwe: LweCiphertext, lut: GlweCiphertext,
                           bsk: NttBootstrapKey) -> LweCiphertext:
    """Mod-switch → blind rotate → sample-extract coefficient 0.  The
    rotation routes as tfhe_tpu bootstrap.py:148-165 does: a key converted
    for the fused route runs K1 while `use_fused_rotation()` is on; every
    other key, or that key with the switch off, runs one step per launch
    (`blind_rotate_steps`: K4, or K5 for a paired key)."""
    if bsk.route == "fused" and config.use_fused_rotation():
        rotated = blind_rotate_fused(lut.data, lwe.data, bsk)
    else:
        rotated = blind_rotate_steps(lut.data, lwe.data, bsk)
    return sample_extract(GlweCiphertext(data=rotated), 0)
