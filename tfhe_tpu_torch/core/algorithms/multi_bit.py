"""Multi-bit programmable bootstrapping: key generation, the key's
conversion into the port's spectra, and the multi-bit blind rotation.

Counterpart of `tfhe_tpu/core/algorithms/multi_bit.py`.  Groups of g key
bits share one rotation step.  The key holds, per group j, 2^g GGSWs where
GGSW_{j,v} encrypts the indicator prod_i (s_i if bit i of v else 1 - s_i),
1 exactly when the group's key bits spell v (the MSB of v is the group's
first bit).  A step computes

    acc <- (sum_v X^{c_v} * GGSW_{j,v}) [x] acc,   c_v = sum_{i: v_i = 1} a~_{jg+i},

since the bracketed sum encrypts X^{sum_i a~_i s_i}.  The rotation is
`poly/rotation.py`'s multi-bit form (the CUDA kernel K3 on the card).
"""
from __future__ import annotations

import torch

from ..entities import (GlweCiphertext, GlweSecretKey, LweBootstrapKey, LweCiphertext,
                        LweMultiBitBootstrapKey, LweSecretKey, NttMultiBitBootstrapKey)
from ..params import DecompParams
from ..poly.rotation import blind_rotate_fused_multi_bit
from .encryption import bootstrap_key_to_ntt, encrypt_constant_ggsw


def indicator_messages(bits: torch.Tensor, grouping_factor: int) -> torch.Tensor:
    """Key bits [n] → the GGSW messages [n/g, 2^g]: entry (j, v) is
    prod_i (s_{jg+i} if bit (g-1-i) of v else 1 - s_{jg+i})
    (tfhe_tpu multi_bit.py:94-101)."""
    g = grouping_factor
    if bits.shape[-1] % g:
        raise ValueError(f"lwe_dimension {bits.shape[-1]} is not a multiple of "
                         f"the grouping factor {g}")
    grp = bits.to(torch.int64).reshape(-1, 1, g)                 # [n/g, 1, g]
    v_bits = torch.tensor([[(v >> (g - 1 - i)) & 1 for i in range(g)]
                           for v in range(1 << g)], dtype=torch.int64,
                          device=bits.device)                    # [2^g, g]
    return torch.where(v_bits == 1, grp, 1 - grp).prod(dim=-1)


def generate_multi_bit_bootstrap_key(gen: torch.Generator, lwe_sk: LweSecretKey,
                                     glwe_sk: GlweSecretKey, decomp: DecompParams,
                                     grouping_factor: int,
                                     noise_std: float) -> LweMultiBitBootstrapKey:
    """Standard-domain multi-bit BSK [n/g, 2^g, l, k+1, k+1, N], every GGSW
    encrypted in one batched call."""
    msgs = indicator_messages(lwe_sk.bits, grouping_factor)      # [n/g, 2^g]
    data = encrypt_constant_ggsw(gen, glwe_sk, msgs.reshape(-1), decomp, noise_std)
    return LweMultiBitBootstrapKey(data=data.reshape(tuple(msgs.shape) + data.shape[1:]),
                                   decomp=decomp, grouping_factor=grouping_factor)


def multi_bit_bootstrap_key_to_ntt(bsk: LweMultiBitBootstrapKey,
                                   num_primes: int) -> NttMultiBitBootstrapKey:
    """Standard multi-bit BSK → the port's spectra [n/g, 2^g, P, J, R, N]
    (each GGSW converted as `bootstrap_key_to_ntt` converts a classic one)."""
    ng, nv = bsk.data.shape[:2]
    flat = bootstrap_key_to_ntt(
        LweBootstrapKey(data=bsk.data.reshape((ng * nv,) + bsk.data.shape[2:]),
                        decomp=bsk.decomp), num_primes)
    return NttMultiBitBootstrapKey(
        spectra=flat.spectra.reshape((ng, nv) + flat.spectra.shape[1:]),
        decomp=bsk.decomp, primes=flat.primes, grouping_factor=bsk.grouping_factor)


def multi_bit_blind_rotate(lut: GlweCiphertext, lwe: LweCiphertext,
                           bsk: NttMultiBitBootstrapKey) -> GlweCiphertext:
    """Blind rotation with grouped mask bits (tfhe_tpu multi_bit.py:184),
    always in its fused form (`blind_rotate_fused(mode="multibit")`)."""
    return GlweCiphertext(data=blind_rotate_fused_multi_bit(lut.data, lwe.data, bsk))
