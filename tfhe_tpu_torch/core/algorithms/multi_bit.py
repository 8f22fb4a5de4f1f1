"""Multi-bit programmable bootstrapping: key generation, the key's
conversion into the port's spectra, and the multi-bit blind rotation.

Counterpart of `tfhe_tpu/core/algorithms/multi_bit.py`.  Groups of g key
bits share one rotation step.  The key holds, per group j, 2^g GGSWs where
GGSW_{j,v} encrypts the indicator prod_i (s_i if bit i of v else 1 - s_i),
1 exactly when the group's key bits spell v (the MSB of v is the group's
first bit).  A step computes

    acc <- (sum_v X^{c_v} * GGSW_{j,v}) [x] acc,   c_v = sum_{i: v_i = 1} a~_{jg+i},

since the bracketed sum encrypts X^{sum_i a~_i s_i}.  The rotation is
`poly/rotation.py`'s multi-bit form: the CUDA kernel K3 on the card, or K5
once per step on the per-step route.
"""
from __future__ import annotations

import torch

from ... import config
from ..entities import (GlweCiphertext, GlweSecretKey, LweCiphertext,
                        LweMultiBitBootstrapKey, LweSecretKey, NttMultiBitBootstrapKey)
from .. import threefry
from ..params import DecompParams
from ..poly import ntt
from ..poly.rotation import blind_rotate_fused_multi_bit
from .encryption import encrypt_constant_ggsw, encrypt_constant_ggsw_from_key, ggsw_spectra


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


def generate_multi_bit_bootstrap_key_from_key(key: torch.Tensor, gen: torch.Generator,
                                              lwe_sk: LweSecretKey, glwe_sk: GlweSecretKey,
                                              decomp: DecompParams, grouping_factor: int,
                                              noise_std: float) -> LweMultiBitBootstrapKey:
    """`generate_multi_bit_bootstrap_key` with the masks of tfhe_tpu
    generate_multi_bit_bootstrap_key(key, ...): GGSW (j, v) under
    split(key, n/g * 2^g)[j * 2^g + v]; noise from gen."""
    msgs = indicator_messages(lwe_sk.bits, grouping_factor)      # [n/g, 2^g]
    keys = threefry.split(key, msgs.numel()).view(tuple(msgs.shape) + (2,))
    return LweMultiBitBootstrapKey(
        data=encrypt_constant_ggsw_from_key(keys, gen, glwe_sk, msgs, decomp, noise_std),
        decomp=decomp, grouping_factor=grouping_factor)


def multi_bit_bootstrap_key_to_ntt(bsk: LweMultiBitBootstrapKey,
                                   num_primes: int) -> NttMultiBitBootstrapKey:
    """Standard multi-bit BSK → the port's spectra [n/g, 2^g, P, J, R, N]
    (each GGSW converted as `bootstrap_key_to_ntt` converts a classic one),
    recording the route the switches choose now (`multi_bit_key_route`)."""
    ng, nv = bsk.data.shape[:2]
    n = bsk.data.shape[-1]
    spectra = ggsw_spectra(bsk.data.reshape((ng * nv,) + bsk.data.shape[2:]), num_primes)
    return NttMultiBitBootstrapKey(
        spectra=spectra.reshape((ng, nv) + spectra.shape[1:]), decomp=bsk.decomp,
        primes=ntt.get_plan(n, num_primes).primes, grouping_factor=bsk.grouping_factor,
        route=multi_bit_key_route())


def multi_bit_key_route() -> str:
    """The route a multi-bit key converted now is recorded for (tfhe_tpu
    multi_bit.py:124-139): "steps" when MXU is off (the JAX "dif" key) or
    lanes are on ("fourstep-lanes"), else "fused" ("fourstep")."""
    return "fused" if config.use_mxu_ntt() and not config.use_mxu_lanes() else "steps"


def multi_bit_blind_rotate(lut: GlweCiphertext, lwe: LweCiphertext,
                           bsk: NttMultiBitBootstrapKey) -> GlweCiphertext:
    """Blind rotation with grouped mask bits (tfhe_tpu multi_bit.py:184) in
    its fused form (`blind_rotate_fused(mode="multibit")`, K3).  The shortint
    server routes by the key and the switches (`ServerKey._pbs`)."""
    return GlweCiphertext(data=blind_rotate_fused_multi_bit(lut.data, lwe.data, bsk))
