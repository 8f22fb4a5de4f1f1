"""LWE public keys: the list-of-zeros key and the compact (polynomial) key.

Counterpart of `tfhe_tpu/core/algorithms/public_key.py` (reference
entities/lwe_public_key.rs, lwe_compact_public_key.rs and
algorithms/lwe_encryption.rs).  A public key holds m encryptions of zero;
encrypting with it adds a random binary subset of them to (0, m).  The
subset is `threefry.binary_key`, so an encryption under the same key and
threefry key is bit-identical to the JAX package's.  The compact key is one
pair (a(X), b(X) = a*s + e): a batch of up to N ciphertexts comes from one
binary r(X) through negacyclic products; r is bit-exact, the noise e1, e2
comes from a torch generator.

The subset sum is K2′'s contraction (`keyswitch.neg_digit_mac_tensor_core`)
with one level and digits in {0, 1}: on the card it reads the key's byte
limbs (`LwePublicKey.limbs`) and never builds the [batch, m, n+1] product
the JAX form materialises (3.6 GB of int64 at DEFAULT_PARAMETERS_KS_PBS,
batch 512); on the CPU it is the plain chunked sum.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import rng, threefry
from ..entities import LweCiphertext, LweSecretKey
from ..numeric import LOG_Q
from ..poly.ntt import negacyclic_polymul
from .encryption import encrypt_lwe_from_key
from .keyswitch import limb_layout, neg_digit_mac_tensor_core, padded_depth


@dataclass(frozen=True)
class LwePublicKey:
    """zero_count LWE encryptions of 0: data [m, n+1]."""

    data: torch.Tensor
    log_q: int = LOG_Q

    @property
    def zero_encryption_count(self) -> int:
        return self.data.shape[0]

    @property
    def lwe_dimension(self) -> int:
        return self.data.shape[-1] - 1

    @functools.cached_property
    def limbs(self) -> Optional[torch.Tensor]:
        """The key's words as bytes for K2′ ([n+1, 8, mp] uint8,
        `keyswitch.limb_layout`), built once on the card; None elsewhere.
        A subset sum with digits in {0, 1} keeps every limb sum under m * 255,
        inside K2′'s int32 for any m below 2^23."""
        if self.data.device.type != "cuda":
            return None
        if self.zero_encryption_count * 255 >= 1 << 31:
            raise ValueError(f"{self.zero_encryption_count} encryptions of zero overflow "
                             f"K2′'s int32 limb sums")
        return limb_layout(self.data)


@dataclass(frozen=True)
class LweCompactPublicKey:
    """(a(X), b(X)) with b = a*s + e over Z_q[X]/(X^N+1): data [2, N],
    N = lwe_dimension."""

    data: torch.Tensor
    log_q: int = LOG_Q

    @property
    def lwe_dimension(self) -> int:
        return self.data.shape[-1]


def generate_lwe_public_key(key: torch.Tensor, gen: torch.Generator, sk: LweSecretKey,
                            zero_count: int, noise_std: float,
                            log_q: int = LOG_Q) -> LwePublicKey:
    """zero_count encryptions of zero, masks as tfhe_tpu
    generate_lwe_public_key(key, ...) draws them (lifted 32-bit words at
    log_q = 32), noise from gen."""
    zeros = torch.zeros((zero_count,), dtype=torch.int64, device=sk.bits.device)
    return LwePublicKey(data=encrypt_lwe_from_key(key, gen, sk, zeros, noise_std, log_q).data,
                        log_q=log_q)


def encrypt_lwe_with_public_key(key: torch.Tensor, pk: LwePublicKey,
                                plaintexts: torch.Tensor) -> LweCiphertext:
    """ct = sum over the subset binary_key(key, plaintexts.shape + (m,)) of
    the key's rows, plus (0, plaintext): [..., n+1], bit-identical to
    tfhe_tpu encrypt_lwe_with_public_key.  K2′ computes -sum + body, so it
    is given body -plaintext and its output negated."""
    shape = tuple(plaintexts.shape)
    m = pk.zero_encryption_count
    sel = threefry.binary_key(key, shape + (m,)).reshape(-1, m)
    digits = F.pad(sel.to(torch.int8), (0, padded_depth(m) - m))
    out = neg_digit_mac_tensor_core(digits, pk.data, pk.limbs, -plaintexts.reshape(-1), 1)
    return LweCiphertext(data=(-out).reshape(shape + (pk.lwe_dimension + 1,)))


def generate_lwe_compact_public_key(key: torch.Tensor, gen: torch.Generator,
                                    sk: LweSecretKey, noise_std: float) -> LweCompactPublicKey:
    """a from split(key)[0] as tfhe_tpu generate_lwe_compact_public_key
    draws it, e from gen; the LWE dimension must be a power of two."""
    n = sk.lwe_dimension
    if n & (n - 1):
        raise ValueError(f"a compact public key needs a power-of-two LWE dimension, not {n}")
    a = threefry.uniform_torus(threefry.split(key)[0], (n,))
    e = rng.gaussian_noise(gen, (n,), noise_std)
    b = negacyclic_polymul(a, sk.bits, log_bound=LOG_Q + np.log2(n) + 1) + e
    return LweCompactPublicKey(data=torch.stack([a, b]))


def encrypt_lwe_compact_batch(key: torch.Tensor, gen: torch.Generator,
                              pk: LweCompactPublicKey, plaintexts: torch.Tensor,
                              noise_std: float) -> LweCiphertext:
    """Up to N plaintexts [..., m] under one binary r(X) (r from
    split(key, 3)[0], as tfhe_tpu encrypt_lwe_compact_batch draws it; e1, e2
    from gen) → LweCiphertext [..., m, N+1]: ciphertext i is coefficient i
    of (a*r + e1, b*r + e2 + sum_j m_j X^j), its mask read negacyclically."""
    lead, m = tuple(plaintexts.shape[:-1]), plaintexts.shape[-1]
    n = pk.lwe_dimension
    if m > n:
        raise ValueError(f"{m} plaintexts exceed the compact key's {n} slots")
    r = threefry.binary_key(threefry.split(key, 3)[0], lead + (n,))
    e1 = rng.gaussian_noise(gen, lead + (n,), noise_std)
    e2 = rng.gaussian_noise(gen, lead + (n,), noise_std)
    bound = LOG_Q + np.log2(n) + 1
    mask_poly = negacyclic_polymul(pk.data[0], r, log_bound=bound) + e1
    body_poly = negacyclic_polymul(pk.data[1], r, log_bound=bound) + e2
    body_poly = body_poly + F.pad(plaintexts, (0, n - m))
    i = torch.arange(m, device=r.device)[:, None]
    j = torch.arange(n, device=r.device)[None, :]
    gathered = mask_poly[..., (i - j) % n]                          # [..., m, n]
    masks = torch.where(j > i, -gathered, gathered)
    return LweCiphertext(data=torch.cat([masks, body_poly[..., :m, None]], dim=-1))


__all__ = ["LwePublicKey", "LweCompactPublicKey", "generate_lwe_public_key",
           "encrypt_lwe_with_public_key", "generate_lwe_compact_public_key",
           "encrypt_lwe_compact_batch"]
