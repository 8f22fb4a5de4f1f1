"""GSW ciphertexts: the polynomial-size-1 case of GGSW.

Counterpart of `tfhe_tpu/core/algorithms/gsw.py` (the reference's
entities/gsw_ciphertext.rs leaves the primitives unimplemented): constant
encryption and the GSW [x] LWE external product, the scalar analogue of the
GLWE external product, so an encrypted bit selects between LWEs without
polynomials.

Layout: data [l, n+1, n+1], level-major; row r (< n) of level j is an LWE
of -m * s_r * q/B^(j+1), the last row of +m * q/B^(j+1).  The contraction
is an elementwise product and sum on int64 tensors, wrapping mod 2^64, as
the JAX version's (a u64 dot has no kernel there, nor an int64 matmul on
the card).
"""
from __future__ import annotations

import torch

from ..decomposition import signed_decompose
from ..entities import GswCiphertext, LweCiphertext, LweSecretKey
from ..numeric import LOG_Q, as_i64
from ..params import DecompParams
from .encryption import encrypt_lwe

__all__ = ["encrypt_constant_gsw", "gsw_external_product", "cmux_lwe"]


def encrypt_constant_gsw(gen: torch.Generator, sk: LweSecretKey, msg: int,
                         decomp: DecompParams, noise_std: float) -> GswCiphertext:
    """GSW of a small constant message under an LWE key: every gadget row a
    fresh LWE encryption of its body-encoded plaintext, masks and noise from
    `gen`, on the key's device."""
    n, levels = sk.lwe_dimension, decomp.level
    g = torch.tensor([as_i64(1 << (LOG_Q - decomp.base_log * (l + 1)))
                      for l in range(levels)], dtype=torch.int64, device=sk.bits.device)
    lvl = int(msg) * g                                                # [l]
    pts = torch.cat([-(lvl.unsqueeze(-1) * sk.bits), lvl.unsqueeze(-1)], dim=-1)  # [l, n+1]
    rows = encrypt_lwe(gen, sk, pts.reshape(-1), noise_std).data
    return GswCiphertext(data=rows.reshape(levels, n + 1, n + 1), decomp=decomp)


def gsw_external_product(gsw: GswCiphertext, ct: LweCiphertext) -> LweCiphertext:
    """<G^-1(ct), GSW> → LWE of m * pt: the balanced digits of every
    coefficient of ct [..., n+1] contracted with the gadget rows (wrapping
    mod 2^64); batched over ct's leading axes."""
    digits = signed_decompose(ct.data, gsw.decomp)                    # [..., n+1, L]
    rows = gsw.data.movedim(0, 1)                                     # [n+1, L, n+1]
    return LweCiphertext(data=(digits.unsqueeze(-1) * rows).sum(dim=(-3, -2)))


def cmux_lwe(gsw: GswCiphertext, ct0: LweCiphertext, ct1: LweCiphertext) -> LweCiphertext:
    """ct0 + GSW(b) [x] (ct1 - ct0): ct1 where the encrypted bit is 1."""
    sel = gsw_external_product(gsw, LweCiphertext(data=ct1.data - ct0.data))
    return LweCiphertext(data=ct0.data + sel.data)
