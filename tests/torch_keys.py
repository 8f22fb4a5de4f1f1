"""Numpy-made key material and ciphertexts shared by the tests that hold
`tfhe_tpu_torch` against `tfhe_tpu` (tests/test_torch_*.py).

Both packages get the same arrays, so neither package's keygen (JAX keygen
costs over a minute at TEST_PARAMS_SHORTINT on a CPU) or random generator
is involved.  `real_keys` are valid encryptions (GGSW rows and KSK rows
with noise at the parameters' std), so results decrypt; `random_bsk` is a
uniform array, enough where only bit-exactness is checked.
"""
from __future__ import annotations

import numpy as np

U64 = np.uint64


def _negacyclic_matrix(bits: np.ndarray) -> np.ndarray:
    """[N, N] u64 matrix S with S @ a = a * s mod (X^N + 1, 2^64) for a
    binary polynomial s."""
    n = bits.shape[-1]
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    k = i - j
    coef = np.where(k >= 0, bits[k % n], -bits[k % n]).astype(np.int64)
    return coef.view(U64)


def glwe_body(mask: np.ndarray, glwe_bits: np.ndarray, pts: np.ndarray,
              noise: np.ndarray) -> np.ndarray:
    """sum_c mask_c * s_c + pts + noise, mask [..., k, N] u64."""
    body = pts + noise
    for c in range(glwe_bits.shape[0]):
        body = body + mask[..., c, :] @ _negacyclic_matrix(glwe_bits[c]).T
    return body


def _noise(rng, shape, std):
    return np.round(rng.normal(0.0, std, size=shape)).astype(np.int64).view(U64)


def real_keys(params, seed: int) -> dict:
    """Secret keys, KSK [kN, l, n+1] and standard BSK [n, l, k+1, k+1, N],
    all u64 / int8 numpy arrays."""
    rng = np.random.default_rng(seed)
    n, k, N = params.lwe_dimension, params.glwe_dimension, params.polynomial_size
    lwe_bits = rng.integers(0, 2, n).astype(np.int8)
    glwe_bits = rng.integers(0, 2, (k, N)).astype(np.int8)
    big_bits = glwe_bits.reshape(-1)

    L, B = params.pbs_level, params.pbs_base_log
    g = np.array([1 << (64 - B * (l + 1)) for l in range(L)], dtype=U64)
    lvl = lwe_bits.astype(U64)[:, None] * g                       # [n, L]
    pts = np.zeros((n, L, k + 1, N), dtype=U64)
    pts[:, :, :k, :] = U64(0) - lvl[:, :, None, None] * glwe_bits.astype(U64)
    pts[:, :, k, 0] = lvl
    mask = rng.integers(0, 2 ** 64, (n, L, k + 1, k, N), dtype=U64)
    body = glwe_body(mask, glwe_bits, pts,
                     _noise(rng, pts.shape, params.glwe_noise_std))
    bsk = np.concatenate([mask, body[..., None, :]], axis=-2)     # [n, L, k+1, k+1, N]

    Lk, Bk = params.ks_level, params.ks_base_log
    gk = np.array([1 << (64 - Bk * (l + 1)) for l in range(Lk)], dtype=U64)
    kpts = big_bits.astype(U64)[:, None] * gk                     # [kN, Lk]
    kmask = rng.integers(0, 2 ** 64, (k * N, Lk, n), dtype=U64)
    kbody = ((kmask * lwe_bits.astype(U64)).sum(axis=-1, dtype=U64) + kpts
             + _noise(rng, kpts.shape, params.lwe_noise_std))
    ksk = np.concatenate([kmask, kbody[..., None]], axis=-1)      # [kN, Lk, n+1]
    return dict(lwe_bits=lwe_bits, glwe_bits=glwe_bits, big_bits=big_bits,
                bsk=bsk, ksk=ksk)


def random_bsk(params, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n, k, N, L = (params.lwe_dimension, params.glwe_dimension,
                  params.polynomial_size, params.pbs_level)
    return rng.integers(0, 2 ** 64, (n, L, k + 1, k + 1, N), dtype=U64)


def encrypt_big(params, big_bits: np.ndarray, msgs, seed: int) -> np.ndarray:
    """Shortint encryptions [B, kN+1] of msgs under the big key."""
    rng = np.random.default_rng(seed)
    msgs = np.asarray(msgs, dtype=U64)
    delta = U64((1 << 64) // (2 * params.message_modulus * params.carry_modulus))
    mask = rng.integers(0, 2 ** 64, msgs.shape + big_bits.shape, dtype=U64)
    body = ((mask * big_bits.astype(U64)).sum(axis=-1, dtype=U64) + msgs * delta
            + _noise(rng, msgs.shape, params.glwe_noise_std))
    return np.concatenate([mask, body[..., None]], axis=-1)


def decrypt_big(params, big_bits: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Message and carry of shortint ciphertexts [..., kN+1] (u64)."""
    delta = (1 << 64) // (2 * params.message_modulus * params.carry_modulus)
    phase = data[..., -1] - (data[..., :-1] * big_bits.astype(U64)).sum(axis=-1, dtype=U64)
    space = 2 * params.message_modulus * params.carry_modulus
    return ((phase + U64(delta >> 1)) // U64(delta)) % U64(space)
