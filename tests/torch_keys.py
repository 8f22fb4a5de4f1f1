"""Numpy-made key material and ciphertexts shared by the tests that hold
`tfhe_tpu_torch` against `tfhe_tpu` (tests/test_torch_*.py).

Both packages get the same arrays, so neither package's keygen (JAX keygen
costs over a minute at TEST_PARAMS_SHORTINT on a CPU) or random generator
is involved.  `real_keys` and `real_multi_bit_keys` are valid encryptions
(GGSW rows and KSK rows with noise at the parameters' std), so results
decrypt; `random_bsk` and `random_multi_bit_bsk` are uniform arrays, enough
where only bit-exactness is checked.
"""
from __future__ import annotations

import dataclasses

import numpy as np

U64 = np.uint64


def multi_bit_params(cls, base, g: int, n: int):
    """A multi-bit copy (class `cls`, either package's) of the classic set
    `base`, with grouping g and lwe_dimension n."""
    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)
              if f.name not in ("name", "ciphertext_modulus", "lwe_dimension")}
    return cls(name=f"TEST_PARAMS_MULTIBIT_G{g}", grouping_factor=g, lwe_dimension=n,
               **fields)


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


def ggsw(rng, params, glwe_bits: np.ndarray, msgs: np.ndarray) -> np.ndarray:
    """GGSW encryptions [..., l, k+1, k+1, N] of small integers msgs [...]
    under the GLWE key: row (l, r < k) encrypts -m*g_l*S_r, row (l, k) the
    constant m*g_l, with g_l = q/B^(l+1)."""
    k, N = params.glwe_dimension, params.polynomial_size
    L, B = params.pbs_level, params.pbs_base_log
    g = np.array([1 << (64 - B * (l + 1)) for l in range(L)], dtype=U64)
    lvl = np.asarray(msgs).astype(U64)[..., None] * g              # [..., L]
    pts = np.zeros(lvl.shape + (k + 1, N), dtype=U64)
    pts[..., :k, :] = U64(0) - lvl[..., None, None] * glwe_bits.astype(U64)
    pts[..., k, 0] = lvl
    mask = rng.integers(0, 2 ** 64, lvl.shape + (k + 1, k, N), dtype=U64)
    body = glwe_body(mask, glwe_bits, pts,
                     _noise(rng, pts.shape, params.glwe_noise_std))
    return np.concatenate([mask, body[..., None, :]], axis=-2)


def indicator_messages(lwe_bits: np.ndarray, grouping: int) -> np.ndarray:
    """[n/g, 2^g]: entry (j, v) is prod_i (s_{jg+i} if bit (g-1-i) of v else
    1 - s_{jg+i}), 1 exactly where the group's key bits spell v."""
    grp = lwe_bits.astype(np.int64).reshape(-1, grouping)
    out = np.ones((grp.shape[0], 1 << grouping), dtype=np.int64)
    for v in range(1 << grouping):
        for i in range(grouping):
            bit = (v >> (grouping - 1 - i)) & 1
            out[:, v] *= grp[:, i] if bit else 1 - grp[:, i]
    return out


def _secret_keys(rng, params):
    lwe_bits = rng.integers(0, 2, params.lwe_dimension).astype(np.int8)
    glwe_bits = rng.integers(0, 2, (params.glwe_dimension,
                                    params.polynomial_size)).astype(np.int8)
    return lwe_bits, glwe_bits


def _ksk(rng, params, big_bits, lwe_bits) -> np.ndarray:
    Lk, Bk = params.ks_level, params.ks_base_log
    gk = np.array([1 << (64 - Bk * (l + 1)) for l in range(Lk)], dtype=U64)
    kpts = big_bits.astype(U64)[:, None] * gk                     # [kN, Lk]
    kmask = rng.integers(0, 2 ** 64, (big_bits.size, Lk, lwe_bits.size), dtype=U64)
    kbody = ((kmask * lwe_bits.astype(U64)).sum(axis=-1, dtype=U64) + kpts
             + _noise(rng, kpts.shape, params.lwe_noise_std))
    return np.concatenate([kmask, kbody[..., None]], axis=-1)      # [kN, Lk, n+1]


def real_keys(params, seed: int) -> dict:
    """Secret keys, KSK [kN, l, n+1] and standard BSK [n, l, k+1, k+1, N],
    all u64 / int8 numpy arrays."""
    rng = np.random.default_rng(seed)
    lwe_bits, glwe_bits = _secret_keys(rng, params)
    big_bits = glwe_bits.reshape(-1)
    bsk = ggsw(rng, params, glwe_bits, lwe_bits)                 # [n, L, k+1, k+1, N]
    ksk = _ksk(rng, params, big_bits, lwe_bits)
    return dict(lwe_bits=lwe_bits, glwe_bits=glwe_bits, big_bits=big_bits,
                bsk=bsk, ksk=ksk)


def real_multi_bit_keys(params, seed: int) -> dict:
    """As `real_keys`, with the multi-bit BSK [n/g, 2^g, l, k+1, k+1, N] of
    GGSWs of the indicator messages."""
    rng = np.random.default_rng(seed)
    lwe_bits, glwe_bits = _secret_keys(rng, params)
    big_bits = glwe_bits.reshape(-1)
    bsk = ggsw(rng, params, glwe_bits,
               indicator_messages(lwe_bits, params.grouping_factor))
    ksk = _ksk(rng, params, big_bits, lwe_bits)
    return dict(lwe_bits=lwe_bits, glwe_bits=glwe_bits, big_bits=big_bits,
                bsk=bsk, ksk=ksk)


def random_bsk(params, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n, k, N, L = (params.lwe_dimension, params.glwe_dimension,
                  params.polynomial_size, params.pbs_level)
    return rng.integers(0, 2 ** 64, (n, L, k + 1, k + 1, N), dtype=U64)


def random_multi_bit_bsk(params, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g, k, N, L = (params.grouping_factor, params.glwe_dimension,
                  params.polynomial_size, params.pbs_level)
    return rng.integers(0, 2 ** 64, (params.lwe_dimension // g, 1 << g, L, k + 1, k + 1, N),
                        dtype=U64)


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


# ---------------------------------------------------------------------------
# Python-integer reference arithmetic for the step-formula tests
# ---------------------------------------------------------------------------


def int_digits(x: int, decomp) -> list:
    """Balanced digits of a u64 torus value, most significant first."""
    base, L = decomp.base_log, decomp.level
    shift = 64 - base * L
    s = ((x + (1 << (shift - 1))) % 2 ** 64) >> shift
    out = []
    for _ in range(L):
        raw = s & ((1 << base) - 1)
        carry = (raw + (1 << (base - 1))) >> base
        out.append(raw - (carry << base))
        s = (s >> base) + carry
    return out[::-1]


def int_polymul(a: list, b: list) -> list:
    """Negacyclic product of integer polynomials (no reduction)."""
    n = len(a)
    c = [0] * n
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            k = i + j
            c[k % n] += ai * bj if k < n else -ai * bj
    return c


def int_monomial(e: int, n: int) -> list:
    """X^e mod X^N + 1 for e in [0, 2N)."""
    mono = [0] * n
    if e < n:
        mono[e] = 1
    else:
        mono[e - n] = -1
    return mono


def int_external_product(acc: list, ggsw: list, decomp) -> list:
    """sum_{l,r} decomp_l(acc_r) * ggsw[l][r][c] for each output c, in
    integers; acc [R][N], ggsw [l][R][R][N]."""
    n, R = len(acc[0]), len(acc)
    total = [[0] * n for _ in range(R)]
    for r, poly in enumerate(acc):
        dig = [int_digits(x, decomp) for x in poly]              # [N][L]
        for l in range(decomp.level):
            d_poly = [dig[k][l] for k in range(n)]
            for c in range(R):
                prod = int_polymul(d_poly, ggsw[l][r][c])
                total[c] = [t + v for t, v in zip(total[c], prod)]
    return total
