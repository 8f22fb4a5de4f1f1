"""LWE under a non-native (custom) ciphertext modulus q < 2^64.

Counterpart of `tfhe_tpu/core/algorithms/nonnative.py` (reference
`CiphertextModulus::Custom` in lwe_encryption.rs :148-163 and
lwe_linear_algebra.rs :105, :314; `SignedDecomposerNonNative`,
decomposer.rs:203-410, iter.rs:237-282, term.rs:140-156).  Ciphertext
words are values in [0, q) held as int64 bit patterns (q may exceed 2^63:
every compare is unsigned, `numeric.ult`/`uge`, and every division
`numeric.udiv`).  The arithmetic is the JAX package's word for word but
for one deliberate deviation (ROADMAP C13): where q > 2^63, the JAX
function's a + b of two words below q may pass 2^64 and wrap before the
reduction; `add_mod` here compares a with q - b first, so every sum is a
sum mod q.  The decomposition's rounding adds through it too, where the
JAX function's wrap changes no result (C14).  These are cold client-side
paths, as in the
JAX package: the 128-bit reductions of `uniform_mod` and the scalar
products run on the host in Python ints.

Masks are threefry bits, those of the JAX package under the same key
(`uniform_mod`: jax.random.bits of 64-bit words, twice); the noise comes
from a torch generator.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import threefry
from ..entities import LweCiphertext, LweSecretKey
from ..numeric import as_i64, shr, udiv, uge

_M32 = 0xFFFFFFFF


def _check_q(q: int) -> None:
    if not 1 < q < 1 << 64:
        raise ValueError(f"a custom modulus must lie in (1, 2^64), not {q}")


def _bits64(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.bits(key, shape, uint64) under partitionable threefry:
    element e is (out0 << 32) | out1 of the counter pair (hi(e), lo(e))."""
    size = int(np.prod(shape, dtype=np.int64))
    ctr = torch.arange(size, dtype=torch.int64, device=key.device)
    out0, out1 = threefry.threefry2x32(key[..., 0], key[..., 1], ctr >> 32, ctr & _M32)
    return ((out0 << 32) | out1).reshape(tuple(shape))


def _from_ints(values: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, dtype=object).astype(np.uint64)
                            .view(np.int64).copy()).to(device)


def _to_ints(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().view(np.uint64).astype(object)


def umod(x: torch.Tensor, q: int) -> torch.Tensor:
    """Unsigned x mod q for int64 bit patterns."""
    return x - udiv(x, q) * as_i64(q)


def uniform_mod(key: torch.Tensor, shape, q: int) -> torch.Tensor:
    """Uniform values in [0, q): 128 threefry bits (under key and
    fold_in(key, 1)) reduced mod q, those of tfhe_tpu uniform_mod."""
    hi = _to_ints(_bits64(key, shape))
    lo = _to_ints(_bits64(threefry.fold_in(key, 1), shape))
    return _from_ints(((hi << 64) | lo) % q, key.device)


def gaussian_mod(gen: torch.Generator, shape, rel_std: float, q: int) -> torch.Tensor:
    """A rounded gaussian of std-dev rel_std * q, taken into [0, q)."""
    if rel_std == 0.0:
        return torch.zeros(tuple(shape), dtype=torch.int64, device=gen.device)
    n = torch.randn(tuple(shape), generator=gen, dtype=torch.float64, device=gen.device)
    r = torch.round(n * (rel_std * q)).to(torch.int64)
    return torch.where(r < 0, r + as_i64(q), r)


def add_mod(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """a + b mod q for words a, b in [0, q): a - (q - b) where a >= q - b,
    else a + b, so nothing passes 2^64 (ROADMAP C13)."""
    rest = as_i64(q) - b
    return torch.where(uge(a, rest), a - rest, a + b)


def sub_mod(a: torch.Tensor, b, q: int) -> torch.Tensor:
    b = torch.as_tensor(b, device=a.device)
    return torch.where(uge(a, b), a - b, a + as_i64(q) - b)


def neg_mod(a: torch.Tensor, q: int) -> torch.Tensor:
    return torch.where(a == 0, a, as_i64(q) - a)


def mul_scalar_mod(a: torch.Tensor, c: int, q: int) -> torch.Tensor:
    """a * c mod q for a clear scalar c, exact (host Python ints)."""
    return _from_ints((_to_ints(a) * (int(c) % q)) % q, a.device)


def _dot_key_mod(mask: torch.Tensor, bits: torch.Tensor, q: int) -> torch.Tensor:
    """sum_i a_i s_i mod q for a binary key, summed in the JAX function's
    order (a scan of `add_mod` over i)."""
    sel = torch.where(bits != 0, mask, torch.zeros_like(mask))
    acc = torch.zeros(mask.shape[:-1], dtype=torch.int64, device=mask.device)
    for i in range(mask.shape[-1]):
        acc = add_mod(acc, sel[..., i], q)
    return acc


def _plaintexts(plaintexts, q: int, device) -> torch.Tensor:
    """Plaintexts (a tensor of int64 bit patterns, or integers below 2^64)
    reduced mod q as unsigned words."""
    if not isinstance(plaintexts, torch.Tensor):
        arr = np.asarray(plaintexts, dtype=object) % (1 << 64)
        plaintexts = torch.from_numpy(arr.astype(np.uint64).view(np.int64).copy())
    return umod(plaintexts.to(device=device, dtype=torch.int64), q)


def encrypt_lwe_custom_mod(key: torch.Tensor, gen: torch.Generator, sk: LweSecretKey,
                           plaintexts, rel_std: float, q: int) -> LweCiphertext:
    """Plaintexts of Z_q [...] → LWE [..., n+1] under modulus q (tfhe_tpu
    nonnative.py:114): the mask uniform_mod under split(key)[0], the noise
    from gen."""
    _check_q(q)
    pts = _plaintexts(plaintexts, q, sk.bits.device)
    body, mask = _mask_and_body(key, gen, sk, pts, rel_std, q)
    return LweCiphertext(data=torch.cat([mask, body], dim=-1))


def _mask_and_body(key, gen, sk, pts, rel_std, q) -> tuple:
    """(bodies [..., 1], masks [..., n])."""
    mask = uniform_mod(threefry.split(key)[0], tuple(pts.shape) + (sk.lwe_dimension,), q)
    noise = gaussian_mod(gen, tuple(pts.shape), rel_std, q)
    body = add_mod(add_mod(_dot_key_mod(mask, sk.bits, q), pts, q), noise, q)
    return body.unsqueeze(-1), mask


def decrypt_lwe_custom_mod(ct: LweCiphertext, sk: LweSecretKey, q: int) -> torch.Tensor:
    """The phase b - <a, s> mod q."""
    _check_q(q)
    return sub_mod(ct.body, _dot_key_mod(ct.mask, sk.bits, q), q)


def lwe_add_custom_mod(a: LweCiphertext, b: LweCiphertext, q: int) -> LweCiphertext:
    return LweCiphertext(data=add_mod(a.data, b.data, q))


def lwe_sub_custom_mod(a: LweCiphertext, b: LweCiphertext, q: int) -> LweCiphertext:
    return LweCiphertext(data=sub_mod(a.data, b.data, q))


def lwe_neg_custom_mod(a: LweCiphertext, q: int) -> LweCiphertext:
    return LweCiphertext(data=neg_mod(a.data, q))


def lwe_plaintext_add_custom_mod(a: LweCiphertext, pt, q: int) -> LweCiphertext:
    body = add_mod(a.body, _plaintexts(pt, q, a.data.device), q)
    return LweCiphertext(data=torch.cat([a.mask, body.unsqueeze(-1)], dim=-1))


def lwe_cleartext_mul_custom_mod(a: LweCiphertext, c: int, q: int) -> LweCiphertext:
    return LweCiphertext(data=mul_scalar_mod(a.data, c, q))


def encrypt_seeded_lwe_custom_mod(key: torch.Tensor, gen: torch.Generator, sk: LweSecretKey,
                                  plaintexts, rel_std: float, q: int) -> torch.Tensor:
    """The seeded twin: only the bodies [...]; the mask is replayed from
    split(key)[0] (`decompress_seeded_lwe_custom_mod`)."""
    _check_q(q)
    pts = _plaintexts(plaintexts, q, sk.bits.device)
    return _mask_and_body(key, gen, sk, pts, rel_std, q)[0].squeeze(-1)


def decompress_seeded_lwe_custom_mod(key: torch.Tensor, bodies: torch.Tensor,
                                     lwe_dimension: int, q: int) -> LweCiphertext:
    """The mask re-expanded from the key, the stored bodies attached."""
    _check_q(q)
    mask = uniform_mod(threefry.split(key)[0], tuple(bodies.shape) + (lwe_dimension,), q)
    return LweCiphertext(data=torch.cat([mask, bodies.unsqueeze(-1)], dim=-1))


# ---------------------------------------------------------------------------
# SignedDecomposerNonNative (decomposer.rs:203, iter.rs:237, term.rs:140)
# ---------------------------------------------------------------------------


def _rounded(x: torch.Tensor, sr: int, q: int) -> torch.Tensor:
    """((x + sr/2) mod q) / sr for words x < q.  The add is `add_mod`'s, so
    nothing passes 2^64.  The JAX function adds in wrapping uint64, which at
    q > 2^63 wraps for the words in [2^64 - sr/2, q); there its sum and the
    exact one both lie in [0, sr/2) and round to 0, so the results agree
    (ROADMAP C14)."""
    return udiv(add_mod(x, torch.full_like(x, as_i64(sr >> 1)), q), sr)


def closest_representable_custom_mod(x: torch.Tensor, base_log: int, level: int,
                                     q: int) -> torch.Tensor:
    """round(x / (q/B^l)) * (q/B^l), floored-radix (decomposer.rs:341-357),
    for words x < q (the rounding is `_rounded`'s, C14)."""
    _check_q(q)
    sr = q // (1 << (base_log * level))
    return _rounded(x, sr, q) * as_i64(sr)


def decompose_custom_mod(x: torch.Tensor, base_log: int, level: int, q: int) -> torch.Tensor:
    """The balanced decomposition under q of words x < q: terms
    [..., level] in [0, q), level l first down to 1 (iter.rs
    decompose_one_level_non_native; the rounding is `_rounded`'s, C14)."""
    _check_q(q)
    b = base_log
    state = _rounded(x, q // (1 << (b * level)), q)
    terms = []
    for _ in range(level):
        res = state & ((1 << b) - 1)
        state = shr(state, b)
        carry = shr(((res - 1) | state) & res, b - 1)
        state = state + carry
        terms.append(umod(res + as_i64(q) - (carry << b), q))
    return torch.stack(terms, dim=-1)


def recomposition_summands_custom_mod(terms: torch.Tensor, base_log: int, level: int,
                                      q: int) -> torch.Tensor:
    """theta_i * floor(q / B^i) mod q for the terms, level l first
    (term.rs to_recomposition_summand)."""
    return torch.stack([mul_scalar_mod(terms[..., k], q // (1 << (base_log * (level - k))), q)
                        for k in range(level)], dim=-1)


__all__ = ["uniform_mod", "gaussian_mod", "add_mod", "sub_mod", "neg_mod", "mul_scalar_mod",
           "umod", "encrypt_lwe_custom_mod", "decrypt_lwe_custom_mod", "lwe_add_custom_mod",
           "lwe_sub_custom_mod", "lwe_neg_custom_mod", "lwe_plaintext_add_custom_mod",
           "lwe_cleartext_mul_custom_mod", "encrypt_seeded_lwe_custom_mod",
           "decompress_seeded_lwe_custom_mod", "closest_representable_custom_mod",
           "decompose_custom_mod", "recomposition_summands_custom_mod"]
