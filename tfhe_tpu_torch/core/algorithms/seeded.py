"""Seeded (compressed) entities: a 32-bit seed and the bodies only; the masks
are regenerated from the seed on decompression.

Counterpart of `tfhe_tpu/core/algorithms/seeded.py` (reference `Seeded*`
entities and their `seeded_*_decompression.rs`).  The masks are threefry
streams (`core/threefry.py`) laid out exactly as the JAX package's key tree:
a compressed entity made by either package decompresses bit-identically in
both.  Compression: LWE n+1 → 1 word, GLWE (k+1)N → N, a BSK's GGSWs
l(k+1)^2 N → l(k+1) N, a KSK's rows n+1 → 1.

Every entity carries its torus width (`log_q`): at 32 the bodies are
lifted words (`core/numeric.py`) and the masks regenerate as the 32-bit
words of the seed's stream, lifted, so a 32-bit entity of either package
decompresses to the same words in both.

Generation takes a torch generator for the noise (the JAX package's
Gaussian noise is not reproduced) and returns (full entity, seeded twin):
the full one is what the same streams generate, so its decompression must
equal it.  Decompression runs on the device of the stored bodies unless a
`device` is given (the card by name raises without one); every mask is
written into the output in passes (`threefry.CHUNK`), with no second copy
of the key.  `decompress_bootstrap_key(..., bits=)` and
`decompress_keyswitch_key(..., rows=)` decompress a slice of a key alone:
the per-bit key split makes any input bit's GGSW cheap to regenerate.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import cuda_lib
from .. import rng, threefry
from ..entities import (GgswCiphertext, GlweCiphertext, LweBootstrapKey, LweCiphertext,
                        LweKeyswitchKey, LweMultiBitBootstrapKey, LwePackingKeyswitchKey)
from ..numeric import LOG_Q, check_log_q
from ..params import DecompParams
from .bootstrap import external_product_num_primes
from .encryption import (bootstrap_key_to_ntt, encrypt_constant_ggsw_from_key,
                         encrypt_glwe_deterministic_mask,
                         encrypt_lwe_deterministic_mask, generate_bootstrap_key_from_key,
                         generate_keyswitch_key_from_key, generate_packing_keyswitch_key,
                         ggsw_masks_from_key)
from .keyswitch import keyswitch_key
from .multi_bit import generate_multi_bit_bootstrap_key_from_key
from .public_key import (LweCompactPublicKey, LwePublicKey, generate_lwe_compact_public_key,
                         generate_lwe_public_key)


@dataclass(frozen=True)
class SeededLweCiphertext:
    """bodies [...] + the seed of the mask stream."""

    body: torch.Tensor
    seed: int = 0
    lwe_dimension: int = 0
    log_q: int = LOG_Q


@dataclass(frozen=True)
class SeededGlweCiphertext:
    body: torch.Tensor          # [..., N]
    seed: int = 0
    glwe_dimension: int = 0
    log_q: int = LOG_Q


@dataclass(frozen=True)
class SeededLweBootstrapKey:
    """The body polynomial of each GGSW row: bodies [n, l, k+1, N]."""

    bodies: torch.Tensor
    seed: int = 0
    decomp: DecompParams = None
    log_q: int = LOG_Q


@dataclass(frozen=True)
class SeededLweKeyswitchKey:
    bodies: torch.Tensor        # [n_in, l]
    seed: int = 0
    decomp: DecompParams = None
    output_lwe_dimension: int = 0
    log_q: int = LOG_Q


@dataclass(frozen=True)
class SeededGgswCiphertextList:
    """Row bodies [count, l, k+1, N]; one GGSW stream an entry, as a BSK's."""

    bodies: torch.Tensor
    seed: int = 0
    decomp: DecompParams = None
    log_q: int = LOG_Q


@dataclass(frozen=True)
class SeededLweMultiBitBootstrapKey:
    """Row bodies [n/g, 2^g, l, k+1, N] of the standard-domain key."""

    bodies: torch.Tensor
    seed: int = 0
    decomp: DecompParams = None
    grouping_factor: int = 2
    log_q: int = LOG_Q


@dataclass(frozen=True)
class SeededLwePackingKeyswitchKey:
    bodies: torch.Tensor        # [n_in, l, N]
    seed: int = 0
    decomp: DecompParams = None
    glwe_dimension: int = 1
    log_q: int = LOG_Q


@dataclass(frozen=True)
class SeededLwePublicKey:
    bodies: torch.Tensor        # [zero_count]
    seed: int = 0
    lwe_dimension: int = 0
    log_q: int = LOG_Q


@dataclass(frozen=True)
class SeededLweCompactPublicKey:
    body: torch.Tensor          # b(X) = a*s + e, [N]; a(X) replays from the seed
    seed: int = 0
    log_q: int = LOG_Q


# -- the mask streams: mirrors of the encryption functions' key trees ---------


def _root(seed: int, device) -> torch.Tensor:
    return threefry.key_from_seed(seed, device)


def _mask_key(seed: int, device) -> torch.Tensor:
    """split(fork(key_from_seed(seed), 0x3E))[0] (tfhe_tpu seeded.py:71)."""
    return threefry.split(threefry.fork(_root(seed, device), 0x3E))[0]


def _bodies_on(s, device) -> torch.Tensor:
    """The stored bodies on `device` (default: where they are); the 64-bit
    torus or the lifted 32-bit one."""
    check_log_q(s.log_q)
    body = s.body if hasattr(s, "body") else s.bodies
    return body if device is None else body.to(cuda_lib.resolve_device(device))


def seeded_mask_for(seed: int, shape, n: int, device, log_q: int = LOG_Q) -> torch.Tensor:
    return threefry.uniform_torus(_mask_key(seed, device), tuple(shape) + (n,), log_q=log_q)


def encrypt_lwe_seeded(seed: int, gen: torch.Generator, sk, plaintexts: torch.Tensor,
                       noise_std: float, log_q: int = LOG_Q) -> SeededLweCiphertext:
    """Encrypt with the seed's mask (the masks of tfhe_tpu encrypt_lwe_seeded)
    and gen's noise; → the compressed form."""
    shape = tuple(plaintexts.shape)
    mask = seeded_mask_for(seed, shape, sk.lwe_dimension, plaintexts.device, log_q)
    noise = rng.gaussian_noise(gen, shape, noise_std, log_q=log_q)
    data = encrypt_lwe_deterministic_mask(mask, sk, plaintexts, noise)
    return SeededLweCiphertext(body=data[..., -1], seed=seed, lwe_dimension=sk.lwe_dimension,
                               log_q=log_q)


def decompress_lwe(sct: SeededLweCiphertext, device=None) -> LweCiphertext:
    """reference seeded_lwe_ciphertext_decompression.rs."""
    body = _bodies_on(sct, device)
    n = sct.lwe_dimension
    data = torch.empty(tuple(body.shape) + (n + 1,), dtype=torch.int64, device=body.device)
    threefry.uniform_torus(_mask_key(sct.seed, body.device), tuple(body.shape) + (n,),
                           out=data[..., :n], log_q=sct.log_q)
    data[..., n] = body
    return LweCiphertext(data=data)


def encrypt_glwe_seeded(seed: int, gen: torch.Generator, sk, plaintext_polys: torch.Tensor,
                        noise_std: float, log_q: int = LOG_Q) -> SeededGlweCiphertext:
    """Encrypt with the seed's mask; (k+1)N words compress to N."""
    k, n = sk.glwe_dimension, sk.polynomial_size
    lead = tuple(plaintext_polys.shape[:-1])
    mask = threefry.uniform_torus(_mask_key(seed, plaintext_polys.device), lead + (k, n),
                                  log_q=log_q)
    noise = rng.gaussian_noise(gen, lead + (n,), noise_std, log_q=log_q)
    data = encrypt_glwe_deterministic_mask(mask, sk, plaintext_polys, noise)
    return SeededGlweCiphertext(body=data[..., -1, :], seed=seed, glwe_dimension=k,
                                log_q=log_q)


def decompress_glwe(sct: SeededGlweCiphertext, device=None) -> GlweCiphertext:
    """reference seeded_glwe_ciphertext_decompression.rs."""
    body = _bodies_on(sct, device)
    k, lead, n = sct.glwe_dimension, tuple(body.shape[:-1]), body.shape[-1]
    data = torch.empty(lead + (k + 1, n), dtype=torch.int64, device=body.device)
    threefry.uniform_torus(_mask_key(sct.seed, body.device), lead + (k, n),
                           out=data[..., :k, :], log_q=sct.log_q)
    data[..., k, :] = body
    return GlweCiphertext(data=data)


# -- bootstrap keys and GGSW lists ---------------------------------------------


def bsk_masks_from_seed(seed: int, n_in: int, levels: int, glwe_size: int, n_poly: int,
                        device, bits=None, out=None, log_q: int = LOG_Q) -> torch.Tensor:
    """The masks of generate_bootstrap_key from the seed alone: GGSW i under
    split(key_from_seed(seed), n_in)[i] → [n_in, l, k+1, k, N] (only the
    input bits `bits`, an index tensor or slice, if given)."""
    keys = threefry.split(_root(seed, device), n_in)
    if bits is not None:
        keys = keys[bits]
    return ggsw_masks_from_key(keys, levels, glwe_size, n_poly, out=out, log_q=log_q)


def _ggsw_data(s, device, bits, axes: int) -> torch.Tensor:
    """GGSW data [..., l, k+1, k+1, N] of a seeded key or list: its row
    bodies under the masks of the seed's per-GGSW streams, the first `axes`
    axes of the bodies flattened into the stream index (only the streams
    `bits`, flat, if given)."""
    bodies = _bodies_on(s, device)
    lead = tuple(bodies.shape[:axes])
    levels, glwe_size, n_poly = bodies.shape[axes:]
    flat = bodies.reshape((-1, levels, glwe_size, n_poly))
    count = flat.shape[0]
    if bits is not None:
        flat = flat[bits]
    data = torch.empty((flat.shape[0], levels, glwe_size, glwe_size, n_poly),
                       dtype=torch.int64, device=bodies.device)
    bsk_masks_from_seed(s.seed, count, levels, glwe_size, n_poly, bodies.device, bits,
                        out=data[..., :glwe_size - 1, :], log_q=s.log_q)
    data[..., glwe_size - 1, :] = flat
    return data if bits is not None else data.view(lead + tuple(data.shape[1:]))


def compress_bootstrap_key(bsk: LweBootstrapKey, seed: int,
                           log_q: int = LOG_Q) -> SeededLweBootstrapKey:
    """The row bodies of a key whose masks are the seed's streams (made by
    `generate_seeded_bootstrap_key`)."""
    return SeededLweBootstrapKey(bodies=bsk.data[..., -1, :].contiguous(), seed=seed,
                                 decomp=bsk.decomp, log_q=log_q)


def generate_seeded_bootstrap_key(seed: int, gen: torch.Generator, lwe_sk, glwe_sk,
                                  decomp: DecompParams, noise_std: float,
                                  log_q: int = LOG_Q) -> tuple:
    """(full key, seeded twin): a standard BSK whose masks are the streams of
    `seed`, as tfhe_tpu generate_seeded_bootstrap_key lays them out."""
    full = generate_bootstrap_key_from_key(_root(seed, lwe_sk.bits.device), gen, lwe_sk,
                                           glwe_sk, decomp, noise_std, log_q)
    return full, compress_bootstrap_key(full, seed, log_q)


def decompress_bootstrap_key(sbsk: SeededLweBootstrapKey, device=None,
                             bits=None) -> LweBootstrapKey:
    """reference seeded_lwe_bootstrap_key_decompression.rs: the standard key
    [n, l, k+1, k+1, N] (only the input bits `bits`, if given).  Callers
    convert it with `bootstrap_key_to_ntt`."""
    return LweBootstrapKey(data=_ggsw_data(sbsk, device, bits, 1), decomp=sbsk.decomp)


def generate_seeded_ggsw_list(seed: int, gen: torch.Generator, glwe_sk, msgs: torch.Tensor,
                              decomp: DecompParams, noise_std: float) -> tuple:
    """(full GGSW list data [count, l, k+1, k+1, N], seeded twin): GGSW i
    under split(key_from_seed(seed), count)[i], as a BSK's."""
    keys = threefry.split(_root(seed, msgs.device), msgs.shape[0])
    full = encrypt_constant_ggsw_from_key(keys, gen, glwe_sk, msgs, decomp, noise_std)
    return full, SeededGgswCiphertextList(bodies=full[..., -1, :].contiguous(), seed=seed,
                                          decomp=decomp)


def decompress_ggsw_list(s: SeededGgswCiphertextList, device=None) -> list:
    """reference seeded_ggsw_ciphertext_list_decompression.rs: a list of
    GgswCiphertext."""
    data = _ggsw_data(s, device, None, 1)
    return [GgswCiphertext(data=data[i], decomp=s.decomp) for i in range(data.shape[0])]


def generate_seeded_multi_bit_bootstrap_key(seed: int, gen: torch.Generator, lwe_sk, glwe_sk,
                                            decomp: DecompParams, grouping_factor: int,
                                            noise_std: float) -> tuple:
    """(full standard multi-bit key, seeded twin): GGSW (j, v) under
    split(key_from_seed(seed), n/g * 2^g)[j * 2^g + v]."""
    full = generate_multi_bit_bootstrap_key_from_key(
        _root(seed, lwe_sk.bits.device), gen, lwe_sk, glwe_sk, decomp, grouping_factor,
        noise_std)
    return full, SeededLweMultiBitBootstrapKey(
        bodies=full.data[..., -1, :].contiguous(), seed=seed, decomp=decomp,
        grouping_factor=grouping_factor)


def decompress_multi_bit_bootstrap_key(s: SeededLweMultiBitBootstrapKey,
                                       device=None) -> LweMultiBitBootstrapKey:
    """reference seeded_lwe_multi_bit_bootstrap_key_decompression.rs: the
    n/g * 2^g GGSW streams are forked flat, so the BSK replay applies."""
    return LweMultiBitBootstrapKey(data=_ggsw_data(s, device, None, 2), decomp=s.decomp,
                                   grouping_factor=s.grouping_factor)


# -- keyswitching keys -----------------------------------------------------------


def generate_seeded_keyswitch_key(seed: int, gen: torch.Generator, in_sk, out_sk,
                                  decomp: DecompParams, noise_std: float,
                                  log_q: int = LOG_Q) -> tuple:
    """(full KSK, seeded twin): the masks of one encrypt_lwe over [n_in, l]
    under key_from_seed(seed)."""
    full = generate_keyswitch_key_from_key(_root(seed, in_sk.bits.device), gen, in_sk,
                                           out_sk, decomp, noise_std, log_q)
    return full, SeededLweKeyswitchKey(bodies=full.data[..., -1].contiguous(), seed=seed,
                                       decomp=decomp,
                                       output_lwe_dimension=out_sk.lwe_dimension, log_q=log_q)


def decompress_keyswitch_key(skk: SeededLweKeyswitchKey, device=None,
                             rows=None) -> LweKeyswitchKey:
    """Replay the mask of generate_keyswitch_key's one encrypt_lwe (only
    the input rows [r0, r1), if rows=(r0, r1) is given); on the card the
    key gets K2′'s limb layout (`keyswitch.keyswitch_key`)."""
    bodies = _bodies_on(skk, device)
    n_in, levels = bodies.shape
    n = skk.output_lwe_dimension
    r0, r1 = (0, n_in) if rows is None else rows
    data = torch.empty((r1 - r0, levels, n + 1), dtype=torch.int64, device=bodies.device)
    mask_key = threefry.split(_root(skk.seed, bodies.device))[0]
    threefry.uniform_torus(mask_key, (n_in, levels, n), out=data[..., :n], rows=(r0, r1),
                           log_q=skk.log_q)
    data[..., n] = bodies[r0:r1]
    return keyswitch_key(data, skk.decomp)


def decompress_server_key(sbsk: SeededLweBootstrapKey, skk: SeededLweKeyswitchKey,
                          device=None) -> tuple:
    """A compressed server key's (NttBootstrapKey, LweKeyswitchKey) on the
    bodies' device (or `device`): the standard BSK regenerated, converted to
    the port's spectra at the external product's prime count and freed
    before the KSK is regenerated."""
    bsk_std = decompress_bootstrap_key(sbsk, device)
    _, _, R, _, N = bsk_std.data.shape
    bsk = bootstrap_key_to_ntt(bsk_std, external_product_num_primes(N, R, sbsk.decomp),
                               sbsk.log_q)
    del bsk_std
    return bsk, decompress_keyswitch_key(skk, device)


def generate_seeded_packing_keyswitch_key(seed: int, gen: torch.Generator, in_sk, out_sk,
                                          decomp: DecompParams, noise_std: float) -> tuple:
    full = generate_packing_keyswitch_key(_root(seed, in_sk.bits.device), gen, in_sk, out_sk,
                                          decomp, noise_std)
    return full, SeededLwePackingKeyswitchKey(
        bodies=full.data[..., -1, :].contiguous(), seed=seed, decomp=decomp,
        glwe_dimension=out_sk.glwe_dimension)


def decompress_packing_keyswitch_key(s: SeededLwePackingKeyswitchKey,
                                     device=None) -> LwePackingKeyswitchKey:
    """Replay generate_packing_keyswitch_key's one encrypt_glwe over the
    [n_in, l, N] plaintexts."""
    bodies = _bodies_on(s, device)
    n_in, levels, n_poly = bodies.shape
    k = s.glwe_dimension
    data = torch.empty((n_in, levels, k + 1, n_poly), dtype=torch.int64, device=bodies.device)
    threefry.uniform_torus(threefry.split(_root(s.seed, bodies.device))[0],
                           (n_in, levels, k, n_poly), out=data[..., :k, :], log_q=s.log_q)
    data[..., k, :] = bodies
    return LwePackingKeyswitchKey(data=data, decomp=s.decomp)


# -- public keys -----------------------------------------------------------------


def generate_seeded_lwe_public_key(seed: int, gen: torch.Generator, sk, zero_count: int,
                                   noise_std: float, log_q: int = LOG_Q) -> tuple:
    full = generate_lwe_public_key(_root(seed, sk.bits.device), gen, sk, zero_count,
                                   noise_std, log_q)
    return full, SeededLwePublicKey(bodies=full.data[..., -1].contiguous(), seed=seed,
                                    lwe_dimension=sk.lwe_dimension, log_q=log_q)


def decompress_lwe_public_key(s: SeededLwePublicKey, device=None) -> LwePublicKey:
    """Replay generate_lwe_public_key's one encrypt_lwe over zero_count
    plaintexts."""
    bodies = _bodies_on(s, device)
    n = s.lwe_dimension
    data = torch.empty((bodies.shape[0], n + 1), dtype=torch.int64, device=bodies.device)
    threefry.uniform_torus(threefry.split(_root(s.seed, bodies.device))[0],
                           (bodies.shape[0], n), out=data[:, :n], log_q=s.log_q)
    data[:, n] = bodies
    return LwePublicKey(data=data, log_q=s.log_q)


def generate_seeded_compact_public_key(seed: int, gen: torch.Generator, sk,
                                       noise_std: float) -> tuple:
    full = generate_lwe_compact_public_key(_root(seed, sk.bits.device), gen, sk, noise_std)
    return full, SeededLweCompactPublicKey(body=full.data[1].clone(), seed=seed)


def decompress_compact_public_key(s: SeededLweCompactPublicKey,
                                  device=None) -> LweCompactPublicKey:
    """Replay generate_lwe_compact_public_key's a(X)."""
    body = _bodies_on(s, device)
    a = threefry.uniform_torus(threefry.split(_root(s.seed, body.device))[0],
                               (body.shape[-1],), log_q=s.log_q)
    return LweCompactPublicKey(data=torch.stack([a, body]), log_q=s.log_q)


__all__ = [
    "SeededLweCiphertext", "SeededGlweCiphertext", "SeededLweBootstrapKey",
    "SeededLweKeyswitchKey", "SeededGgswCiphertextList", "SeededLweMultiBitBootstrapKey",
    "SeededLwePackingKeyswitchKey", "SeededLwePublicKey", "SeededLweCompactPublicKey",
    "seeded_mask_for", "encrypt_lwe_seeded", "decompress_lwe",
    "encrypt_glwe_seeded", "decompress_glwe", "ggsw_masks_from_key", "bsk_masks_from_seed",
    "compress_bootstrap_key", "generate_seeded_bootstrap_key", "decompress_bootstrap_key",
    "generate_seeded_ggsw_list", "decompress_ggsw_list",
    "generate_seeded_multi_bit_bootstrap_key", "decompress_multi_bit_bootstrap_key",
    "generate_seeded_keyswitch_key", "decompress_keyswitch_key", "decompress_server_key",
    "generate_seeded_packing_keyswitch_key", "decompress_packing_keyswitch_key",
    "generate_seeded_lwe_public_key", "decompress_lwe_public_key",
    "generate_seeded_compact_public_key", "decompress_compact_public_key",
]
