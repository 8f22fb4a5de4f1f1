"""The JAX side of the key-flow parity tests (tests/test_torch_seeded.py,
test_torch_public_key.py, test_torch_serialization.py): numpy secret keys
at TEST_PARAMS_SHORTINT for both packages, and the JAX package's seeded
generators and decompressions, each jitted once.

Never call JAX `shortint.gen_keys` here: over a minute of eager compiles.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tfhe_tpu.core.algorithms.seeded as JS
from tfhe_tpu.core.entities import GlweSecretKey as JGlweSk
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu.core.params import DecompParams as JDecomp
from tfhe_tpu_torch.core.algorithms import seeded as TS
from tfhe_tpu_torch.core.entities import GlweSecretKey, LweSecretKey
from tfhe_tpu_torch.core.numeric import from_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P

U64 = np.uint64
GROUPING = 2
PKS_DECOMP = (15, 2)          # the packing KSK's (base_log, level)
ZERO_COUNT = 2 * P.lwe_dimension

# the nine seeded entities
KINDS = ("lwe", "glwe", "bsk", "ksk", "ggsw_list", "multi_bit_bsk", "packing_ksk",
         "public_key", "compact_public_key")


@functools.lru_cache(maxsize=None)
def secret_bits(seed: int = 5):
    """(lwe bits [n] int8, glwe bits [k, N] int8), numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, P.lwe_dimension).astype(np.int8),
            rng.integers(0, 2, (P.glwe_dimension, P.polynomial_size)).astype(np.int8))


def jax_keys():
    lwe, glwe = secret_bits()
    return JLweSk(bits=jnp.asarray(lwe)), JGlweSk(bits=jnp.asarray(glwe))


def torch_keys(device="cpu"):
    lwe, glwe = secret_bits()
    return (LweSecretKey(bits=torch.as_tensor(lwe.astype(np.int64), device=device)),
            GlweSecretKey(bits=torch.as_tensor(glwe.astype(np.int64), device=device)))


def plaintexts(shape, seed: int = 3) -> np.ndarray:
    """Torus plaintexts m * Δ (2_2's Δ = 2^59), u64."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 16, shape).astype(U64) << U64(59)


def ggsw_messages(count: int = 3) -> np.ndarray:
    return np.arange(count, dtype=np.int64) % 2


def _jax_args(kind):
    """The JAX generator and its arguments past (seed, ...), and the noise
    std its bodies carry."""
    lwe, glwe = jax_keys()
    big = glwe.as_lwe_secret_key()
    if kind == "lwe":
        return JS.encrypt_lwe_seeded, (lwe, jnp.asarray(plaintexts((5, 3))), P.lwe_noise_std,
                                       64), P.lwe_noise_std
    if kind == "glwe":
        return JS.encrypt_glwe_seeded, (glwe, jnp.asarray(plaintexts((2, P.polynomial_size))),
                                        P.glwe_noise_std, 64), P.glwe_noise_std
    if kind == "bsk":
        return JS.generate_seeded_bootstrap_key, (lwe, glwe, JDecomp(23, 1), P.glwe_noise_std,
                                                  64), P.glwe_noise_std
    if kind == "ksk":
        return JS.generate_seeded_keyswitch_key, (big, lwe, JDecomp(3, 5), P.lwe_noise_std,
                                                  64), P.lwe_noise_std
    if kind == "ggsw_list":
        return JS.generate_seeded_ggsw_list, (glwe, jnp.asarray(ggsw_messages()),
                                              JDecomp(23, 1), P.glwe_noise_std,
                                              64), P.glwe_noise_std
    if kind == "multi_bit_bsk":
        return JS.generate_seeded_multi_bit_bootstrap_key, (lwe, glwe, JDecomp(23, 1), GROUPING,
                                                            P.glwe_noise_std,
                                                            64), P.glwe_noise_std
    if kind == "packing_ksk":
        return JS.generate_seeded_packing_keyswitch_key, (lwe, glwe, JDecomp(*PKS_DECOMP),
                                                          P.glwe_noise_std,
                                                          64), P.glwe_noise_std
    if kind == "public_key":
        return JS.generate_seeded_lwe_public_key, (lwe, ZERO_COUNT, P.lwe_noise_std,
                                                   64), P.lwe_noise_std
    return JS.generate_seeded_compact_public_key, (lwe, P.lwe_noise_std, 64), P.lwe_noise_std


def noise_std(kind) -> float:
    return _jax_args(kind)[2]


@functools.lru_cache(maxsize=None)
def jax_made(kind: str, seed: int):
    """(full data u64 numpy or None, the JAX seeded entity): the full data
    of the generators that return one, else None.  Jitted, every argument
    closed over."""
    fn, args, _ = _jax_args(kind)
    out = jax.jit(lambda: fn(seed, *args))()
    if isinstance(out, tuple):
        full, seeded = out
        data = getattr(full, "data", full)
        return np.asarray(data), seeded
    return None, out


@functools.lru_cache(maxsize=None)
def jax_decompressed(kind: str, seed: int) -> np.ndarray:
    """The JAX package's decompression of jax_made(kind, seed), jitted: the
    full data as u64 numpy."""
    seeded = jax_made(kind, seed)[1]
    fn = {"lwe": JS.decompress_lwe, "glwe": JS.decompress_glwe,
          "bsk": JS.decompress_bootstrap_key, "ksk": JS.decompress_keyswitch_key,
          "ggsw_list": lambda s: jnp.stack([g.data for g in JS.decompress_ggsw_list(s)]),
          "multi_bit_bsk": JS.decompress_multi_bit_bootstrap_key,
          "packing_ksk": JS.decompress_packing_keyswitch_key,
          "public_key": JS.decompress_lwe_public_key,
          "compact_public_key": JS.decompress_compact_public_key}[kind]
    out = jax.jit(fn)(seeded)
    return np.asarray(getattr(out, "data", out))


def to_port(sjax):
    """A JAX seeded entity → the port's, field by field (arrays as torus
    words on the CPU, DecompParams as the port's)."""
    cls = getattr(TS, type(sjax).__name__)
    fields = {}
    for f in dataclasses.fields(sjax):
        v = getattr(sjax, f.name)
        if isinstance(v, jax.Array):
            v = from_numpy_u64(np.asarray(v))
        elif isinstance(v, JDecomp):
            v = DecompParams(v.base_log, v.level)
        fields[f.name] = v
    return cls(**fields)


def port_decompressed(s) -> torch.Tensor:
    """The port's decompression of a port seeded entity, as one tensor."""
    out = {"SeededLweCiphertext": TS.decompress_lwe, "SeededGlweCiphertext": TS.decompress_glwe,
           "SeededLweBootstrapKey": TS.decompress_bootstrap_key,
           "SeededLweKeyswitchKey": TS.decompress_keyswitch_key,
           "SeededGgswCiphertextList": lambda x: torch.stack(
               [g.data for g in TS.decompress_ggsw_list(x)]),
           "SeededLweMultiBitBootstrapKey": TS.decompress_multi_bit_bootstrap_key,
           "SeededLwePackingKeyswitchKey": TS.decompress_packing_keyswitch_key,
           "SeededLwePublicKey": TS.decompress_lwe_public_key,
           "SeededLweCompactPublicKey": TS.decompress_compact_public_key}[type(s).__name__](s)
    return getattr(out, "data", out)


def port_made(kind: str, seed: int, gen_seed: int = 9):
    """(full data tensor, seeded entity) made by the port from the same
    secret bits, its noise from a CPU generator."""
    lwe, glwe = torch_keys()
    big = glwe.as_lwe_secret_key()
    gen = torch.Generator().manual_seed(gen_seed)
    if kind == "lwe":
        s = TS.encrypt_lwe_seeded(seed, gen, lwe, from_numpy_u64(plaintexts((5, 3))),
                                  P.lwe_noise_std)
        return None, s
    if kind == "glwe":
        s = TS.encrypt_glwe_seeded(seed, gen, glwe,
                                   from_numpy_u64(plaintexts((2, P.polynomial_size))),
                                   P.glwe_noise_std)
        return None, s
    if kind == "bsk":
        full, s = TS.generate_seeded_bootstrap_key(seed, gen, lwe, glwe, DecompParams(23, 1),
                                                   P.glwe_noise_std)
    elif kind == "ksk":
        full, s = TS.generate_seeded_keyswitch_key(seed, gen, big, lwe, DecompParams(3, 5),
                                                   P.lwe_noise_std)
    elif kind == "ggsw_list":
        full, s = TS.generate_seeded_ggsw_list(seed, gen, glwe,
                                               torch.as_tensor(ggsw_messages()),
                                               DecompParams(23, 1), P.glwe_noise_std)
    elif kind == "multi_bit_bsk":
        full, s = TS.generate_seeded_multi_bit_bootstrap_key(
            seed, gen, lwe, glwe, DecompParams(23, 1), GROUPING, P.glwe_noise_std)
    elif kind == "packing_ksk":
        full, s = TS.generate_seeded_packing_keyswitch_key(
            seed, gen, lwe, glwe, DecompParams(*PKS_DECOMP), P.glwe_noise_std)
    elif kind == "public_key":
        full, s = TS.generate_seeded_lwe_public_key(seed, gen, lwe, ZERO_COUNT,
                                                    P.lwe_noise_std)
    else:
        full, s = TS.generate_seeded_compact_public_key(seed, gen, lwe, P.lwe_noise_std)
    return getattr(full, "data", full), s
