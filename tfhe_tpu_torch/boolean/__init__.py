"""Encrypted Boolean gates (counterpart of `tfhe_tpu/boolean/__init__.py`;
reference tfhe/src/boolean/).

Encoding: true = +1/8 and false = -1/8 of the torus (boolean/mod.rs:76-80).
A binary gate is a linear combination of its operands followed by one
sign-LUT bootstrap and a keyswitch, in the order the parameters give:
KS → PBS for key choice `big`, PBS → KS for `small`
(engine/bootstrapping.rs:392).  On the card each KS + PBS is one
decomposition pass, one K2′ and one K1 launch; `mux` makes two such calls
(under PBS → KS: two K1 and one keyswitch, as the JAX package orders it).

The five named boolean sets are 64-bit.  A 32-bit set (log_q = 32:
`TEST_PARAMS_BOOLEAN_U32`, or a named set replaced to the reference's own
u32 width) is held lifted (`core/numeric.py`: the word x as x * 2^32).
Its keys and ciphertexts draw their randomness at 32 bits, as the JAX
package does, then lift; ±1/8 are the same lifted words at both widths.
The server side is the 64-bit code: the keyswitch is the pass + K2′, and
the PBS is the rotate-subtract rotation (the key's route "rotate", one K7
launch a step, then the sample extraction), which the JAX package runs on
XLA for this torus, so gates equal its gates bit for bit; the prime count is
the 64-bit one.  Files and `interop` carry the dropped uint32 words.
Torus constants at or above 2^63 (false = 7/8) are int64 bit patterns:
every add and multiply wraps mod 2^64.

The key forms (tfhe_tpu boolean/__init__.py:143-163, :293-411): seeded
ciphertexts (`encrypt_compressed`), the list-of-zeros public key
(`gen_public_key`, `encrypt_with_public_key`: the subset sum on K2′, bit
for bit the JAX package's on the same key and seed), and the compressed
server and public keys, whose masks regenerate from their seeds on the
server's device.  Every entry point runs on the card unless given device="cpu" (or a key on
the CPU); without a card that raises.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..core import rng, threefry
from ..core.algorithms import seeded
from ..core.algorithms.public_key import (LwePublicKey, encrypt_lwe_with_public_key,
                                          generate_lwe_public_key)
from ..core.algorithms import (bootstrap_key_to_ntt, decrypt_lwe, encrypt_lwe,
                               external_product_num_primes, generate_bootstrap_key,
                               generate_glwe_secret_key, generate_keyswitch_key,
                               generate_lwe_secret_key, keyswitch_lwe,
                               programmable_bootstrap, trivial_glwe, trivial_lwe)
from ..core.entities import (GlweCiphertext, GlweSecretKey, LweCiphertext,
                             LweKeyswitchKey, LweSecretKey, NttBootstrapKey)
from ..core.numeric import LOG_Q, as_i64, check_log_q, to_signed
from ..core.params import BooleanParameters, DecompParams, EncryptionKeyChoice, PBSOrder
from ..core.params import boolean_params as get_boolean_params
from ..cuda_lib import resolve_device


def _checked(params: BooleanParameters | str) -> BooleanParameters:
    """The parameters (a name is looked up), on a torus of 64 or 32 bits."""
    if isinstance(params, str):
        params = get_boolean_params(params)
    check_log_q(params.log_q)
    return params


def plaintext_true(params: BooleanParameters) -> int:
    """+1/8 of the torus (reference PLAINTEXT_TRUE, boolean/mod.rs:76), as
    an int64 bit pattern: built at the set's width, then lifted to 64."""
    return as_i64(1 << (params.log_q - 3) << (LOG_Q - params.log_q))


def plaintext_false(params: BooleanParameters) -> int:
    """-1/8 of the torus (7/8: negative as an int64), lifted as
    `plaintext_true`."""
    return as_i64(7 << (params.log_q - 3) << (LOG_Q - params.log_q))


def _fresh_noise_std(params: BooleanParameters) -> float:
    if params.encryption_key_choice == EncryptionKeyChoice.SMALL:
        return params.lwe_noise_std
    return params.glwe_noise_std


@dataclass(frozen=True)
class ClientKey:
    """Small LWE key + GLWE key (reference boolean::ClientKey)."""

    lwe_sk: LweSecretKey
    glwe_sk: GlweSecretKey
    params: BooleanParameters

    def __post_init__(self):
        _checked(self.params)

    @property
    def device(self) -> torch.device:
        return self.lwe_sk.bits.device

    @property
    def encryption_key(self) -> LweSecretKey:
        if self.params.encryption_key_choice == EncryptionKeyChoice.SMALL:
            return self.lwe_sk
        return self.glwe_sk.as_lwe_secret_key()


@dataclass(frozen=True)
class ServerKey:
    """Bootstrap key in the port's spectra + keyswitch key (reference
    boolean/engine/bootstrapping.rs:93)."""

    bsk: NttBootstrapKey
    ksk: LweKeyswitchKey
    params: BooleanParameters

    def __post_init__(self):
        _checked(self.params)

    @property
    def device(self) -> torch.device:
        return self.bsk.spectra.device

    @functools.cached_property
    def sign_accumulator(self) -> GlweCiphertext:
        """The gates' one LUT, made once on the key's device."""
        return _sign_accumulator(self.params, self.device)


@dataclass(frozen=True)
class BoolCiphertext:
    """Batch of encrypted booleans; data [..., n+1] int64 torus words (the
    lifted words at log_q = 32: the width decides how a file holds them)."""

    lwe: LweCiphertext
    log_q: int = LOG_Q

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.lwe.data.shape[:-1])

    @property
    def device(self) -> torch.device:
        return self.lwe.data.device


def gen_client_key(params: BooleanParameters | str = "DEFAULT_PARAMETERS", seed: int = 0,
                   device="cuda") -> ClientKey:
    """The client key of gen_keys alone, on `device`, drawn from the port's
    generators: the bits differ from the JAX package's for the same seed."""
    params = _checked(params)
    device = resolve_device(device)
    lwe_sk = generate_lwe_secret_key(rng.generator(seed, 0xB0, 1, device=device),
                                     params.lwe_dimension)
    glwe_sk = generate_glwe_secret_key(rng.generator(seed, 0xB0, 2, device=device),
                                       params.glwe_dimension, params.polynomial_size)
    return ClientKey(lwe_sk=lwe_sk, glwe_sk=glwe_sk, params=params)


def gen_keys(params: BooleanParameters | str = "DEFAULT_PARAMETERS", seed: int = 0,
             device="cuda"):
    """→ (ClientKey, ServerKey) on `device` (reference boolean::gen_keys)."""
    ck = gen_client_key(params, seed, device)
    return ck, gen_server_key(ck, seed)


def gen_server_key(ck: ClientKey, seed: int = 0) -> ServerKey:
    """BSK (small key → GLWE key, in the port's spectra) and KSK (big →
    small), on the client key's device."""
    p = ck.params
    device = ck.device
    bsk_std = generate_bootstrap_key(rng.generator(seed, 0xB0, 3, device=device), ck.lwe_sk,
                                     ck.glwe_sk, p.pbs_decomp, p.glwe_noise_std, p.log_q)
    npr = external_product_num_primes(p.polynomial_size, p.glwe_size, p.pbs_decomp)
    bsk = bootstrap_key_to_ntt(bsk_std, npr, p.log_q)
    del bsk_std
    ksk = generate_keyswitch_key(rng.generator(seed, 0xB0, 4, device=device),
                                 ck.glwe_sk.as_lwe_secret_key(), ck.lwe_sk, p.ks_decomp,
                                 p.lwe_noise_std, p.log_q)
    return ServerKey(bsk=bsk, ksk=ksk, params=p)


# ---------------------------------------------------------------------------
# encryption
# ---------------------------------------------------------------------------


def _encode(params: BooleanParameters, messages, device) -> torch.Tensor:
    msgs = torch.as_tensor(messages, dtype=torch.bool, device=device)
    true = torch.full((), plaintext_true(params), dtype=torch.int64, device=device)
    false = torch.full((), plaintext_false(params), dtype=torch.int64, device=device)
    return torch.where(msgs, true, false)


def encrypt(ck: ClientKey, messages, seed: int = 0) -> BoolCiphertext:
    """messages: bools [...] → BoolCiphertext [..., n+1] under the key the
    parameters choose, on the key's device."""
    pts = _encode(ck.params, messages, ck.device)
    ct = encrypt_lwe(rng.generator(seed, 0xB1, device=ck.device), ck.encryption_key, pts,
                     _fresh_noise_std(ck.params), ck.params.log_q)
    return BoolCiphertext(lwe=ct, log_q=ck.params.log_q)


@dataclass(frozen=True)
class CompressedCiphertext:
    """A seeded boolean ciphertext: one torus word a bool and the mask's
    seed (reference boolean CompressedCiphertext)."""

    seeded: seeded.SeededLweCiphertext
    params: BooleanParameters = None

    def decompress(self, device=None) -> BoolCiphertext:
        return BoolCiphertext(lwe=seeded.decompress_lwe(self.seeded, device),
                              log_q=self.seeded.log_q)


def encrypt_compressed(ck: ClientKey, messages, seed: int = 1) -> CompressedCiphertext:
    """reference ClientKey::encrypt_compressed: the mask is the seed's
    stream (the JAX package's for the same seed), the noise a generator's
    of the seed."""
    pts = _encode(ck.params, messages, ck.device)
    sct = seeded.encrypt_lwe_seeded(seed, rng.generator(seed, 0x3E, device=ck.device),
                                    ck.encryption_key, pts, _fresh_noise_std(ck.params),
                                    ck.params.log_q)
    return CompressedCiphertext(seeded=sct, params=ck.params)


def trivial_encrypt(params: BooleanParameters, messages, device="cuda") -> BoolCiphertext:
    """Noiseless encryption: a zero mask and ±1/8 as the body, of the
    dimension the parameters' key choice gives, on `device` (the apps pass
    their server key's)."""
    params = _checked(params)
    pts = _encode(params, messages, resolve_device(device))
    n = (params.lwe_dimension if params.encryption_key_choice == EncryptionKeyChoice.SMALL
         else params.big_lwe_dimension)
    return BoolCiphertext(lwe=trivial_lwe(pts, n), log_q=params.log_q)


def decrypt(ck: ClientKey, ct: BoolCiphertext) -> torch.Tensor:
    """→ bool tensor [...]: true iff the phase lies in the positive half
    (of a lifted word too: bit 31 of the 32-bit phase is the int64's sign)."""
    return to_signed(decrypt_lwe(ct.lwe, ck.encryption_key), ck.params.log_q) > 0


# ---------------------------------------------------------------------------
# the bootstrapping pattern
# ---------------------------------------------------------------------------


def _sign_accumulator(params: BooleanParameters, device) -> GlweCiphertext:
    """Trivial GLWE accumulator with every body coefficient 1/8 (reference
    engine/bootstrapping.rs:59-60)."""
    body = torch.full((params.polynomial_size,), plaintext_true(params), dtype=torch.int64,
                      device=device)
    return trivial_glwe(body, params.glwe_dimension)


def _on_key_device(sk: ServerKey, *cts: BoolCiphertext) -> None:
    """Operands must lie on the server key's device: a trivial operand made
    on the CPU beside card ciphertexts raises, it is not moved."""
    for ct in cts:
        if ct.device != sk.device:
            raise ValueError(f"a ciphertext on {ct.device} met a server key on {sk.device}; "
                             f"make trivial operands with device=sk.device")


def _apply_bootstrapping_pattern(sk: ServerKey, lwe: LweCiphertext) -> LweCiphertext:
    """KS → PBS or PBS → KS per the parameters' order (reference
    apply_bootstrapping_pattern, engine/bootstrapping.rs:392)."""
    acc = sk.sign_accumulator
    if sk.params.pbs_order == PBSOrder.KEYSWITCH_BOOTSTRAP:
        return programmable_bootstrap(keyswitch_lwe(lwe, sk.ksk), acc, sk.bsk)
    return keyswitch_lwe(programmable_bootstrap(lwe, acc, sk.bsk), sk.ksk)


def _gate(sk: ServerKey, data: torch.Tensor) -> BoolCiphertext:
    return BoolCiphertext(lwe=_apply_bootstrapping_pattern(sk, LweCiphertext(data=data)),
                          log_q=sk.params.log_q)


def _sum(sk: ServerKey, a: BoolCiphertext, b: BoolCiphertext, body: int,
         negate: bool = False) -> torch.Tensor:
    """±(a + b), then `body` added to the body column (a fresh tensor)."""
    _on_key_device(sk, a, b)
    data = a.lwe.data + b.lwe.data
    if negate:
        data = -data
    data[..., -1] += body
    return data


# ---------------------------------------------------------------------------
# gates (linear combinations per reference boolean/engine/mod.rs:608-830)
# ---------------------------------------------------------------------------


def and_(sk: ServerKey, a: BoolCiphertext, b: BoolCiphertext) -> BoolCiphertext:
    return _gate(sk, _sum(sk, a, b, plaintext_false(sk.params)))           # a + b - 1/8


def nand(sk: ServerKey, a: BoolCiphertext, b: BoolCiphertext) -> BoolCiphertext:
    return _gate(sk, _sum(sk, a, b, plaintext_true(sk.params), negate=True))


def or_(sk: ServerKey, a: BoolCiphertext, b: BoolCiphertext) -> BoolCiphertext:
    return _gate(sk, _sum(sk, a, b, plaintext_true(sk.params)))            # a + b + 1/8


def nor(sk: ServerKey, a: BoolCiphertext, b: BoolCiphertext) -> BoolCiphertext:
    return _gate(sk, _sum(sk, a, b, plaintext_false(sk.params), negate=True))


def xor_(sk: ServerKey, a: BoolCiphertext, b: BoolCiphertext) -> BoolCiphertext:
    return _gate(sk, _sum(sk, a, b, plaintext_true(sk.params)) * 2)        # 2(a + b + 1/8)


xor = xor_   # `xor` is not a Python keyword: offer the reference's name too


def xnor(sk: ServerKey, a: BoolCiphertext, b: BoolCiphertext) -> BoolCiphertext:
    return _gate(sk, -_sum(sk, a, b, plaintext_true(sk.params)) * 2)       # 2(-(a + b) - 1/8)


def not_(a: BoolCiphertext) -> BoolCiphertext:
    """Negation is linear: no PBS (reference engine/mod.rs `not`)."""
    return BoolCiphertext(lwe=LweCiphertext(data=-a.lwe.data), log_q=a.log_q)


def mux(sk: ServerKey, cond: BoolCiphertext, then_ct: BoolCiphertext,
        else_ct: BoolCiphertext) -> BoolCiphertext:
    """(cond AND then) + (NOT cond AND else) + 1/8: two bootstraps and a
    linear recombination (reference engine/mod.rs:461-570).  Under PBS → KS
    the sum is keyswitched once, after both bootstraps."""
    false = plaintext_false(sk.params)
    c1 = _sum(sk, cond, then_ct, false)
    c2 = _sum(sk, not_(cond), else_ct, false)
    acc = sk.sign_accumulator
    if sk.params.pbs_order == PBSOrder.KEYSWITCH_BOOTSTRAP:
        p1 = programmable_bootstrap(keyswitch_lwe(LweCiphertext(c1), sk.ksk), acc, sk.bsk)
        p2 = programmable_bootstrap(keyswitch_lwe(LweCiphertext(c2), sk.ksk), acc, sk.bsk)
        out = p1.data + p2.data
        out[..., -1] += plaintext_true(sk.params)
        return BoolCiphertext(lwe=LweCiphertext(data=out), log_q=sk.params.log_q)
    p1 = programmable_bootstrap(LweCiphertext(c1), acc, sk.bsk)
    p2 = programmable_bootstrap(LweCiphertext(c2), acc, sk.bsk)
    out = p1.data + p2.data
    out[..., -1] += plaintext_true(sk.params)
    return BoolCiphertext(lwe=keyswitch_lwe(LweCiphertext(data=out), sk.ksk),
                          log_q=sk.params.log_q)


# ---------------------------------------------------------------------------
# public keys (reference boolean/public_key/)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PublicKey:
    """List-of-zero-encryptions public key for the boolean scheme."""

    pk: LwePublicKey
    params: BooleanParameters

    @property
    def device(self) -> torch.device:
        return self.pk.data.device


def gen_public_key(ck: ClientKey, zero_count: int | None = None, seed: int = 0) -> PublicKey:
    """2n encryptions of zero (or zero_count) under the encryption key,
    masks from fork(key_from_seed(seed), 0xB0B) as the JAX package draws
    them, noise from a generator of the seed."""
    zero_count = zero_count or 2 * ck.encryption_key.lwe_dimension
    key = threefry.fork(threefry.key_from_seed(seed, ck.device), 0xB0B)
    pk = generate_lwe_public_key(key, rng.generator(seed, 0xB0B, device=ck.device),
                                 ck.encryption_key, zero_count, _fresh_noise_std(ck.params),
                                 ck.params.log_q)
    return PublicKey(pk=pk, params=ck.params)


def encrypt_with_public_key(pk: PublicKey, messages, seed: int = 0) -> BoolCiphertext:
    """The subset of fork(key_from_seed(seed), 0xB0C) summed (one K2′
    launch on the card): bit-identical to the JAX package's encryption on
    the same key and seed."""
    pts = _encode(pk.params, messages, pk.device)
    key = threefry.fork(threefry.key_from_seed(seed, pk.device), 0xB0C)
    return BoolCiphertext(lwe=encrypt_lwe_with_public_key(key, pk.pk, pts),
                          log_q=pk.params.log_q)


# ---------------------------------------------------------------------------
# compressed (seeded) server and public keys (reference boolean/server_key
# CompressedServerKey, boolean/public_key/compressed.rs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CompressedServerKey:
    """Seeds and bodies only: the BSK's GGSW masks and the KSK's masks
    regenerate from the seeds on decompression ((k+1)x and (n+1)x smaller
    on the wire)."""

    seeded_bsk: seeded.SeededLweBootstrapKey
    seeded_ksk: seeded.SeededLweKeyswitchKey
    params: BooleanParameters = None

    def decompress(self, device=None) -> ServerKey:
        """The server key on the bodies' device (or `device`)."""
        bsk, ksk = seeded.decompress_server_key(self.seeded_bsk, self.seeded_ksk, device)
        return ServerKey(bsk=bsk, ksk=ksk, params=_checked(self.params))


def gen_compressed_server_key(ck: ClientKey, seed: int = 0) -> CompressedServerKey:
    """The compressed twin of gen_server_key (reference
    boolean::CompressedServerKey::new): BSK masks from seed 2s+0xB001, KSK
    masks from 2s+0xB002, as the JAX package lays them out."""
    p = ck.params
    _, sbsk = seeded.generate_seeded_bootstrap_key(
        seed * 2 + 0xB001, rng.generator(seed, 0xB0, 5, device=ck.device), ck.lwe_sk,
        ck.glwe_sk, p.pbs_decomp, p.glwe_noise_std, p.log_q)
    _, sksk = seeded.generate_seeded_keyswitch_key(
        seed * 2 + 0xB002, rng.generator(seed, 0xB0, 6, device=ck.device),
        ck.glwe_sk.as_lwe_secret_key(), ck.lwe_sk, p.ks_decomp, p.lwe_noise_std, p.log_q)
    return CompressedServerKey(seeded_bsk=sbsk, seeded_ksk=sksk, params=p)


@dataclass(frozen=True)
class CompressedPublicKey:
    """A seeded list-of-zero-encryptions public key: the bodies and the
    mask's seed (reference boolean/public_key/compressed.rs)."""

    seeded: seeded.SeededLwePublicKey
    params: BooleanParameters = None

    def decompress(self, device=None) -> PublicKey:
        return PublicKey(pk=seeded.decompress_lwe_public_key(self.seeded, device),
                         params=self.params)


def gen_compressed_public_key(ck: ClientKey, zero_count: int | None = None,
                              seed: int = 0) -> CompressedPublicKey:
    """Masks from seed 2s+0xB003, as the JAX package lays them out."""
    zero_count = zero_count or 2 * ck.encryption_key.lwe_dimension
    _, spk = seeded.generate_seeded_lwe_public_key(
        seed * 2 + 0xB003, rng.generator(seed, 0xB0, 7, device=ck.device), ck.encryption_key,
        zero_count, _fresh_noise_std(ck.params), ck.params.log_q)
    return CompressedPublicKey(seeded=spk, params=ck.params)


# ---------------------------------------------------------------------------
# casting between boolean key sets (reference boolean/key_switching_key/)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BooleanKeySwitchingKey:
    ksk: LweKeyswitchKey
    dest_params: BooleanParameters

    def cast(self, ct: BoolCiphertext) -> BoolCiphertext:
        return BoolCiphertext(lwe=keyswitch_lwe(ct.lwe, self.ksk), log_q=self.dest_params.log_q)


def gen_key_switching_key(ck1: ClientKey, ck2: ClientKey, ks_base_log: int = 2,
                          ks_level: int = 8, seed: int = 0) -> BooleanKeySwitchingKey:
    """A KSK from ck1's encryption key to ck2's, on ck2's device."""
    ksk = generate_keyswitch_key(rng.generator(seed, 0xB5C, device=ck2.device),
                                 ck1.encryption_key, ck2.encryption_key,
                                 DecompParams(ks_base_log, ks_level),
                                 _fresh_noise_std(ck2.params), ck2.params.log_q)
    return BooleanKeySwitchingKey(ksk=ksk, dest_params=ck2.params)


__all__ = ["plaintext_true", "plaintext_false", "ClientKey",
           "ServerKey", "BoolCiphertext", "gen_client_key", "gen_keys", "gen_server_key", "encrypt",
           "CompressedCiphertext", "encrypt_compressed",
           "trivial_encrypt", "decrypt", "and_", "nand", "or_", "nor", "xor_", "xor", "xnor",
           "not_", "mux", "PublicKey", "gen_public_key", "encrypt_with_public_key",
           "CompressedServerKey", "gen_compressed_server_key", "CompressedPublicKey",
           "gen_compressed_public_key", "BooleanKeySwitchingKey", "gen_key_switching_key"]
