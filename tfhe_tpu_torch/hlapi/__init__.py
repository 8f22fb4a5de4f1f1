"""High-level API: FheUint / FheInt / FheBool with Python operators.

Counterpart of `tfhe_tpu/hlapi/__init__.py` (reference tfhe/src/high_level_api/):
`ConfigBuilder` → `generate_keys` → typed encrypted integers whose operators
dispatch to the radix server key.  As the reference's thread-local
`set_server_key` (high_level_api/global_state.rs:13-15, 62) and the JAX
package's module state, the server key is installed once and every operator
uses it.  Every Fhe value holds a batch ([...] leading axes).  The operators
add no work of their own: each is one integer-layer op, whose KS+PBS calls
launch the pass, K2′ and K1 (or K3) on the card.

Keys and encryptions run on the card unless given device="cpu"
(`generate_keys`; the others follow their key's device).  `PublicKey`,
`CompactPublicKey`, `CompressedServerKey` and `CompressedFheUint` draw
their masks and subsets from threefry streams as the JAX package draws
them (`core/threefry.py`), so on the same key and seed their encryptions'
masks equal the JAX package's; Gaussian noise is the port's own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import integer, shortint
from ..core import rng, threefry
from ..core.algorithms.public_key import (encrypt_lwe_compact_batch,
                                          encrypt_lwe_with_public_key,
                                          generate_lwe_compact_public_key,
                                          generate_lwe_public_key)
from ..core.algorithms.seeded import decompress_lwe, encrypt_lwe_seeded
from ..core.entities import LweCiphertext
from ..core.numeric import as_i64
from ..core.params import shortint_params
from ..integer.ciphertext import BooleanBlock, RadixCiphertext, SignedRadixCiphertext
from ..shortint.ciphertext import Ciphertext as Block
from ..shortint.ciphertext import NoiseLevel
from ..shortint.client_key import delta_for

__all__ = ["ConfigBuilder", "Config", "ClientKey", "ServerKey", "PublicKey",
           "CompactPublicKey", "CompressedServerKey", "CompressedFheUint",
           "generate_keys", "set_server_key", "unset_server_key",
           "FheBool", "FheUint2", "FheUint4", "FheUint8", "FheUint16",
           "FheUint32", "FheUint64", "FheUint128", "FheUint256",
           "FheInt8", "FheInt16", "FheInt32", "FheInt64",
           "FheInt128", "FheInt256"]

_SERVER_KEY: Optional[integer.ServerKey] = None


def set_server_key(sk: "ServerKey") -> None:
    global _SERVER_KEY
    _SERVER_KEY = sk.radix


def unset_server_key() -> None:
    global _SERVER_KEY
    _SERVER_KEY = None


def _sk() -> integer.ServerKey:
    if _SERVER_KEY is None:
        raise RuntimeError("no server key set: call set_server_key(server_key)")
    return _SERVER_KEY


@dataclass(frozen=True)
class Config:
    params_name: str = "PARAM_MESSAGE_2_CARRY_2_KS_PBS"


class ConfigBuilder:
    """Reference high_level_api/config.rs."""

    def __init__(self):
        self._params = "PARAM_MESSAGE_2_CARRY_2_KS_PBS"

    def use_custom_parameters(self, name: str) -> "ConfigBuilder":
        self._params = name
        return self

    def build(self) -> Config:
        return Config(params_name=self._params)

    @staticmethod
    def default() -> Config:
        return ConfigBuilder().build()


class ClientKey:
    def __init__(self, shortint_ck: shortint.ClientKey):
        self.shortint_ck = shortint_ck

    def radix(self, num_blocks: int) -> integer.RadixClientKey:
        return integer.RadixClientKey(key=self.shortint_ck, num_blocks=num_blocks)


class ServerKey:
    def __init__(self, radix: integer.ServerKey):
        self.radix = radix


def _blocks_of(values, num_blocks: int, m: int) -> tuple:
    """(shape, little-endian base-m digits [V] object arrays) of values of
    any width, negative ones in two's complement."""
    vals = np.asarray(values, dtype=object)
    flat = vals.reshape(-1) % (m ** num_blocks)
    return vals.shape, [(flat // m ** i) % m for i in range(num_blocks)]


def _block(lwe: LweCiphertext, params) -> Block:
    return Block(lwe=lwe, degree=params.message_modulus - 1,
                 message_modulus=params.message_modulus, carry_modulus=params.carry_modulus,
                 noise_level=NoiseLevel.NOMINAL)


def _plaintexts(digits, shape, params, device) -> torch.Tensor:
    """Block digits → their torus plaintexts digit * Δ, int64 [shape]."""
    d = torch.as_tensor(np.asarray(digits, dtype=np.int64).reshape(shape), device=device)
    return d * as_i64(delta_for(params))


class PublicKey:
    """An encryption-only key: zero_count LWE encryptions of zero, a fresh
    binary subset of them summed per ciphertext (reference `PublicKey`,
    high_level_api/keys/public.rs over core lwe_public_key.rs).  The masks
    are those of tfhe_tpu's PublicKey under fork(key_from_seed(seed),
    0xA11); a ciphertext's subset that of fork(key_from_seed(seed * 1013 +
    i), 0xA12) for block i, as there."""

    def __init__(self, client_key: ClientKey, zero_count: int = None, seed: int = 1):
        ck = client_key.shortint_ck
        dev = ck.device
        key = threefry.fork(threefry.key_from_seed(seed, dev), 0xA11)
        self.pk = generate_lwe_public_key(key, rng.generator(seed, 0xA11, device=dev),
                                          ck.encryption_key,
                                          zero_count or 2 * ck.encryption_key.lwe_dimension,
                                          ck.encryption_noise_std)
        self.params = ck.params

    def encrypt_radix(self, values, num_blocks: int, seed: int = 0) -> RadixCiphertext:
        p, dev = self.params, self.pk.data.device
        shape, digits = _blocks_of(values, num_blocks, p.message_modulus)
        blocks = []
        for i, d in enumerate(digits):
            key = threefry.fork(threefry.key_from_seed(seed * 1013 + i, dev), 0xA12)
            blocks.append(_block(encrypt_lwe_with_public_key(
                key, self.pk, _plaintexts(d, shape, p, dev)), p))
        return RadixCiphertext(blocks=blocks)


class CompactPublicKey:
    """The ring-LWE compact public key: one (a(X), b(X)) pair; a batch of
    ciphertexts shares one encryption polynomial (reference
    `CompactPublicKey`, core lwe_compact_public_key.rs).  It needs a
    power-of-two encryption-key dimension.  a from fork(key_from_seed(seed),
    0xA21), each batch's r from fork(key_from_seed(seed), 0xA22), as
    tfhe_tpu's."""

    def __init__(self, client_key: ClientKey, seed: int = 2):
        ck = client_key.shortint_ck
        dev = ck.device
        key = threefry.fork(threefry.key_from_seed(seed, dev), 0xA21)
        self.pk = generate_lwe_compact_public_key(key, rng.generator(seed, 0xA21, device=dev),
                                                  ck.encryption_key, ck.encryption_noise_std)
        self.params = ck.params

    def encrypt_radix(self, values, num_blocks: int, seed: int = 0) -> RadixCiphertext:
        p, dev = self.params, self.pk.data.device
        shape, digits = _blocks_of(values, num_blocks, p.message_modulus)
        pts = _plaintexts(np.stack(digits, axis=-1), (-1, num_blocks), p, dev)     # [V, nb]
        key = threefry.fork(threefry.key_from_seed(seed, dev), 0xA22)
        cts = encrypt_lwe_compact_batch(key, rng.generator(seed, 0xA22, device=dev), self.pk,
                                        pts, p.glwe_noise_std)
        return RadixCiphertext(blocks=[
            _block(LweCiphertext(data=cts.data[..., i, :].reshape(
                tuple(shape) + tuple(cts.data.shape[-1:]))), p) for i in range(num_blocks)])


class CompressedServerKey:
    """Seeds and bodies on the wire (reference CompressedServerKey): the
    shortint compressed key of `shortint.gen_compressed_server_key`."""

    def __init__(self, client_key: ClientKey, seed: int = 3):
        self.inner = shortint.gen_compressed_server_key(client_key.shortint_ck, seed=seed)

    def decompress(self, device=None) -> ServerKey:
        return ServerKey(integer.ServerKey(key=self.inner.decompress(device)))


def generate_keys(config: Config = None, seed: int = 0, shift_key=None, device="cuda"):
    """→ (ClientKey, ServerKey) (reference tfhe::generate_keys) at the
    config's parameters, on the card unless given device="cpu"; without a
    card that raises.  shift_key: None, or a WoP-PBS parameter set, its
    name or "auto" to build the GGSW-selector shift key too, which the
    encrypted-amount `<<`, `>>` and rotations then take
    (integer/shift_key.py)."""
    config = config or ConfigBuilder.default()
    ck, sk = shortint.gen_keys(shortint_params(config.params_name), seed=seed, device=device)
    shk = None
    if shift_key is not None:
        from ..integer.shift_key import new_shift_key
        shk = new_shift_key(ck, sk, shift_key, seed=seed)
    return ClientKey(ck), ServerKey(integer.ServerKey(key=sk, shift_key=shk))


class _FheUintBase:
    """GenericInteger<P> (high_level_api/integers/types/base.rs)."""

    NUM_BITS: int = 8
    SIGNED: bool = False

    def __init__(self, ct: RadixCiphertext):
        self.ct = ct

    # -- encryption ----------------------------------------------------

    @classmethod
    def num_blocks(cls, ck: ClientKey) -> int:
        return cls.NUM_BITS // int(math.log2(ck.shortint_ck.params.message_modulus))

    @classmethod
    def encrypt(cls, values, ck: ClientKey, seed: int = 0):
        rck = ck.radix(cls.num_blocks(ck))
        return cls(rck.encrypt_signed(values, seed=seed) if cls.SIGNED
                   else rck.encrypt(values, seed=seed))

    @classmethod
    def encrypt_trivial(cls, values, ck: ClientKey):
        return cls(ck.radix(cls.num_blocks(ck)).trivial_encrypt(values))

    def decrypt(self, ck: ClientKey):
        rck = ck.radix(self.ct.num_blocks)
        if self.SIGNED:
            return rck.decrypt_signed(SignedRadixCiphertext(blocks=self.ct.blocks))
        return rck.decrypt(self.ct)

    # -- operators -----------------------------------------------------

    def _wrap(self, ct):
        return type(self)(ct)

    def _binary(self, other, op: str, scalar_op: str):
        if isinstance(other, _FheUintBase):
            return self._wrap(getattr(_sk(), op)(self.ct, other.ct))
        return self._wrap(getattr(_sk(), scalar_op)(self.ct, int(other)))

    def __add__(self, other):
        return self._binary(other, "add", "scalar_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "sub", "scalar_sub")

    def __rsub__(self, other):
        return self._wrap(_sk().scalar_add(_sk().neg(self.ct), int(other)))

    def __mul__(self, other):
        return self._binary(other, "mul", "scalar_mul")

    __rmul__ = __mul__

    def __neg__(self):
        return self._wrap(_sk().neg(self.ct))

    def __and__(self, other):
        return self._binary(other, "bitand", "scalar_bitand")

    __rand__ = __and__

    def __or__(self, other):
        return self._binary(other, "bitor", "scalar_bitor")

    __ror__ = __or__

    def __xor__(self, other):
        return self._binary(other, "bitxor", "scalar_bitxor")

    __rxor__ = __xor__

    def __invert__(self):
        return self._wrap(_sk().bitnot(self.ct))

    def __lshift__(self, shift):
        return self._binary(shift, "left_shift", "scalar_left_shift")

    def __rshift__(self, shift):
        """Logical for FheUint, arithmetic (sign-extending) for FheInt, as
        the reference's Shr for each type."""
        if self.SIGNED:
            return self._binary(shift, "right_shift_arithmetic",
                                "scalar_right_shift_arithmetic")
        return self._binary(shift, "right_shift", "scalar_right_shift")

    def rotate_left(self, amount):
        """Bit rotation (reference FheUint::rotate_left)."""
        return self._binary(amount, "rotate_left", "scalar_rotate_left")

    def rotate_right(self, amount):
        return self._binary(amount, "rotate_right", "scalar_rotate_right")

    def __floordiv__(self, other):
        return self._binary(other, "div",
                            "signed_scalar_div" if self.SIGNED else "scalar_div")

    def __truediv__(self, other):
        return self.__floordiv__(other)

    def __mod__(self, other):
        return self._binary(other, "rem",
                            "signed_scalar_rem" if self.SIGNED else "scalar_rem")

    def abs(self):
        return self._wrap(_sk().abs_signed(self.ct)) if self.SIGNED else self

    # -- comparisons: FheBool ------------------------------------------

    def _compare(self, other, name: str, signed_too: bool) -> "FheBool":
        suffix = "_signed" if signed_too and self.SIGNED else ""
        if isinstance(other, _FheUintBase):
            return FheBool(getattr(_sk(), name + suffix)(self.ct, other.ct))
        return FheBool(getattr(_sk(), "scalar_" + name + suffix)(self.ct, int(other)))

    def eq(self, other):
        return self._compare(other, "eq", False)

    def ne(self, other):
        return self._compare(other, "ne", False)

    def lt(self, other):
        return self._compare(other, "lt", True)

    def le(self, other):
        return self._compare(other, "le", True)

    def gt(self, other):
        return self._compare(other, "gt", True)

    def ge(self, other):
        return self._compare(other, "ge", True)

    __eq__ = eq
    __ne__ = ne
    __lt__ = lt
    __le__ = le
    __gt__ = gt
    __ge__ = ge
    __hash__ = None

    def _as_ct(self, other):
        """A clear scalar as a trivial radix of this width."""
        if isinstance(other, _FheUintBase):
            return other.ct
        return _sk().create_trivial_radix(int(other) % (1 << self.NUM_BITS), self.ct.num_blocks,
                                          self.ct.batch_shape)

    def min(self, other):
        fn = _sk().min_signed if self.SIGNED else _sk().min
        return self._wrap(fn(self.ct, self._as_ct(other)))

    def max(self, other):
        fn = _sk().max_signed if self.SIGNED else _sk().max
        return self._wrap(fn(self.ct, self._as_ct(other)))

    def overflowing_add(self, other):
        """(wrapped sum, overflow flag) (reference overflowing_add)."""
        fn = _sk().signed_overflowing_add if self.SIGNED else _sk().unsigned_overflowing_add
        s, ov = fn(self.ct, self._as_ct(other))
        return self._wrap(s), FheBool(ov)

    def overflowing_sub(self, other):
        fn = _sk().signed_overflowing_sub if self.SIGNED else _sk().unsigned_overflowing_sub
        d, ov = fn(self.ct, self._as_ct(other))
        return self._wrap(d), FheBool(ov)

    def cast_into(self, target_cls):
        """A width cast (reference cast_into): the block list resized."""
        bits = int(math.log2(self.ct.message_modulus))
        return target_cls(_sk().cast_to_size(self.ct, target_cls.NUM_BITS // bits))

    @classmethod
    def encrypt_with_public_key(cls, values, pk: PublicKey, seed: int = 0):
        """Reference FheUint::try_encrypt(clear, &PublicKey)."""
        bits = int(math.log2(pk.params.message_modulus))
        return cls(pk.encrypt_radix(values, cls.NUM_BITS // bits, seed=seed))

    @classmethod
    def encrypt_with_compact_public_key(cls, values, pk: CompactPublicKey, seed: int = 0):
        bits = int(math.log2(pk.params.message_modulus))
        return cls(pk.encrypt_radix(values, cls.NUM_BITS // bits, seed=seed))

    @classmethod
    def encrypt_compressed(cls, values, ck: ClientKey, seed: int = 1):
        """Reference CompressedFheUint::try_encrypt: seeded blocks whose
        masks regenerate on decompression."""
        return CompressedFheUint.encrypt(values, ck, cls, seed=seed)


class CompressedFheUint:
    """A seeded radix ciphertext: each block keeps its bodies and a seed
    (reference CompressedFheUint / CompressedRadixCiphertext); block i's
    masks are those of tfhe_tpu's for seed * 4099 + i."""

    def __init__(self, seeded_blocks, fhe_cls, params):
        self.seeded_blocks = seeded_blocks
        self.fhe_cls = fhe_cls
        self.params = params

    @classmethod
    def encrypt(cls, values, ck: ClientKey, fhe_cls, seed: int = 1):
        sck = ck.shortint_ck
        p = sck.params
        shape, digits = _blocks_of(values, fhe_cls.num_blocks(ck), p.message_modulus)
        blocks = [encrypt_lwe_seeded(seed * 4099 + i,
                                     rng.generator(seed * 4099 + i, 0x3E, device=sck.device),
                                     sck.encryption_key,
                                     _plaintexts(d, shape, p, sck.device),
                                     sck.encryption_noise_std)
                  for i, d in enumerate(digits)]
        return cls(blocks, fhe_cls, p)

    def decompress(self):
        return self.fhe_cls(RadixCiphertext(blocks=[_block(decompress_lwe(s), self.params)
                                                    for s in self.seeded_blocks]))


class FheBool:
    """Reference FheBool: one block holding 0 or 1."""

    def __init__(self, block: BooleanBlock):
        self.block = block

    @classmethod
    def encrypt(cls, values, ck: ClientKey, seed: int = 0):
        msgs = torch.remainder(torch.as_tensor(np.asarray(values, dtype=np.int64)), 2)
        return cls(BooleanBlock(block=ck.shortint_ck.encrypt(msgs, seed=seed)))

    def decrypt(self, ck: ClientKey):
        return ck.shortint_ck.decrypt(self.block.block).cpu().numpy().astype(bool)

    def select(self, then_val: _FheUintBase, else_val: _FheUintBase):
        """Reference if_then_else."""
        return type(then_val)(_sk().cmux(self.block, then_val.ct, else_val.ct))

    if_then_else = select

    def _gate(self, other, op: str) -> "FheBool":
        sk = _sk().key
        return FheBool(type(self.block)(block=getattr(sk, op)(self.block.block,
                                                              other.block.block)))

    def __and__(self, other):
        return self._gate(other, "bitand")

    def __or__(self, other):
        return self._gate(other, "bitor")

    def __xor__(self, other):
        return self._gate(other, "bitxor")

    def __invert__(self):
        sk = _sk().key
        return FheBool(type(self.block)(
            block=sk.evaluate_univariate(self.block.block, lambda x: 1 - (x % 2))))

    def eq(self, other):
        return ~(self ^ other)

    def ne(self, other):
        return self ^ other


def _make_type(name, bits, signed=False):
    t = type(name, (_FheUintBase,), {"NUM_BITS": bits, "SIGNED": signed})
    t.__module__ = __name__
    return t


FheUint2 = _make_type("FheUint2", 2)
FheUint4 = _make_type("FheUint4", 4)
FheUint8 = _make_type("FheUint8", 8)
FheUint16 = _make_type("FheUint16", 16)
FheUint32 = _make_type("FheUint32", 32)
FheUint64 = _make_type("FheUint64", 64)
FheUint128 = _make_type("FheUint128", 128)
FheUint256 = _make_type("FheUint256", 256)
FheInt8 = _make_type("FheInt8", 8, signed=True)
FheInt16 = _make_type("FheInt16", 16, signed=True)
FheInt32 = _make_type("FheInt32", 32, signed=True)
FheInt64 = _make_type("FheInt64", 64, signed=True)
FheInt128 = _make_type("FheInt128", 128, signed=True)
FheInt256 = _make_type("FheInt256", 256, signed=True)
