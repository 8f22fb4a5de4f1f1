"""Shortint server key: lookup tables, the keyswitch + PBS atomic pattern on
classic or multi-bit keys, and the arithmetic op families (counterpart of
`tfhe_tpu/shortint/server_key.py`; reference shortint/server_key/, the
per-op files add.rs, mul.rs, div_mod.rs, bitwise_op.rs, comp_op.rs,
shift.rs, scalar_*.rs).

Op families (reference semantics):
  unchecked_*  no precondition checks, degrees add up;
  checked_*    raise CheckError if the result would overflow the carry space
               or the noise budget;
  smart_*      bootstrap operands first when needed (a decision on the
               metadata alone);
  *            the default ops: smart, then a message extract of the result
               (what the high-level API uses).
The ops are linear glue and lookup tables over `apply_lookup_table`, whose
PBS is the CUDA kernel K1 (classic keys) or K3 (multi-bit keys) on the card,
or K4 / K5 once per step on the per-step routes (`config.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import config
from ..core import rng
from ..core.algorithms import seeded
from ..core.algorithms import (bootstrap_key_to_ntt, external_product_num_primes,
                               generate_bootstrap_key, generate_keyswitch_key,
                               generate_multi_bit_bootstrap_key, keyswitch_lwe,
                               multi_bit_blind_rotate, multi_bit_bootstrap_key_to_ntt,
                               programmable_bootstrap, sample_extract, trivial_glwe,
                               trivial_lwe)
from ..core.entities import (GlweCiphertext, LweCiphertext, LweKeyswitchKey,
                             NttBootstrapKey, NttMultiBitBootstrapKey)
from ..core.numeric import as_i64, from_numpy_u64
from ..core.params import EncryptionKeyChoice, MultiBitPBSParameters, PBSOrder
from ..core.poly.rotation import multi_bit_blind_rotate_steps
from .ciphertext import CheckError, Ciphertext, MaxNoiseLevel, NoiseLevel
from .client_key import ClientKey, delta_for


class MaxDegree:
    """Reference `MaxDegree` (shortint/server_key/mod.rs): the largest value
    representable without touching the padding bit."""

    @staticmethod
    def integer_radix(message_modulus: int, carry_modulus: int) -> int:
        return message_modulus * carry_modulus - 1


@dataclass(frozen=True)
class LookupTable:
    """An accumulator GLWE and the output degree bound
    (reference `LookupTableOwned`, shortint/server_key/mod.rs:383)."""

    acc: GlweCiphertext
    degree: int = 0


@dataclass(frozen=True)
class ServerKey:
    ksk: LweKeyswitchKey
    bsk: NttBootstrapKey | NttMultiBitBootstrapKey
    params: object

    @property
    def device(self) -> torch.device:
        return self.bsk.spectra.device

    @property
    def message_modulus(self) -> int:
        return self.params.message_modulus

    @property
    def carry_modulus(self) -> int:
        return self.params.carry_modulus

    @property
    def max_degree(self) -> int:
        return MaxDegree.integer_radix(self.message_modulus, self.carry_modulus)

    @property
    def max_noise_level(self) -> MaxNoiseLevel:
        return MaxNoiseLevel.from_msg_carry_modulus(self.message_modulus,
                                                    self.carry_modulus)

    def _torus(self, value: int) -> int:
        """value * Δ mod 2^64, as an int64."""
        return as_i64(value * delta_for(self.params))

    # ------------------------------------------------------------------
    # LUT machinery and the atomic pattern
    # ------------------------------------------------------------------

    def generate_lookup_table(self, f: Callable[[int], int]) -> LookupTable:
        """Accumulator for x ↦ f(x) over the message+carry space: a box of
        N/p coefficients per input value, rotated by half a box so the
        rounding window centres on each message; the negacyclic wrap
        negates the tail."""
        p = self.message_modulus * self.carry_modulus
        n_poly = self.params.polynomial_size
        box = n_poly // p
        vals = np.array([f(i) % (2 * p) for i in range(p)], dtype=np.uint64)
        poly = np.repeat(vals * np.uint64(delta_for(self.params)), box)
        poly = np.roll(poly, -(box // 2))
        poly[-(box // 2):] = np.uint64(0) - poly[-(box // 2):]
        acc = trivial_glwe(from_numpy_u64(poly, self.device),
                           self.params.glwe_dimension)
        return LookupTable(acc=acc, degree=int(vals.max()))

    def generate_lookup_table_raw(self, values) -> LookupTable:
        """The accumulator whose box for input value i holds the raw torus
        word values[i] (no Δ scaling; tfhe_tpu server_key.py:99), p =
        msg_mod * carry_mod values."""
        p = self.message_modulus * self.carry_modulus
        box = self.params.polynomial_size // p
        vals = np.asarray([int(v) & ((1 << 64) - 1) for v in values], dtype=np.uint64)
        if vals.shape != (p,):
            raise ValueError(f"a raw LUT takes {p} values, not {vals.shape}")
        poly = np.roll(np.repeat(vals, box), -(box // 2))
        poly[-(box // 2):] = np.uint64(0) - poly[-(box // 2):]
        acc = trivial_glwe(from_numpy_u64(poly, self.device), self.params.glwe_dimension)
        return LookupTable(acc=acc, degree=p - 1)

    def generate_msg_lookup_table(self, f: Callable[[int], int]) -> LookupTable:
        m = self.message_modulus
        return self.generate_lookup_table(lambda x: f(x) % m)

    def generate_bivariate_lookup_table(self, f: Callable[[int, int], int]) -> LookupTable:
        """LUT over the packed value left * msg_mod + right."""
        m = self.message_modulus
        return self.generate_lookup_table(lambda x: f(x // m, x % m))

    def generate_lookup_table_bivariate_with_factor(
            self, f: Callable[[int, int], int], factor: int) -> LookupTable:
        """LUT over left * factor + right, factor possibly below msg_mod
        (reference bivariate_pbs.rs)."""
        return self.generate_lookup_table(lambda x: f(x // factor, x % factor))

    def _pbs(self, lwe: LweCiphertext, acc: GlweCiphertext) -> LweCiphertext:
        """Classic or multi-bit bootstrap, by the key's type (the reference's
        ShortintBootstrappingKey::Classic | MultiBit), on the route the key
        and the switches choose, as tfhe_tpu shortint/server_key.py:127-154
        chooses it: a multi-bit key converted for the fused route runs K3
        while `use_fused_rotation()` is on, else one K5 launch per step; a
        classic key routes in `programmable_bootstrap`."""
        if isinstance(self.bsk, NttMultiBitBootstrapKey):
            if self.bsk.route == "fused" and config.use_fused_rotation():
                rotated = multi_bit_blind_rotate(acc, lwe, self.bsk)
            else:
                rotated = GlweCiphertext(data=multi_bit_blind_rotate_steps(
                    acc.data, lwe.data, self.bsk))
            return sample_extract(rotated, 0)
        return programmable_bootstrap(lwe, acc, self.bsk)

    def apply_lookup_table(self, ct: Ciphertext, lut: LookupTable) -> Ciphertext:
        """KS → PBS (KEYSWITCH_BOOTSTRAP) or PBS → KS, per the parameters."""
        if self.params.pbs_order == PBSOrder.KEYSWITCH_BOOTSTRAP:
            out = self._pbs(keyswitch_lwe(ct.lwe, self.ksk), lut.acc)
        else:
            out = keyswitch_lwe(self._pbs(ct.lwe, lut.acc), self.ksk)
        return ct.with_(lwe=out, degree=lut.degree, noise_level=NoiseLevel.NOMINAL)

    def evaluate_univariate(self, ct: Ciphertext, f: Callable[[int], int]) -> Ciphertext:
        return self.apply_lookup_table(ct, self.generate_lookup_table(f))

    def evaluate_msg_univariate(self, ct: Ciphertext, f: Callable[[int], int]) -> Ciphertext:
        return self.apply_lookup_table(ct, self.generate_msg_lookup_table(f))

    def unchecked_bivariate_pack_with_factor(self, left: Ciphertext, right: Ciphertext,
                                             factor: int) -> Ciphertext:
        """left * factor + right (requires right.degree < factor)."""
        data = left.lwe.data * factor + right.lwe.data
        return left.with_(lwe=LweCiphertext(data=data),
                          degree=left.degree * factor + right.degree,
                          noise_level=left.noise_level * factor + right.noise_level)

    def unchecked_bivariate_pack(self, left: Ciphertext, right: Ciphertext) -> Ciphertext:
        """left * msg_mod + right (requires right.degree < msg_mod)."""
        return self.unchecked_bivariate_pack_with_factor(left, right, self.message_modulus)

    def unchecked_apply_lookup_table_bivariate(self, left: Ciphertext,
                                               right: Ciphertext,
                                               lut: LookupTable) -> Ciphertext:
        return self.apply_lookup_table(self.unchecked_bivariate_pack(left, right), lut)

    def smart_evaluate_bivariate(self, left: Ciphertext, right: Ciphertext,
                                 f: Callable[[int, int], int]) -> Ciphertext:
        left, right = self._prepare_bivariate(left, right)
        return self.unchecked_apply_lookup_table_bivariate(
            left, right, self.generate_bivariate_lookup_table(f))

    def _prepare_bivariate(self, left, right):
        if right.degree >= self.message_modulus or not self._noise_ok(right.noise_level):
            right = self.message_extract(right)
        if not self.is_bivariate_pbs_possible(left, right):
            left = self.message_extract(left)
        return left, right

    # ------------------------------------------------------------------
    # carry / message extraction
    # ------------------------------------------------------------------

    def carry_extract(self, ct: Ciphertext) -> Ciphertext:
        """x ↦ x // msg_mod (reference carry_extract)."""
        m = self.message_modulus
        out = self.evaluate_univariate(ct, lambda x: x // m)
        return out.with_(degree=min(out.degree, ct.degree // m))

    def message_extract(self, ct: Ciphertext) -> Ciphertext:
        """x ↦ x % msg_mod (reference message_extract)."""
        m = self.message_modulus
        out = self.evaluate_univariate(ct, lambda x: x % m)
        return out.with_(degree=min(m - 1, ct.degree))

    # ------------------------------------------------------------------
    # additive ops
    # ------------------------------------------------------------------

    def unchecked_add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return a.with_(lwe=LweCiphertext(data=a.lwe.data + b.lwe.data),
                       degree=a.degree + b.degree,
                       noise_level=a.noise_level + b.noise_level)

    def checked_add(self, a, b):
        if a.degree + b.degree > self.max_degree:
            raise CheckError("CarryFull: add would overflow the carry buffer")
        self.max_noise_level.validate(a.noise_level + b.noise_level)
        return self.unchecked_add(a, b)

    def smart_add(self, a, b):
        if not self.is_add_possible(a, b):
            a, b = self.message_extract(a), self.message_extract(b)
        return self.unchecked_add(a, b)

    def add(self, a, b):
        return self.message_extract(self.smart_add(a, b))

    def unchecked_neg(self, a: Ciphertext) -> Ciphertext:
        """-x as z*msg_mod - x, z*msg_mod the least multiple of msg_mod above
        the degree (reference unchecked_neg_with_correcting_term)."""
        z = self._correcting_term(a)
        data = -a.lwe.data
        data[..., -1] += self._torus(z)
        return a.with_(lwe=LweCiphertext(data=data), degree=z - 1)

    def _correcting_term(self, a) -> int:
        m = self.message_modulus
        return -(-(a.degree + 1) // m) * m

    def smart_neg(self, a):
        if (a.degree >= self.message_modulus * self.carry_modulus - self.message_modulus
                or not self._noise_ok(a.noise_level)):
            a = self.message_extract(a)
        return self.unchecked_neg(a)

    def neg(self, a):
        return self.message_extract(self.smart_neg(a))

    def unchecked_sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.unchecked_add(a, self.unchecked_neg(b))

    def smart_sub(self, a, b):
        nb = self.unchecked_neg(
            b if b.degree < self.message_modulus and self._noise_ok(b.noise_level)
            else self.message_extract(b))
        if not self.is_add_possible(a, nb):
            a = self.message_extract(a)
        return self.unchecked_add(a, nb)

    def sub(self, a, b):
        return self.message_extract(self.smart_sub(a, b))

    def unchecked_neg_with_correcting_term(self, a):
        """→ (-a + z·Δ, z), z the msg_mod multiple that keeps it positive."""
        return self.unchecked_neg(a), self._correcting_term(a)

    def unchecked_sub_with_correcting_term(self, a, b):
        nb, z = self.unchecked_neg_with_correcting_term(b)
        return self.unchecked_add(a, nb), z

    def smart_sub_with_correcting_term(self, a, b):
        if b.degree >= self.message_modulus:
            b = self.message_extract(b)
        nb, z = self.unchecked_neg_with_correcting_term(b)
        if a.degree + nb.degree > self.max_degree:
            a = self.message_extract(a)
        return self.unchecked_add(a, nb), z

    # ------------------------------------------------------------------
    # scalar ops
    # ------------------------------------------------------------------

    def unchecked_scalar_add(self, a: Ciphertext, scalar: int) -> Ciphertext:
        data = a.lwe.data.clone()
        data[..., -1] += self._torus(scalar)
        return a.with_(lwe=LweCiphertext(data=data), degree=a.degree + scalar)

    def smart_scalar_add(self, a, scalar: int):
        if not self.is_scalar_add_possible(a, scalar):
            a = self.message_extract(a)
        return self.unchecked_scalar_add(a, scalar)

    def scalar_add(self, a, scalar: int):
        return self.message_extract(self.smart_scalar_add(a, scalar % self.message_modulus))

    def unchecked_scalar_mul(self, a: Ciphertext, scalar: int) -> Ciphertext:
        return a.with_(lwe=LweCiphertext(data=a.lwe.data * scalar),
                       degree=a.degree * scalar,
                       noise_level=a.noise_level * max(scalar, 1))

    def smart_scalar_mul(self, a, scalar: int):
        if not self.is_scalar_mul_possible(a, scalar):
            a = self.message_extract(a)
        if not self.is_scalar_mul_possible(a, scalar):   # still too big: a LUT
            return self.evaluate_univariate(a, lambda x: x * scalar)
        return self.unchecked_scalar_mul(a, scalar)

    def scalar_mul(self, a, scalar: int):
        m = self.message_modulus
        return self.evaluate_univariate(a, lambda x: (x * scalar) % m)

    def scalar_sub(self, a, scalar: int):
        m = self.message_modulus
        return self.evaluate_univariate(a, lambda x: (x - scalar) % m)

    def scalar_div(self, a, scalar: int):
        m = self.message_modulus
        return self.evaluate_univariate(a, lambda x: (x // scalar) % m)

    def scalar_mod(self, a, scalar: int):
        return self.evaluate_univariate(a, lambda x: x % scalar)

    def unchecked_scalar_div(self, a, scalar: int):
        if scalar == 0:
            raise ZeroDivisionError("shortint scalar_div by zero")
        return self.scalar_div(a, scalar)

    def unchecked_scalar_mod(self, a, scalar: int):
        if scalar == 0:
            raise ZeroDivisionError("shortint scalar_mod by zero")
        return self.scalar_mod(a, scalar)

    # ------------------------------------------------------------------
    # multiplication (reference mul.rs) and division (div_mod.rs)
    # ------------------------------------------------------------------

    def unchecked_mul_lsb(self, a, b):
        m = self.message_modulus
        return self.smart_evaluate_bivariate(a, b, lambda x, y: (x * y) % m)

    def unchecked_mul_msb(self, a, b):
        m = self.message_modulus
        return self.smart_evaluate_bivariate(a, b, lambda x, y: (x * y) // m)

    mul_lsb = smart_mul_lsb = mul = unchecked_mul_lsb
    mul_msb = smart_mul_msb = unchecked_mul_msb

    def checked_mul_lsb(self, a, b):
        self._check_bivariate(a, b)
        m = self.message_modulus
        return self.unchecked_apply_lookup_table_bivariate(
            a, b, self.generate_bivariate_lookup_table(lambda x, y: (x * y) % m))

    def checked_mul_msb(self, a, b):
        self._check_bivariate(a, b)
        m = self.message_modulus
        return self.unchecked_apply_lookup_table_bivariate(
            a, b, self.generate_bivariate_lookup_table(lambda x, y: (x * y) // m))

    def unchecked_mul_lsb_small_carry(self, a, b):
        """a·b mod m by the quarter-square identity ((a+b)² − (a−b)²)/4: two
        univariate PBS instead of one bivariate, for carry_modulus <
        message_modulus (reference unchecked_mul_lsb_small_carry_modulus)."""
        m, w = self.message_modulus, 1 << 64
        s = self.unchecked_add(a, b)
        d, z = self.unchecked_sub_with_correcting_term(a, b)
        ls = self.evaluate_univariate(s, lambda x: (x * x) % w // 4 % m)
        ld = self.evaluate_univariate(d, lambda x: ((x - z) % w) ** 2 % w // 4 % m)
        return self.unchecked_sub(ls, ld)

    def checked_mul_lsb_with_small_carry(self, a, b):
        if not self.is_mul_small_carry_possible(a, b):
            raise CheckError("CarryFull: small-carry mul would overflow")
        return self.unchecked_mul_lsb_small_carry(a, b)

    def _div(self, x: int, y: int) -> int:
        """Clear division; x/0 gives msg_mod - 1 as in the reference."""
        m = self.message_modulus
        return (x // y) % m if y != 0 else m - 1

    def div(self, a, b):
        return self.smart_evaluate_bivariate(a, b, self._div)

    smart_div = div

    def unchecked_div(self, a, b):
        return self.unchecked_apply_lookup_table_bivariate(
            a, b, self.generate_bivariate_lookup_table(self._div))

    # ------------------------------------------------------------------
    # bitwise (reference bitwise_op.rs)
    # ------------------------------------------------------------------

    def bitand(self, a, b):
        return self.smart_evaluate_bivariate(a, b, lambda x, y: x & y)

    def bitor(self, a, b):
        return self.smart_evaluate_bivariate(a, b, lambda x, y: x | y)

    def bitxor(self, a, b):
        return self.smart_evaluate_bivariate(a, b, lambda x, y: x ^ y)

    smart_bitand, smart_bitor, smart_bitxor = bitand, bitor, bitxor

    def unchecked_bitand(self, a, b):
        return self.unchecked_apply_lookup_table_bivariate(
            a, b, self.generate_bivariate_lookup_table(lambda x, y: x & y))

    def unchecked_bitor(self, a, b):
        return self.unchecked_apply_lookup_table_bivariate(
            a, b, self.generate_bivariate_lookup_table(lambda x, y: x | y))

    def unchecked_bitxor(self, a, b):
        return self.unchecked_apply_lookup_table_bivariate(
            a, b, self.generate_bivariate_lookup_table(lambda x, y: x ^ y))

    def checked_bitand(self, a, b):
        self._check_bivariate(a, b)
        return self.unchecked_bitand(a, b)

    def checked_bitor(self, a, b):
        self._check_bivariate(a, b)
        return self.unchecked_bitor(a, b)

    def checked_bitxor(self, a, b):
        self._check_bivariate(a, b)
        return self.unchecked_bitxor(a, b)

    def scalar_bitand(self, a, scalar: int):
        return self.evaluate_univariate(a, lambda x: x & scalar)

    def scalar_bitor(self, a, scalar: int):
        m = self.message_modulus
        return self.evaluate_univariate(a, lambda x: (x % m) | (scalar % m))

    def scalar_bitxor(self, a, scalar: int):
        m = self.message_modulus
        return self.evaluate_univariate(a, lambda x: (x % m) ^ (scalar % m))

    smart_scalar_bitand, smart_scalar_bitor, smart_scalar_bitxor = (
        scalar_bitand, scalar_bitor, scalar_bitxor)

    # ------------------------------------------------------------------
    # comparisons (reference comp_op.rs): smart/default prepare operands,
    # unchecked assume the bivariate domain fits, checked raise
    # ------------------------------------------------------------------

    def _cmp(self, a, b, op):
        return self.smart_evaluate_bivariate(a, b, lambda x, y: int(op(x, y)))

    def _unchecked_cmp(self, a, b, op):
        return self.unchecked_apply_lookup_table_bivariate(
            a, b, self.generate_bivariate_lookup_table(lambda x, y: int(op(x, y))))

    def _checked_cmp(self, a, b, op):
        self._check_bivariate(a, b)
        return self._unchecked_cmp(a, b, op)

    def equal(self, a, b):
        return self._cmp(a, b, lambda x, y: x == y)

    def not_equal(self, a, b):
        return self._cmp(a, b, lambda x, y: x != y)

    def greater(self, a, b):
        return self._cmp(a, b, lambda x, y: x > y)

    def greater_or_equal(self, a, b):
        return self._cmp(a, b, lambda x, y: x >= y)

    def less(self, a, b):
        return self._cmp(a, b, lambda x, y: x < y)

    def less_or_equal(self, a, b):
        return self._cmp(a, b, lambda x, y: x <= y)

    smart_equal, smart_not_equal, smart_greater = equal, not_equal, greater
    smart_greater_or_equal, smart_less, smart_less_or_equal = (
        greater_or_equal, less, less_or_equal)

    def unchecked_equal(self, a, b):
        return self._unchecked_cmp(a, b, lambda x, y: x == y)

    def unchecked_not_equal(self, a, b):
        return self._unchecked_cmp(a, b, lambda x, y: x != y)

    def unchecked_greater(self, a, b):
        return self._unchecked_cmp(a, b, lambda x, y: x > y)

    def unchecked_greater_or_equal(self, a, b):
        return self._unchecked_cmp(a, b, lambda x, y: x >= y)

    def unchecked_less(self, a, b):
        return self._unchecked_cmp(a, b, lambda x, y: x < y)

    def unchecked_less_or_equal(self, a, b):
        return self._unchecked_cmp(a, b, lambda x, y: x <= y)

    def checked_equal(self, a, b):
        return self._checked_cmp(a, b, lambda x, y: x == y)

    def checked_not_equal(self, a, b):
        return self._checked_cmp(a, b, lambda x, y: x != y)

    def checked_greater(self, a, b):
        return self._checked_cmp(a, b, lambda x, y: x > y)

    def checked_greater_or_equal(self, a, b):
        return self._checked_cmp(a, b, lambda x, y: x >= y)

    def checked_less(self, a, b):
        return self._checked_cmp(a, b, lambda x, y: x < y)

    def checked_less_or_equal(self, a, b):
        return self._checked_cmp(a, b, lambda x, y: x <= y)

    def scalar_equal(self, a, scalar: int):
        return self.evaluate_univariate(a, lambda x: int(x == scalar))

    def scalar_not_equal(self, a, scalar: int):
        return self.evaluate_univariate(a, lambda x: int(x != scalar))

    def scalar_greater(self, a, scalar: int):
        return self.evaluate_univariate(a, lambda x: int(x > scalar))

    def scalar_greater_or_equal(self, a, scalar: int):
        return self.evaluate_univariate(a, lambda x: int(x >= scalar))

    def scalar_less(self, a, scalar: int):
        return self.evaluate_univariate(a, lambda x: int(x < scalar))

    def scalar_less_or_equal(self, a, scalar: int):
        return self.evaluate_univariate(a, lambda x: int(x <= scalar))

    # operands are immutable here, so the reference's smart scalar
    # comparisons (clean in place, then compare) are the default ones
    smart_scalar_equal, smart_scalar_not_equal = scalar_equal, scalar_not_equal
    smart_scalar_greater, smart_scalar_greater_or_equal = (
        scalar_greater, scalar_greater_or_equal)
    smart_scalar_less, smart_scalar_less_or_equal = scalar_less, scalar_less_or_equal

    # ------------------------------------------------------------------
    # shifts (reference shift.rs): a left shift multiplies by 2^shift into
    # the carry; a right shift is a LUT
    # ------------------------------------------------------------------

    def scalar_left_shift(self, a, shift: int):
        m = self.message_modulus
        return self.evaluate_univariate(a, lambda x: (x << shift) % m)

    def scalar_right_shift(self, a, shift: int):
        return self.evaluate_univariate(a, lambda x: x >> shift)

    def unchecked_scalar_left_shift(self, a, shift: int):
        return self.unchecked_scalar_mul(a, 1 << shift)

    def checked_scalar_left_shift(self, a, shift: int):
        if not self.is_scalar_left_shift_possible(a, shift):
            raise ValueError("CarryFull: left shift would overflow")
        return self.unchecked_scalar_left_shift(a, shift)

    def smart_scalar_left_shift(self, a, shift: int):
        if not self.is_scalar_left_shift_possible(a, shift):
            a = self.message_extract(a)
        if not self.is_scalar_left_shift_possible(a, shift):
            m = self.message_modulus
            return self.evaluate_univariate(a, lambda x: (x << shift) % m)
        return self.unchecked_scalar_left_shift(a, shift)

    def unchecked_scalar_right_shift(self, a, shift: int):
        out = self.evaluate_univariate(a, lambda x: x >> shift)
        return out.with_(degree=a.degree >> shift)

    smart_scalar_right_shift = unchecked_scalar_right_shift

    def cmux(self, cond: Ciphertext, then_ct: Ciphertext, else_ct: Ciphertext):
        """cond ? then : else, for an encrypted boolean cond (degree 1)."""
        return self.add(self.mul(self.sub(then_ct, else_ct), cond), else_ct)

    # ------------------------------------------------------------------
    # preconditions (reference is_*_possible)
    # ------------------------------------------------------------------

    def _noise_ok(self, noise_level: int) -> bool:
        return noise_level <= self.max_noise_level.value

    def is_add_possible(self, a, b) -> bool:
        return (a.degree + b.degree <= self.max_degree
                and self._noise_ok(a.noise_level + b.noise_level))

    def is_neg_possible(self, a) -> bool:
        return (self._correcting_term(a) - 1 <= self.max_degree
                and self._noise_ok(a.noise_level))

    def is_sub_possible(self, a, b) -> bool:
        return (a.degree + self._correcting_term(b) - 1 <= self.max_degree
                and self._noise_ok(a.noise_level + b.noise_level))

    def is_scalar_add_possible(self, a, scalar: int) -> bool:
        return a.degree + scalar <= self.max_degree and self._noise_ok(a.noise_level)

    def is_scalar_sub_possible(self, a, scalar: int) -> bool:
        return scalar <= a.degree and self._noise_ok(a.noise_level)

    def is_scalar_mul_possible(self, a, scalar: int) -> bool:
        return (a.degree * scalar <= self.max_degree
                and self._noise_ok(a.noise_level * max(scalar, 1)))

    def is_scalar_left_shift_possible(self, a, shift: int) -> bool:
        return (a.degree << shift <= self.max_degree
                and self._noise_ok(a.noise_level * (1 << shift)))

    def is_bivariate_pbs_possible(self, a, b) -> bool:
        """left·m + right must fit the LUT domain, and its noise (a scalar
        multiply and an add) the budget."""
        m = self.message_modulus
        return (b.degree < m and a.degree * m + b.degree <= self.max_degree
                and self._noise_ok(a.noise_level * m + b.noise_level))

    is_mul_possible = is_bivariate_pbs_possible

    def is_mul_small_carry_possible(self, a, b) -> bool:
        return a.degree + b.degree <= self.max_degree and self.is_sub_possible(a, b)

    def _check_bivariate(self, a, b):
        if not self.is_bivariate_pbs_possible(a, b):
            raise CheckError("CarryFull/NoiseTooBig: bivariate PBS precondition failed")

    # ------------------------------------------------------------------
    # trivial encryption on the server (reference create_trivial)
    # ------------------------------------------------------------------

    def _trivial(self, values, space: int, degree: int) -> Ciphertext:
        p = self.params
        msgs = torch.remainder(torch.as_tensor(values, dtype=torch.int64,
                                               device=self.device), space)
        n = (p.big_lwe_dimension if p.encryption_key_choice == EncryptionKeyChoice.BIG
             else p.lwe_dimension)
        return Ciphertext(lwe=trivial_lwe(msgs * self._torus(1), n), degree=degree,
                          message_modulus=self.message_modulus,
                          carry_modulus=self.carry_modulus,
                          noise_level=NoiseLevel.ZERO)

    def create_trivial(self, values) -> Ciphertext:
        """Noiseless encryption of values % msg_mod."""
        m = self.message_modulus
        return self._trivial(values, m, m - 1)

    def unchecked_create_trivial(self, values) -> Ciphertext:
        """Noiseless encryption over the whole message+carry space."""
        space = self.message_modulus * self.carry_modulus
        return self._trivial(values, space, space - 1)

    # ------------------------------------------------------------------
    # execution flags, key sizes and parameter accessors (tfhe_tpu
    # server_key.py:764-806; reference shortint/server_key/mod.rs)
    # ------------------------------------------------------------------

    def deterministic_pbs_execution(self) -> bool:
        """Always True: every kernel's arithmetic is exact and its reduction
        order fixed (the reference toggles a multi-bit thread-pool mode)."""
        return True

    def set_deterministic_pbs_execution(self, det: bool) -> None:
        if not det:
            raise ValueError("a non-deterministic PBS does not exist here")

    def bootstrapping_key_size_elements(self) -> int:
        """Words of the bootstrapping key as the port holds it: its spectra
        (int32 residues, [n, P, J, R, N], or the paired and multi-bit
        forms), not the JAX package's uint64 NTT words."""
        return self.bsk.spectra.numel()

    def bootstrapping_key_size_bytes(self) -> int:
        """Bytes of the key's spectra (4 a word: int32 residues)."""
        return self.bootstrapping_key_size_elements() * self.bsk.spectra.element_size()

    def key_switching_key_size_elements(self) -> int:
        return self.ksk.data.numel()

    def key_switching_key_size_bytes(self) -> int:
        return self.key_switching_key_size_elements() * self.ksk.data.element_size()

    def input_lwe_dimension(self) -> int:
        return self.params.lwe_dimension

    def output_lwe_dimension(self) -> int:
        return self.params.glwe_dimension * self.params.polynomial_size

    def glwe_size(self) -> int:
        return self.params.glwe_dimension + 1

    def polynomial_size(self) -> int:
        return self.params.polynomial_size

    def decomposition_base_log(self) -> int:
        return self.params.pbs_base_log

    def decomposition_level_count(self) -> int:
        return self.params.pbs_level


def gen_server_key(ck: ClientKey, seed: int) -> ServerKey:
    """BSK (small LWE key → GLWE key, classic or multi-bit as the parameters
    say, in the port's spectra) and KSK (big → small), on the client key's
    device."""
    p = ck.params
    device = ck.device
    gen = rng.generator(seed, 3, device=device)
    npr = external_product_num_primes(p.polynomial_size, p.glwe_size, p.pbs_decomp)
    if isinstance(p, MultiBitPBSParameters):
        bsk_std = generate_multi_bit_bootstrap_key(gen, ck.lwe_sk, ck.glwe_sk,
                                                   p.pbs_decomp, p.grouping_factor,
                                                   p.glwe_noise_std)
        bsk = multi_bit_bootstrap_key_to_ntt(bsk_std, npr)
    else:
        bsk_std = generate_bootstrap_key(gen, ck.lwe_sk, ck.glwe_sk, p.pbs_decomp,
                                         p.glwe_noise_std)
        bsk = bootstrap_key_to_ntt(bsk_std, npr)
    del bsk_std
    ksk = generate_keyswitch_key(rng.generator(seed, 4, device=device),
                                 ck.big_sk, ck.lwe_sk, p.ks_decomp, p.lwe_noise_std)
    return ServerKey(ksk=ksk, bsk=bsk, params=p)


@dataclass(frozen=True)
class CompressedServerKey:
    """Seeds and bodies only (reference shortint CompressedServerKey;
    tfhe_tpu server_key.py:834-867): the BSK's GGSW masks and the KSK's
    masks regenerate from the seeds on decompression, (k+1)x and (n+1)x
    smaller on the wire.  The bootstrapping key is classic for every set,
    multi-bit ones too, as the JAX package makes it (tfhe-rs would make a
    multi-bit key there): `ServerKey._pbs` then runs the classic PBS."""

    seeded_bsk: seeded.SeededLweBootstrapKey
    seeded_ksk: seeded.SeededLweKeyswitchKey
    params: object = None

    def decompress(self, device=None) -> ServerKey:
        """The server key on the bodies' device (or `device`): the standard
        BSK regenerated there and converted to the port's spectra, the KSK
        with K2′'s limbs on the card."""
        bsk, ksk = seeded.decompress_server_key(self.seeded_bsk, self.seeded_ksk, device)
        return ServerKey(ksk=ksk, bsk=bsk, params=self.params)


def gen_compressed_server_key(ck: ClientKey, seed: int = 0) -> CompressedServerKey:
    """The compressed twin of gen_server_key on the client key's device:
    BSK masks from seed 2s+1, KSK masks from 2s+2, as tfhe_tpu
    gen_compressed_server_key lays them out; noise from generators of s.
    A classic bootstrapping key on multi-bit parameters too (tfhe_tpu
    server_key.py:852-867)."""
    p = ck.params
    device = ck.device
    _, sbsk = seeded.generate_seeded_bootstrap_key(
        seed * 2 + 1, rng.generator(seed, 5, device=device), ck.lwe_sk, ck.glwe_sk,
        p.pbs_decomp, p.glwe_noise_std)
    _, sksk = seeded.generate_seeded_keyswitch_key(
        seed * 2 + 2, rng.generator(seed, 6, device=device), ck.big_sk, ck.lwe_sk,
        p.ks_decomp, p.lwe_noise_std)
    return CompressedServerKey(seeded_bsk=sbsk, seeded_ksk=sksk, params=p)
