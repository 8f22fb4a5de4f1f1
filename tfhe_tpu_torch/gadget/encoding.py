"""p-encodings (BPR24): maps of Z_o values to subsets of Z_p.

Counterpart of `tfhe_tpu/gadget/encoding.py`, copied whole: the class is
pure Python (no jax, no torch), so both packages' encodings are equal
value objects with the same methods, and a file written by either package
carries the same encoding (`utils/serialization.py`).  Reference
gadget/ciphertext/mod.rs:24-295: `parts[i]` is the set of Z_p elements that
encode the Z_o value i; odd p avoids the padding bit entirely, so the
accumulator's negacyclicity holds by construction.
"""
from __future__ import annotations

from typing import Callable, Sequence


class Encoding:
    __slots__ = ("origin_modulus", "parts", "modulus_p", "wopbs")

    def __init__(self, origin_modulus: int, parts: Sequence[Sequence[int]],
                 modulus_p: int, wopbs: bool = False, _validate: bool = True):
        self.origin_modulus = int(origin_modulus)
        self.parts = tuple(frozenset(int(x) for x in part) for part in parts)
        self.modulus_p = int(modulus_p)
        self.wopbs = bool(wopbs)
        assert all(x < self.modulus_p for p in self.parts for x in p)
        if _validate and not self.is_valid():
            raise ValueError("This Arithmetic Encoding is not correct!")

    # -- validation (reference is_valid, ciphertext/mod.rs:44-84) -----------

    def is_valid(self) -> bool:
        if self.origin_modulus != len(self.parts):
            return False
        if self.modulus_p % 2 == 1 or self.modulus_p == 2 or self.wopbs:
            return True
        # even p (non-wopbs): negacyclicity — if x encodes i, then x + p/2
        # may only encode [-i]_o
        for i in range(self.origin_modulus):
            neg_i = self.negative_on_o_ring(i)
            for x in self.parts[i]:
                opposite = (x + self.modulus_p // 2) % self.modulus_p
                for j, part in enumerate(self.parts):
                    if j != neg_i and opposite in part:
                        return False
        return True

    # -- accessors ----------------------------------------------------------

    def get_part(self, i: int):
        return self.parts[i]

    def get_modulus(self) -> int:
        return self.modulus_p

    def get_origin_modulus(self) -> int:
        return self.origin_modulus

    def is_partition_containing(self, i: int, value: int) -> bool:
        return value in self.parts[i]

    def inverse_encoding(self, x: int):
        for i in range(self.origin_modulus):
            if x in self.parts[i]:
                return i
        return None

    def is_canonical(self) -> bool:
        return all(len(p) == 1 for p in self.parts)

    def get_part_single_value_if_canonical(self, i: int) -> int:
        assert self.is_canonical()
        return next(iter(self.parts[i]))

    def negative_on_p_ring(self, x: int) -> int:
        return (self.modulus_p - x) % self.modulus_p

    def negative_on_o_ring(self, i: int) -> int:
        return (self.origin_modulus - i) % self.origin_modulus

    # -- constructors -------------------------------------------------------

    @classmethod
    def new_canonical(cls, origin_modulus: int, singleton_values: Sequence[int],
                      modulus_p: int) -> "Encoding":
        return cls(origin_modulus, [[v] for v in singleton_values], modulus_p)

    @classmethod
    def new_canonical_binary(cls, value_for_true: int, modulus_p: int) -> "Encoding":
        return cls.new_canonical(2, [0, value_for_true], modulus_p)

    @classmethod
    def parity_encoding(cls) -> "Encoding":
        return cls.new_canonical_binary(1, 2)

    @classmethod
    def new_trivial(cls, origin_modulus: int) -> "Encoding":
        return cls.new_canonical(origin_modulus, list(range(origin_modulus)),
                                 origin_modulus)

    @classmethod
    def new_trivial_wopbs(cls, modulus: int) -> "Encoding":
        return cls(modulus, [[i] for i in range(modulus)], modulus, wopbs=True)

    @classmethod
    def new_all_one_wopbs(cls, modulus: int) -> "Encoding":
        return cls(modulus, [[1] for _ in range(modulus)], modulus, wopbs=True)

    # -- transforms ---------------------------------------------------------

    def apply_lut_to_encoding(self, f: Callable[[int], int]) -> "Encoding":
        parts = {}
        for i in range(self.origin_modulus):
            parts.setdefault(f(i), set()).update(self.parts[i])
        new_parts = [sorted(parts.get(i, set()))
                     for i in range(self.origin_modulus)]
        return Encoding(self.origin_modulus, new_parts, self.modulus_p,
                        wopbs=self.wopbs, _validate=not self.wopbs)

    def multiply_encoding_by_constant(self, c: int) -> "Encoding":
        return Encoding(self.origin_modulus,
                        [[x * c % self.modulus_p for x in p] for p in self.parts],
                        self.modulus_p)

    def add_constant(self, c: int) -> "Encoding":
        return Encoding(self.origin_modulus,
                        [[(x + c) % self.modulus_p for x in p] for p in self.parts],
                        self.modulus_p)

    # -- plumbing -----------------------------------------------------------

    def __eq__(self, other):
        return (isinstance(other, Encoding)
                and self.origin_modulus == other.origin_modulus
                and self.modulus_p == other.modulus_p
                and self.parts == other.parts)

    def __hash__(self):
        return hash((self.origin_modulus, self.modulus_p, self.parts, self.wopbs))

    def __repr__(self):
        parts = {i: sorted(p) for i, p in enumerate(self.parts)}
        return f"Encoding(o={self.origin_modulus}, p={self.modulus_p}, parts={parts})"
