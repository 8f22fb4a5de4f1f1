"""Radix integer server ops on shortint blocks (counterpart of
`tfhe_tpu/integer/server_key.py`; reference tfhe/src/integer/server_key/,
radix and radix_parallel).

The reference spreads independent block PBS over threads with rayon.  Here,
as in the JAX package, the independent blocks of a layer are stacked onto
the batch axis and go through one keyswitch + PBS call
(`_apply_luts_stacked`), each row with its own LUT: on the card that is one
decomposition pass, one K2′ and one K1 (classic key) or K3 (multi-bit key)
launch per layer, whatever the number of blocks.

Costs (b = num_blocks): `add` ripples its carry through b dependent calls;
`add_parallelized` is a Hillis–Steele carry scan in log2(b) + 3 calls;
`mul` is one call for all 2b² partial products, then carry-save
accumulation; comparisons are log2(b) tree layers.  Encrypted-amount shifts
and rotates take the layered exclusive-selection path, or with a shift key
(`gen_keys(shift_key=...)`) the GGSW-selector path of `shift_key.py`, under
the JAX package's gate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List

import torch

from .. import shortint
from ..core.entities import GlweCiphertext, LweCiphertext
from ..shortint.ciphertext import Ciphertext as Block
from ..shortint.ciphertext import NoiseLevel
from ..shortint.server_key import LookupTable
from .ciphertext import BooleanBlock, CrtCiphertext, RadixCiphertext, SignedRadixCiphertext
from .client_key import RadixClientKey

# comparison fold states
EQ, LT, GT = 0, 1, 2


@dataclass(frozen=True)
class ServerKey:
    key: shortint.ServerKey
    # the GGSW-selector shift key (shift_key.py); None keeps the layered
    # path for encrypted-amount shifts
    shift_key: Any = None

    @property
    def msg_mod(self) -> int:
        return self.key.message_modulus

    @property
    def max_degree(self) -> int:
        return self.key.max_degree

    @property
    def device(self) -> torch.device:
        return self.key.device

    # ------------------------------------------------------------------
    # batched-LUT plumbing: stack blocks into the PBS batch axis
    # ------------------------------------------------------------------

    def _apply_luts_stacked(self, blocks: List[Block], luts: List[LookupTable],
                            sk: shortint.ServerKey = None) -> List[Block]:
        """One KS+PBS call for len(blocks) inputs, each with its own LUT, on
        this key's shortint key or `sk` (the GGSW shift's casting keys)."""
        assert len(blocks) == len(luts)
        sk = self.key if sk is None else sk
        data = torch.stack([b.lwe.data for b in blocks])              # [nb, ..., n+1]
        acc = torch.stack([l.acc.data for l in luts])                 # [nb, k+1, N]
        acc = acc.reshape(acc.shape[:1] + (1,) * (data.ndim - 2) + acc.shape[-2:])
        tmp = Block(lwe=LweCiphertext(data=data),
                    degree=max(b.degree for b in blocks),
                    message_modulus=blocks[0].message_modulus,
                    carry_modulus=blocks[0].carry_modulus,
                    noise_level=max(b.noise_level for b in blocks))
        out = sk.apply_lookup_table(tmp, LookupTable(acc=GlweCiphertext(data=acc)))
        return [blocks[i].with_(lwe=LweCiphertext(data=out.lwe.data[i]),
                                degree=luts[i].degree, noise_level=NoiseLevel.NOMINAL)
                for i in range(len(blocks))]

    def _apply_lut_same(self, blocks: List[Block], lut: LookupTable) -> List[Block]:
        return self._apply_luts_stacked(blocks, [lut] * len(blocks))

    @staticmethod
    def _pack(hi: Block, lo: Block, factor: int) -> Block:
        """hi * factor + lo, degrees and noise levels alike."""
        return hi.with_(lwe=LweCiphertext(data=hi.lwe.data * factor + lo.lwe.data),
                        degree=hi.degree * factor + lo.degree,
                        noise_level=hi.noise_level * factor + lo.noise_level)

    # ------------------------------------------------------------------
    # carry machinery
    # ------------------------------------------------------------------

    def full_propagate(self, ct: RadixCiphertext) -> RadixCiphertext:
        """Sequential carry propagation (reference full_propagate): each step
        extracts one block's (message, carry) in one 2-row call and feeds the
        carry forward."""
        m = self.msg_mod
        lut_msg = self.key.generate_lookup_table(lambda x: x % m)
        lut_carry = self.key.generate_lookup_table(lambda x: x // m)
        out = []
        carry = None
        last = len(ct.blocks) - 1
        for i, b in enumerate(ct.blocks):
            if carry is not None:
                b = self.key.unchecked_add(b, carry)
            if b.degree < m:
                out.append(b)
                carry = None
                continue
            if i == last:  # the top block's carry is discarded: 1 LUT, not 2
                out.append(self._apply_luts_stacked([b], [lut_msg])[0])
                carry = None
                continue
            msg, carry = self._apply_luts_stacked([b, b], [lut_msg, lut_carry])
            carry = carry.with_(degree=min(carry.degree, b.degree // m))
            out.append(msg)
        return type(ct)(blocks=out)

    def full_propagate_parallelized(self, ct: RadixCiphertext) -> RadixCiphertext:
        """Hillis–Steele carry propagation (reference
        radix_parallel/add.rs:541-607): per-block generate/propagate states, a
        log2(b)-deep inclusive scan of combine-LUT layers, then one
        message + carry-in layer.  Needs block values <= 2m - 1 (the sum of
        two clean operands); otherwise it ripples."""
        m = self.msg_mod
        nb = ct.num_blocks
        if nb == 1 or any(b.degree > 2 * m - 1 for b in ct.blocks):
            return self.full_propagate(ct)
        NONE_, GEN, PROP = 0, 1, 2
        lut_state = self.key.generate_lookup_table(
            lambda v: GEN if v >= m else (PROP if v == m - 1 else NONE_))
        states = self._apply_lut_same(ct.blocks, lut_state)

        # inclusive scan with a∘b = a if a != PROP else b
        lut_combine = self.key.generate_lookup_table(
            lambda x: (x // 4) if (x // 4) != PROP else (x % 4))
        dist = 1
        while dist < nb:
            idxs = list(range(dist, nb))
            packed = [self._pack(states[i], states[i - dist], 4) for i in idxs]
            for i, o in zip(idxs, self._apply_lut_same(packed, lut_combine)):
                states[i] = o
            dist *= 2

        # prefix state → carry bit, then message + carry-in, packed as
        # bit * 2m + v <= 2m + 2m - 1 <= max_degree
        lut_bit = self.key.generate_lookup_table(lambda x: 1 if x == GEN else 0)
        bits = self._apply_lut_same(states[:-1], lut_bit)
        lut_resolve = self.key.generate_lookup_table(
            lambda x: ((x % (2 * m)) + (x // (2 * m))) % m)
        packed = [ct.blocks[0]] + [self._pack(bits[i - 1], ct.blocks[i], 2 * m)
                                   for i in range(1, nb)]
        lut_msg0 = self.key.generate_lookup_table(lambda x: x % m)
        outs = self._apply_luts_stacked(packed, [lut_msg0] + [lut_resolve] * (nb - 1))
        return type(ct)(blocks=outs)

    def _maybe_propagate(self, ct: RadixCiphertext) -> RadixCiphertext:
        if ct.block_carries_are_empty():
            return ct
        return self.full_propagate(ct)

    # ------------------------------------------------------------------
    # add / neg / sub
    # ------------------------------------------------------------------

    def unchecked_add(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        return type(a)(blocks=[self.key.unchecked_add(x, y)
                               for x, y in zip(a.blocks, b.blocks)])

    def smart_add(self, a, b):
        if any(x.degree + y.degree > self.max_degree for x, y in zip(a.blocks, b.blocks)):
            a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        return self.unchecked_add(a, b)

    def add(self, a, b):
        return self.full_propagate(self.smart_add(a, b))

    def add_parallelized(self, a, b):
        """Log-depth add: blockwise sum + Hillis–Steele carry scan."""
        a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        return self.full_propagate_parallelized(self.unchecked_add(a, b))

    def unchecked_neg(self, a: RadixCiphertext) -> RadixCiphertext:
        """Blockwise negation with correcting terms: block_i' = w_i*Δ - block_i
        with w_i = z_i - z_{i-1}/m, z_i the least multiple of m above degree_i
        (reference unchecked_neg_with_correcting_term)."""
        m = self.msg_mod
        out = []
        prev_carry = 0
        for blk in a.blocks:
            z = max(-(-(blk.degree + 1) // m) * m, m)
            w = z - prev_carry
            data = -blk.lwe.data
            data[..., -1] += self.key._torus(w)
            out.append(blk.with_(lwe=LweCiphertext(data=data), degree=w))
            prev_carry = z // m
        return type(a)(blocks=out)

    def smart_neg(self, a):
        return self.unchecked_neg(self._maybe_propagate(a))

    def neg(self, a):
        return self.full_propagate(self.smart_neg(a))

    neg_parallelized = neg

    def unchecked_sub(self, a, b):
        return self.unchecked_add(a, self.unchecked_neg(b))

    def smart_sub(self, a, b):
        return self.smart_add(a, self.smart_neg(b))

    def sub(self, a, b):
        return self.full_propagate(self.smart_sub(self._maybe_propagate(a),
                                                  self._maybe_propagate(b)))

    sub_parallelized = sub

    # ------------------------------------------------------------------
    # scalar add/sub/mul
    # ------------------------------------------------------------------

    def _scalar_blocks(self, scalar: int, nb: int) -> List[int]:
        m = self.msg_mod
        scalar %= m ** nb
        return [(scalar // m ** i) % m for i in range(nb)]

    def scalar_add(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        a = self._maybe_propagate(a)
        sb = self._scalar_blocks(scalar, a.num_blocks)
        blocks = [self.key.unchecked_scalar_add(x, s) if s else x
                  for x, s in zip(a.blocks, sb)]
        return self.full_propagate(type(a)(blocks=blocks))

    scalar_add_parallelized = scalar_add

    def scalar_sub(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        return self.scalar_add(a, (-scalar) % (self.msg_mod ** a.num_blocks))

    scalar_sub_parallelized = scalar_sub

    def scalar_mul(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        """Shift-and-add over the scalar's radix digits."""
        nb = a.num_blocks
        scalar %= self.msg_mod ** nb
        if scalar == 0:
            return self.create_trivial_zero_radix(nb, a.batch_shape)
        a = self._maybe_propagate(a)
        partials = []
        for i, s in enumerate(self._scalar_blocks(scalar, nb)):
            if s == 0:
                continue
            shifted = self.blockshift(a, i)
            mul_lut = self.key.generate_lookup_table(lambda x, s=s: x * s)
            inner = self._apply_lut_same(shifted.blocks[i:], mul_lut)
            partials.append(type(a)(blocks=shifted.blocks[:i] + inner))
        return self._sum_partials(partials)

    scalar_mul_parallelized = scalar_mul

    # ------------------------------------------------------------------
    # multiplication
    # ------------------------------------------------------------------

    def _partial_products(self, a_blocks: List[Block], b_blocks: List[Block], nb: int):
        """(lsb and msb rows of every pair (i, j) in one call, their places
        i + j and i + j + 1), for the pairs whose place is below nb."""
        m = self.msg_mod
        lut_lsb = self.key.generate_lookup_table(lambda x: ((x // m) * (x % m)) % m)
        lut_msb = self.key.generate_lookup_table(lambda x: ((x // m) * (x % m)) // m)
        pairs, luts, places = [], [], []
        for j, y in enumerate(b_blocks):
            for i, x in enumerate(a_blocks):
                if i + j < nb:
                    pairs.append(self.key.unchecked_bivariate_pack(x, y))
                    luts.append(lut_lsb)
                    places.append(i + j)
                if i + j + 1 < nb:
                    pairs.append(self.key.unchecked_bivariate_pack(x, y))
                    luts.append(lut_msb)
                    places.append(i + j + 1)
        return self._apply_luts_stacked(pairs, luts), places

    def mul(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        """Schoolbook block multiplication: every lsb/msb partial product in
        ONE call, then carry-save accumulation (the fan-out of reference
        radix_parallel/mul.rs:329 becomes the batch axis).  Emitting each
        pair's full product lsb + m·msb with one PBS (fewer rows) loses in
        the JAX package's measurements: the degree-9 partials fill the carry
        space after ~1.6 additions instead of ~5, and the extra splits cost
        more than the rows saved."""
        a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        nb = a.num_blocks
        outs, places = self._partial_products(a.blocks, b.blocks, nb)
        per_place: List[List[Block]] = [[] for _ in range(nb)]
        for blk, pl in zip(outs, places):
            per_place[pl].append(blk)
        partials = []
        for d in range(max(len(v) for v in per_place)):
            partials.append(type(a)(blocks=[
                per_place[pl][d] if d < len(per_place[pl])
                else self._trivial_zero_block(a.batch_shape) for pl in range(nb)]))
        return self._sum_partials(partials)

    mul_parallelized = mul

    def _trivial_block(self, digit: int, batch_shape) -> Block:
        """A noiseless block of `digit` at degree `digit`, on the key's device."""
        return self.key._trivial(torch.full(tuple(batch_shape), digit, dtype=torch.int64),
                                 self.msg_mod, digit)

    def _trivial_zero_block(self, batch_shape) -> Block:
        return self._trivial_block(0, batch_shape)

    def create_trivial_zero_radix(self, nb: int, batch_shape=()) -> RadixCiphertext:
        return RadixCiphertext(blocks=[self._trivial_zero_block(batch_shape)
                                       for _ in range(nb)])

    def create_trivial_radix(self, value: int, nb: int, batch_shape=()) -> RadixCiphertext:
        m = self.msg_mod
        return RadixCiphertext(blocks=[self._trivial_block((value // m ** i) % m, batch_shape)
                                       for i in range(nb)])

    def _split_msg_carry(self, ct: RadixCiphertext):
        """(message part, carries shifted up one place) of a saturated
        accumulator, both extracted in ONE call.  Blocks with an empty carry
        space skip the PBS (their carry is a trivial zero)."""
        m = self.msg_mod
        nb = ct.num_blocks
        zero = self._trivial_zero_block(ct.batch_shape)
        idxs = [i for i, b in enumerate(ct.blocks) if b.degree >= m]
        msg_blocks = list(ct.blocks)
        car_blocks = [zero] * nb
        if idxs:
            lut_msg = self.key.generate_lookup_table(lambda x: x % m)
            lut_carry = self.key.generate_lookup_table(lambda x: x // m)
            ins = [ct.blocks[i] for i in idxs]
            outs = self._apply_luts_stacked(
                ins + ins, [lut_msg] * len(ins) + [lut_carry] * len(ins))
            for k, i in enumerate(idxs):
                msg_blocks[i] = outs[k]
                c = outs[len(ins) + k]
                # with carry_modulus > m the carry can exceed m - 1: bound it
                # as full_propagate does, by the input's degree
                car_blocks[i] = c.with_(degree=min(c.degree, ct.blocks[i].degree // m))
        carries = type(ct)(blocks=[zero] + car_blocks[:nb - 1])
        return type(ct)(blocks=msg_blocks), carries

    def _sum_partials(self, partials: List[RadixCiphertext]) -> RadixCiphertext:
        """Carry-save accumulation of many radix ciphertexts (reference
        unchecked_sum_ciphertexts_vec_parallelized): when the carry space is
        about to fill, split the accumulator into (message, carries) in one
        call and queue the carries as another partial.  Ends with one split
        and the Hillis–Steele propagation (message + carry degree <= 2m - 2
        always qualifies)."""
        if not partials:
            raise ValueError("empty sum")
        queue = list(partials)
        acc = queue.pop(0)
        while queue:
            p = queue.pop(0)
            if any(x.degree + y.degree > self.max_degree
                   for x, y in zip(acc.blocks, p.blocks)):
                acc, carries = self._split_msg_carry(acc)
                if any(b.degree for b in carries.blocks):
                    queue.append(carries)
            acc = self.unchecked_add(acc, p)
        if acc.block_carries_are_empty():
            return acc
        msg, carries = self._split_msg_carry(acc)
        return self.full_propagate_parallelized(self.unchecked_add(msg, carries))

    def sum_ciphertexts(self, cts: List[RadixCiphertext]) -> RadixCiphertext:
        """Sum many radix ciphertexts (reference
        unchecked_sum_ciphertexts_vec_parallelized)."""
        return self._sum_partials(list(cts))

    sum_ciphertexts_parallelized = sum_ciphertexts

    def blockshift(self, a: RadixCiphertext, shift: int) -> RadixCiphertext:
        """Multiply by msg_mod^shift: blocks move up, trivial zeros below."""
        if shift == 0:
            return a
        zeros = [self._trivial_zero_block(a.batch_shape) for _ in range(shift)]
        return type(a)(blocks=zeros + a.blocks[:a.num_blocks - shift])

    # ------------------------------------------------------------------
    # bitwise
    # ------------------------------------------------------------------

    def _bitwise(self, a, b, op) -> RadixCiphertext:
        a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        m = self.msg_mod
        lut = self.key.generate_lookup_table(lambda x: op(x // m, x % m) % m)
        pairs = [self.key.unchecked_bivariate_pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        return type(a)(blocks=self._apply_lut_same(pairs, lut))

    def bitand(self, a, b):
        return self._bitwise(a, b, lambda x, y: x & y)

    def bitor(self, a, b):
        return self._bitwise(a, b, lambda x, y: x | y)

    def bitxor(self, a, b):
        return self._bitwise(a, b, lambda x, y: x ^ y)

    bitand_parallelized = bitand
    bitor_parallelized = bitor
    bitxor_parallelized = bitxor

    def bitnot(self, a):
        a = self._maybe_propagate(a)
        m = self.msg_mod
        lut = self.key.generate_lookup_table(lambda x: (m - 1) - (x % m))
        return type(a)(blocks=self._apply_lut_same(a.blocks, lut))

    # ------------------------------------------------------------------
    # comparisons (lexicographic fold, reference integer/server_key/comparator.rs)
    # ------------------------------------------------------------------

    def _compare_states(self, a: RadixCiphertext, b: RadixCiphertext) -> List[Block]:
        """Per-block state in {EQ, LT, GT}, one call."""
        m = self.msg_mod

        def st(x, y):
            return EQ if x == y else (LT if x < y else GT)

        lut = self.key.generate_lookup_table(lambda x: st(x // m, x % m))
        pairs = [self.key.unchecked_bivariate_pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        return self._apply_lut_same(pairs, lut)

    def _scalar_compare_states(self, a: RadixCiphertext, scalar: int) -> List[Block]:
        sb = self._scalar_blocks(scalar, a.num_blocks)
        luts = [self.key.generate_lookup_table(
            lambda x, s=s: EQ if x == s else (LT if x < s else GT)) for s in sb]
        return self._apply_luts_stacked(a.blocks, luts)

    def _fold_states(self, states: List[Block]) -> Block:
        """Tree fold, combined = hi if hi != EQ else lo: log2(b) layers; an odd
        leftover (the most significant) passes through, last."""
        combine = self.key.generate_lookup_table(
            lambda x: (x // 4) if (x // 4) != EQ else (x % 4))
        while len(states) > 1:
            pairs = [self._pack(states[i + 1], states[i], 4)
                     for i in range(0, len(states) - 1, 2)]
            passthrough = [states[-1]] if len(states) % 2 else []
            states = self._apply_lut_same(pairs, combine) + passthrough
        return states[0]

    def _state_to_bool(self, state: Block, accept) -> BooleanBlock:
        lut = self.key.generate_lookup_table(lambda x: int(x in accept))
        return BooleanBlock(block=self.key.apply_lookup_table(state, lut))

    def _cmp(self, a, b, accept) -> BooleanBlock:
        a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        return self._state_to_bool(self._fold_states(self._compare_states(a, b)), accept)

    def eq(self, a, b):
        """Per-block equality bits, summed and compared to the block count."""
        a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        m = self.msg_mod
        lut = self.key.generate_lookup_table(lambda x: int((x // m) == (x % m)))
        pairs = [self.key.unchecked_bivariate_pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        return self._all_ones(self._apply_lut_same(pairs, lut))

    def _all_ones(self, bits: List[Block]) -> BooleanBlock:
        chunk = min(self.max_degree, len(bits))
        while len(bits) > 1:
            grouped = []
            for i in range(0, len(bits), chunk):
                group = bits[i:i + chunk]
                s = group[0]
                for g in group[1:]:
                    s = self.key.unchecked_add(s, g)
                k = len(group)
                grouped.append(self.key.evaluate_univariate(s, lambda x, k=k: int(x == k)))
            bits = grouped
        return BooleanBlock(block=bits[0])

    def _not(self, e: BooleanBlock) -> BooleanBlock:
        return BooleanBlock(block=self.key.evaluate_univariate(e.block, lambda x: 1 - (x % 2)))

    def ne(self, a, b):
        return self._not(self.eq(a, b))

    def lt(self, a, b):
        return self._cmp(a, b, accept=(LT,))

    def le(self, a, b):
        return self._cmp(a, b, accept=(LT, EQ))

    def gt(self, a, b):
        return self._cmp(a, b, accept=(GT,))

    def ge(self, a, b):
        return self._cmp(a, b, accept=(GT, EQ))

    eq_parallelized = eq
    ne_parallelized = ne
    lt_parallelized = lt
    le_parallelized = le
    gt_parallelized = gt
    ge_parallelized = ge

    def scalar_eq(self, a, scalar: int):
        a = self._maybe_propagate(a)
        luts = [self.key.generate_lookup_table(lambda x, s=s: int(x == s))
                for s in self._scalar_blocks(scalar, a.num_blocks)]
        return self._all_ones(self._apply_luts_stacked(a.blocks, luts))

    def scalar_ne(self, a, scalar: int):
        return self._not(self.scalar_eq(a, scalar))

    scalar_eq_parallelized = scalar_eq
    scalar_ne_parallelized = scalar_ne

    def _scalar_cmp(self, a, scalar: int, accept):
        a = self._maybe_propagate(a)
        return self._state_to_bool(self._fold_states(self._scalar_compare_states(a, scalar)),
                                   accept)

    def scalar_lt(self, a, s):
        return self._scalar_cmp(a, s, (LT,))

    def scalar_le(self, a, s):
        return self._scalar_cmp(a, s, (LT, EQ))

    def scalar_gt(self, a, s):
        return self._scalar_cmp(a, s, (GT,))

    def scalar_ge(self, a, s):
        return self._scalar_cmp(a, s, (GT, EQ))

    # ------------------------------------------------------------------
    # selection / min / max
    # ------------------------------------------------------------------

    def cmux(self, cond: BooleanBlock, a: RadixCiphertext,
             b: RadixCiphertext) -> RadixCiphertext:
        """cond ? a : b: cond packed with each block of a and of b, both
        selections in one call.  They are exclusive (one of each pair is 0),
        so a block's degree is the max of the two, not the sum, and no
        propagation follows."""
        a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        m = self.msg_mod
        sel_a = [self.key.unchecked_bivariate_pack(cond.block, x) for x in a.blocks]
        sel_b = [self.key.unchecked_bivariate_pack(cond.block, y) for y in b.blocks]
        lut_then = self.key.generate_lookup_table(lambda x: (x % m) if (x // m) == 1 else 0)
        lut_else = self.key.generate_lookup_table(lambda x: (x % m) if (x // m) == 0 else 0)
        outs = self._apply_luts_stacked(sel_a + sel_b,
                                        [lut_then] * len(sel_a) + [lut_else] * len(sel_b))
        nb = a.num_blocks
        return type(a)(blocks=[self.key.unchecked_add(outs[i], outs[nb + i]).with_(
            degree=max(outs[i].degree, outs[nb + i].degree)) for i in range(nb)])

    if_then_else = cmux
    if_then_else_parallelized = cmux

    def min(self, a, b):
        return self.cmux(self.le(a, b), a, b)

    def max(self, a, b):
        return self.cmux(self.ge(a, b), a, b)

    min_parallelized = min
    max_parallelized = max

    # ------------------------------------------------------------------
    # signed comparisons / abs / overflow (reference tests_signed and the
    # radix_parallel overflowing ops)
    # ------------------------------------------------------------------

    def _flip_sign_bit(self, a: RadixCiphertext) -> RadixCiphertext:
        """XOR the two's-complement sign bit (the top bit of the top block):
        maps signed order onto unsigned order."""
        a = self._maybe_propagate(a)
        m = self.msg_mod
        lut = self.key.generate_lookup_table(lambda x: (x % m) ^ (m // 2))
        return type(a)(blocks=a.blocks[:-1] + [self.key.apply_lookup_table(a.blocks[-1], lut)])

    def _signed_cmp(self, fn, a, b):
        return fn(self._flip_sign_bit(a), self._flip_sign_bit(b))

    def lt_signed(self, a, b):
        return self._signed_cmp(self.lt, a, b)

    def le_signed(self, a, b):
        return self._signed_cmp(self.le, a, b)

    def gt_signed(self, a, b):
        return self._signed_cmp(self.gt, a, b)

    def ge_signed(self, a, b):
        return self._signed_cmp(self.ge, a, b)

    def min_signed(self, a, b):
        return self.cmux(self.le_signed(a, b), a, b)

    def max_signed(self, a, b):
        return self.cmux(self.ge_signed(a, b), a, b)

    def abs_signed(self, a: RadixCiphertext) -> RadixCiphertext:
        """|a| in two's complement (reference abs_parallelized)."""
        zero = self.create_trivial_zero_radix(a.num_blocks, a.batch_shape)
        neg = self.neg(a)
        return self.cmux(self.lt_signed(a, zero), neg, a)

    abs_parallelized = abs_signed

    def unsigned_overflowing_add(self, a: RadixCiphertext, b: RadixCiphertext):
        """(sum mod 2^bits, overflow BooleanBlock) (reference
        unsigned_overflowing_add_parallelized)."""
        a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        s = self.unchecked_add(a, b)
        m = self.msg_mod
        lut_msg = self.key.generate_lookup_table(lambda x: x % m)
        lut_carry = self.key.generate_lookup_table(lambda x: x // m)
        out, carry = [], None
        for blk in s.blocks:
            if carry is not None:
                blk = self.key.unchecked_add(blk, carry)
            msg, carry = self._apply_luts_stacked([blk, blk], [lut_msg, lut_carry])
            carry = carry.with_(degree=1)
            out.append(msg)
        return type(a)(blocks=out), BooleanBlock(block=carry)

    def unsigned_overflowing_sub(self, a: RadixCiphertext, b: RadixCiphertext):
        """(a - b mod 2^bits, borrow: 1 where a < b)."""
        return self.sub(a, b), self.lt(a, b)

    # ------------------------------------------------------------------
    # shifts by an encrypted amount (reference radix_parallel shift.rs)
    # ------------------------------------------------------------------

    def _amount_bits(self, amount: RadixCiphertext, n_needed: int):
        """The low n_needed bits of amount as degree-1 blocks (None past its
        blocks), all in one call."""
        bits_pb = int(math.log2(self.msg_mod))
        amount = self._maybe_propagate(amount)
        live, luts = [], []
        for i in range(n_needed):
            blk, bit = divmod(i, bits_pb)
            if blk < amount.num_blocks:
                live.append((i, amount.blocks[blk]))
                luts.append(self.key.generate_lookup_table(lambda x, b=bit: (x >> b) & 1))
        outs = [None] * n_needed
        if live:
            res = self._apply_luts_stacked([b for _, b in live], luts)
            for (i, _), r in zip(live, res):
                outs[i] = r
        return outs

    def _sub_bit_variants(self, a: RadixCiphertext, subs, kind: str):
        """`a` shifted or rotated by `sub` bits (0 < sub < bits per block) for
        every sub in `subs`, in ONE call: the packed (neighbour, current)
        pairs are the same for every sub, only the LUT differs."""
        m = self.msg_mod
        bits = int(math.log2(m))
        nb = a.num_blocks
        zero = self._trivial_zero_block(a.batch_shape)
        left = kind in ("shl", "rotl")
        wrap = kind in ("rotl", "rotr")
        pairs = []
        for i in range(nb):
            if left:
                nbr = a.blocks[(i - 1) % nb] if (wrap or i > 0) else zero
            else:
                nbr = a.blocks[(i + 1) % nb] if (wrap or i + 1 < nb) else zero
            pairs.append(self.key.unchecked_bivariate_pack(nbr, a.blocks[i]))
        luts = []
        for sub in subs:
            if left:
                f = lambda x, s=sub: ((((x % m) << s) | ((x // m) >> (bits - s))) % m)
            else:
                f = lambda x, s=sub: (((x % m) >> s) | (((x // m) << (bits - s)) % m))
            luts.append(self.key.generate_lookup_table(f))
        flat = self._apply_luts_stacked(pairs * len(subs), [l for l in luts for _ in range(nb)])
        return {sub: type(a)(blocks=flat[k * nb:(k + 1) * nb]) for k, sub in enumerate(subs)}

    def _block_reindex(self, a: RadixCiphertext, nblk: int, kind: str):
        """Shift or rotate by `nblk` whole blocks: no PBS."""
        if nblk == 0:
            return a
        nb = a.num_blocks
        zero = self._trivial_zero_block(a.batch_shape)
        if kind == "shl":
            blocks = ([zero] * min(nblk, nb) + a.blocks[:max(nb - nblk, 0)])[:nb]
        elif kind == "shr":
            blocks = (a.blocks[nblk:] + [zero] * min(nblk, nb))[:nb]
        elif kind == "rotl":
            blocks = [a.blocks[(i - nblk) % nb] for i in range(nb)]
        else:  # rotr
            blocks = [a.blocks[(i + nblk) % nb] for i in range(nb)]
        return type(a)(blocks=blocks)

    def _shift_rotate_by_encrypted(self, a: RadixCiphertext, amount: RadixCiphertext,
                                   kind: str) -> RadixCiphertext:
        """Shift or rotate by an encrypted amount by layered exclusive
        selection (a cmux barrel over the amount's bits in the reference,
        integer/server_key/radix_parallel/{shift,rotate}.rs, redesigned for
        batched PBS).

        The amount's radix blocks are the selectors: layer g picks among
        the candidate shifts {s << (g*bp)} by summing one bivariate-packed
        LUT per distinct candidate per block.  Whole-block candidates are
        free reindexings; only layer 0's sub-block bases cost a (single,
        stacked) call.  The selections are exclusive, so the sum's degree
        is the max (no propagation), and the LUT masks the selector block's
        irrelevant bits (no bit extraction).

        Noise: a layer's output sums 2^bp exclusive terms, so the next
        layer's packed input sel*m + cand has norm2^2 = m^2 + 2^bp (20 at
        2_2, against 17 for a fresh pack), noise_level 8 > MaxNoiseLevel 5
        on the tracked linear bound.  The p_fail guarantee rests on the JAX
        package's measured PBS output noise (tests/test_noise_distribution.py)
        and its sampled p_fail runs, not on that bound; parameters with
        tighter margins would need the candidates refreshed first.

        With a shift key the GGSW path runs instead where its gate holds
        (tfhe_tpu server_key.py:814-822): rotates only at a power-of-two
        width, for the doubled copy's window."""
        from .shift_key import _shift_rotate_ggsw, ggsw_shift_supported
        m = self.msg_mod
        bp = int(math.log2(m))
        if ggsw_shift_supported(self.shift_key, m, a.num_blocks, amount.num_blocks):
            total = a.num_blocks * bp
            if kind in ("shl", "shr") or total & (total - 1) == 0:
                return _shift_rotate_ggsw(self, a, amount, kind)
        a = self._maybe_propagate(a)
        amount = self._maybe_propagate(amount)
        nb = a.num_blocks
        n_sel = max(1, int(math.ceil(math.log2(nb * bp))))
        # selector-bit groups: (amount block, bit offset in it, width <= 2, low bit)
        groups = []
        lo_bit = 0
        while lo_bit < n_sel:
            g, o = divmod(lo_bit, bp)
            if g >= amount.num_blocks:
                break               # missing high amount blocks are zero
            w = min(2, bp - o, n_sel - lo_bit)
            groups.append((g, o, w, lo_bit))
            lo_bit += w
        # a later group that needs sub-block bases would pack noisy candidate
        # sums as the LUT's neighbour input; only a bp that is not a power of
        # two (3_3) hits this, and it takes the per-bit barrel
        for idx, (g, o, w, lo) in enumerate(groups):
            shifts = {((s >> o) & ((1 << w) - 1)) << lo for s in range(m)}
            if idx > 0 and any(sh % bp for sh in shifts):
                return self._shift_rotate_barrel(a, amount, kind)
        out = a
        for g, o, w, lo in groups:
            relmask = (1 << w) - 1
            sel = amount.blocks[g]
            cand_shifts = sorted({((s >> o) & relmask) << lo for s in range(m)})
            if cand_shifts == [0]:
                continue
            subs = sorted({sh % bp for sh in cand_shifts} - {0})
            bases = self._sub_bit_variants(out, subs, kind) if subs else {}
            bases[0] = out
            cands = {sh: self._block_reindex(bases[sh % bp], sh // bp, kind)
                     for sh in cand_shifts}
            # one LUT per distinct candidate, every block of every candidate in
            # one call; a trivial-zero candidate block (degree 0) adds
            # [sel = k] * 0 = 0 and needs no PBS
            packed, luts, slots = [], [], []
            for sh in cand_shifts:
                lut = self.key.generate_lookup_table(
                    lambda x, sh=sh, o=o, lo=lo, rm=relmask: (x % m) if (
                        (((x // m) >> o) & rm) << lo) == sh else 0)
                for j in range(nb):
                    blkj = cands[sh].blocks[j]
                    if blkj.degree == 0:
                        continue
                    packed.append(self.key.unchecked_bivariate_pack(sel, blkj))
                    luts.append(lut)
                    slots.append(j)
            outs = self._apply_luts_stacked(packed, luts) if packed else []
            by_block = {}
            for j, t in zip(slots, outs):
                by_block.setdefault(j, []).append(t)
            blocks = []
            for j in range(nb):
                terms = by_block.get(j)
                if not terms:
                    blocks.append(self._trivial_zero_block(a.batch_shape))
                    continue
                acc = terms[0]
                for t in terms[1:]:
                    acc = self.key.unchecked_add(acc, t)
                blocks.append(acc.with_(degree=max(t.degree for t in terms)))
            out = type(a)(blocks=blocks)
        return out

    def _shift_rotate_barrel(self, a, amount, kind: str):
        """Per-bit cmux barrel, for bits per block that are not a power of
        two (where the layered path's later groups would need sub-block
        bases built from noisy candidate sums)."""
        scalar_op = {"shl": self.scalar_left_shift, "shr": self.scalar_right_shift,
                     "rotl": self.scalar_rotate_left, "rotr": self.scalar_rotate_right}[kind]
        total_bits = a.num_blocks * int(math.log2(self.msg_mod))
        bits = self._amount_bits(amount, max(1, int(math.ceil(math.log2(total_bits)))))
        out = self._maybe_propagate(a)
        for i, bit in enumerate(bits):
            if bit is not None:
                out = self.cmux(BooleanBlock(block=bit), scalar_op(out, 1 << i), out)
        return out

    def left_shift(self, a: RadixCiphertext, amount: RadixCiphertext) -> RadixCiphertext:
        return self._shift_rotate_by_encrypted(a, amount, "shl")

    def right_shift(self, a: RadixCiphertext, amount: RadixCiphertext) -> RadixCiphertext:
        return self._shift_rotate_by_encrypted(a, amount, "shr")

    left_shift_parallelized = left_shift
    right_shift_parallelized = right_shift

    # ------------------------------------------------------------------
    # division (restoring long division, reference radix_parallel div_mod)
    # ------------------------------------------------------------------

    def _extract_bits(self, a: RadixCiphertext):
        """Every bit of `a`, LSB first, as degree-1 blocks: one call per bit
        position within a block."""
        a = self._maybe_propagate(a)
        bits_pb = int(math.log2(self.msg_mod))
        out = [self._apply_lut_same(a.blocks, self.key.generate_lookup_table(
            lambda x, b=bit: (x >> b) & 1)) for bit in range(bits_pb)]
        # bit i of the value = out[i % bits_pb][i // bits_pb]
        return [out[i % bits_pb][i // bits_pb] for i in range(a.num_blocks * bits_pb)]

    def _assemble_bits(self, q_bits: List[Block], nb: int) -> RadixCiphertext:
        """Quotient blocks from degree-1 bits (LSB first), carries propagated."""
        bits_pb = int(math.log2(self.msg_mod))
        q_blocks = []
        for blk in range(nb):
            acc = None
            for j in range(bits_pb):
                t = q_bits[blk * bits_pb + j]
                term = self.key.unchecked_scalar_mul(t, 1 << j) if j else t
                acc = term if acc is None else self.key.unchecked_add(acc, term)
            q_blocks.append(acc)
        return self.full_propagate(RadixCiphertext(blocks=q_blocks))

    def div_rem(self, a: RadixCiphertext, b: RadixCiphertext):
        """(quotient, remainder); signed operands go to the sign-corrected
        divider, as the reference's div_rem_parallelized does
        (div_mod.rs:597).  x / 0 gives the reference's all-ones quotient and
        remainder x on both paths (the unrolled path's ge(rem, 0) is always
        true; the scan path restores it with a b == 0 cmux).  Widths of 8
        bits and more take the round loop (`_div_rem_scan`), narrower ones
        the unrolled restoring loop, as in the JAX package."""
        if isinstance(a, SignedRadixCiphertext):
            return self.signed_div_rem(a, b)
        a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        nb = a.num_blocks
        total_bits = nb * int(math.log2(self.msg_mod))
        if total_bits >= 8:
            return self._div_rem_scan(a, b)
        bits = self._extract_bits(a)              # LSB first
        rem = self.create_trivial_zero_radix(nb, a.batch_shape)
        q_bits = [None] * total_bits
        for i in range(total_bits - 1, -1, -1):
            # rem = (rem << 1) | bit_i
            rem = self.scalar_left_shift(rem, 1)
            rem = type(rem)(blocks=[self.key.unchecked_add(rem.blocks[0], bits[i])]
                            + rem.blocks[1:])
            rem = self._maybe_propagate(rem)
            ge = self.ge(rem, b)
            rem = self.cmux(ge, self.sub(rem, b), rem)
            q_bits[i] = ge.block
        return self._assemble_bits(q_bits, nb), rem

    def _div_rem_scan(self, a: RadixCiphertext, b: RadixCiphertext):
        """Restoring long division, one uniform round per bit (the JAX
        package runs the round under `lax.scan`; here it is a loop).  Each
        round relabels its carry as the scan does: the remainder's blocks
        re-enter at degree m - 1 and NOMINAL noise, the bit at degree 1,
        -b's blocks at their degrees with NOMINAL noise.  The round's exit
        degrees are <= those bounds by construction (shift LUT m - 1,
        propagation <= m - 1, cmux the max), so the relabelling is sound,
        and it keeps the LUTs each round runs equal to the JAX package's.

        The trial subtraction's carry out is the >= test: rem + (2^w - b)
        overflows exactly when rem >= b, so one overflowing-add ripple
        replaces the comparison tree and the subtract-propagate."""
        m = self.msg_mod
        carry_mod = self.key.carry_modulus
        nb = a.num_blocks
        bits_pb = int(math.log2(m))
        total_bits = nb * bits_pb
        bits = self._extract_bits(a)              # LSB first, degree 1
        negb = self.neg(b)                        # the same in every round

        def mk_block(data, degree):
            return Block(lwe=LweCiphertext(data=data), degree=degree, message_modulus=m,
                         carry_modulus=carry_mod, noise_level=NoiseLevel.NOMINAL)

        negb_ct = RadixCiphertext(blocks=[mk_block(bl.lwe.data, bl.degree)
                                          for bl in negb.blocks])
        lut_b0 = self.key.generate_lookup_table(lambda x: x % m)
        lut_bi = self.key.generate_lookup_table(
            lambda x: (((x // m) << 1) | ((x % m) >> (bits_pb - 1))) % m)

        rem_data = [torch.zeros_like(a.blocks[0].lwe.data) for _ in range(nb)]
        ge_bits = [None] * total_bits
        for i in reversed(range(total_bits)):
            rem = [mk_block(d, m - 1) for d in rem_data]
            bit = mk_block(bits[i].lwe.data, 1)
            # rem' = (rem << 1) | bit, one bivariate LUT per block
            packed = [self.key.unchecked_bivariate_pack_with_factor(rem[0], bit, 2)]
            packed += [self.key.unchecked_bivariate_pack(rem[j], rem[j - 1])
                       for j in range(1, nb)]
            srad = RadixCiphertext(blocks=self._apply_luts_stacked(
                packed, [lut_b0] + [lut_bi] * (nb - 1)))
            trial, ge = self.unsigned_overflowing_add(srad, negb_ct)
            new_rem = self.cmux(ge, trial, srad)
            rem_data = [bl.lwe.data for bl in new_rem.blocks]
            ge_bits[i] = mk_block(ge.block.lwe.data, 1)

        quotient = self._assemble_bits(ge_bits, nb)
        # x / 0: the carry-out trick reads false for b = 0 (rem + neg(0) never
        # overflows), which would give quotient 0; one b == 0 test and a cmux
        # restore the reference's all-ones quotient (the remainder is a)
        b_is_zero = self.scalar_eq(b, 0)
        all_ones = self.create_trivial_radix((1 << total_bits) - 1, nb, a.batch_shape)
        quotient = self.cmux(b_is_zero, all_ones, quotient)
        return quotient, RadixCiphertext(blocks=[mk_block(d, m - 1) for d in rem_data])

    def div(self, a, b):
        return self.div_rem(a, b)[0]

    def rem(self, a, b):
        return self.div_rem(a, b)[1]

    div_parallelized = div
    rem_parallelized = rem
    div_rem_parallelized = div_rem

    # ------------------------------------------------------------------
    # signed encrypted division
    # ------------------------------------------------------------------

    def _pack2_bool(self, x: Block, y: Block, f) -> Block:
        """LUT over two degree-1 blocks packed as 2x + y (needs
        max_degree >= 3, true for every parameter set with carries)."""
        lut = self.key.generate_lookup_table(lambda v: int(f((v >> 1) & 1, v & 1)))
        return self.key.apply_lookup_table(self._pack(x, y, 2), lut)

    def signed_div_rem(self, a: SignedRadixCiphertext, b: SignedRadixCiphertext):
        """Truncating division of two signed values: |a| / |b| through the
        unsigned divider, then the signs: the quotient is negated where the
        operand signs differ, the remainder takes the numerator's sign
        (reference signed_unchecked_div_rem_parallelized,
        integer/server_key/radix_parallel/div_mod.rs:494-560)."""
        a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        sa, sb = self._sign_bit(a), self._sign_bit(b)
        abs_a = RadixCiphertext(blocks=self.cmux(sa, self.neg(a), a).blocks)
        abs_b = RadixCiphertext(blocks=self.cmux(sb, self.neg(b), b).blocks)
        q_u, r_u = self.div_rem(abs_a, abs_b)
        differ = BooleanBlock(block=self._pack2_bool(sa.block, sb.block, lambda x, y: x != y))
        q = self.cmux(differ, self.neg(q_u), q_u)
        r = self.cmux(sa, self.neg(r_u), r_u)
        return SignedRadixCiphertext(blocks=q.blocks), SignedRadixCiphertext(blocks=r.blocks)

    def signed_div(self, a, b):
        return self.signed_div_rem(a, b)[0]

    def signed_rem(self, a, b):
        return self.signed_div_rem(a, b)[1]

    def signed_div_rem_floor(self, a: SignedRadixCiphertext, b: SignedRadixCiphertext):
        """Floor division: q_f = q_t - 1 and r_f = r_t + b exactly where the
        truncating remainder is non-zero and the operand signs differ
        (reference unchecked_div_rem_floor_parallelized,
        integer/server_key/radix_parallel/div_mod.rs)."""
        a, b = self._maybe_propagate(a), self._maybe_propagate(b)
        q, r = self.signed_div_rem(a, b)
        sa, sb = self._sign_bit(a), self._sign_bit(b)
        differ = self._pack2_bool(sa.block, sb.block, lambda x, y: x != y)
        zero = self.create_trivial_zero_radix(r.num_blocks, r.batch_shape)
        nonzero = self.ne(RadixCiphertext(blocks=r.blocks), zero)
        adjust = BooleanBlock(block=self._pack2_bool(
            differ, nonzero.block, lambda x, y: bool(x) and bool(y)))
        return (self.cmux(adjust, self.scalar_sub(q, 1), q),
                self.cmux(adjust, self.add(r, b), r))

    div_rem_floor = signed_div_rem_floor
    unchecked_div_rem_floor_parallelized = signed_div_rem_floor

    # ------------------------------------------------------------------
    # shifts and rotations by a clear amount (reference
    # radix_parallel/{shift,rotate}.rs)
    # ------------------------------------------------------------------

    def _bit_shift_blocks(self, a: RadixCiphertext, neighbours: List[Block], sub: int,
                          left: bool) -> RadixCiphertext:
        """Every block moved by `sub` bits (0 < sub < bits per block), its
        neighbour's bits shifted in: one bivariate LUT per block, one call."""
        m = self.msg_mod
        bits = int(math.log2(m))
        if left:
            f = lambda x: (((x % m) << sub) | ((x // m) >> (bits - sub))) % m
        else:
            f = lambda x: (((x % m) >> sub) | (((x // m) << (bits - sub)) % m))
        pairs = [self.key.unchecked_bivariate_pack(nbr, blk)
                 for nbr, blk in zip(neighbours, a.blocks)]
        return type(a)(blocks=self._apply_lut_same(pairs, self.key.generate_lookup_table(f)))

    def scalar_left_shift(self, a: RadixCiphertext, shift: int) -> RadixCiphertext:
        a = self._maybe_propagate(a)
        blk, sub = divmod(shift, int(math.log2(self.msg_mod)))
        a = self.blockshift(a, blk)
        if sub == 0:
            return a
        zero = self._trivial_zero_block(a.batch_shape)
        return self._bit_shift_blocks(a, [zero] + a.blocks[:-1], sub, left=True)

    scalar_left_shift_parallelized = scalar_left_shift

    def scalar_right_shift(self, a: RadixCiphertext, shift: int) -> RadixCiphertext:
        a = self._maybe_propagate(a)
        blk, sub = divmod(shift, int(math.log2(self.msg_mod)))
        nb = a.num_blocks
        zero = self._trivial_zero_block(a.batch_shape)
        a = type(a)(blocks=(a.blocks[blk:] + [zero] * min(blk, nb))[:nb])
        if sub == 0:
            return a
        return self._bit_shift_blocks(a, a.blocks[1:] + [zero], sub, left=False)

    scalar_right_shift_parallelized = scalar_right_shift

    def scalar_rotate_left(self, a: RadixCiphertext, r: int) -> RadixCiphertext:
        a = self._maybe_propagate(a)
        bits = int(math.log2(self.msg_mod))
        nb = a.num_blocks
        r %= nb * bits
        if r == 0:
            return a
        blk, sub = divmod(r, bits)
        a = type(a)(blocks=[a.blocks[(i - blk) % nb] for i in range(nb)])
        if sub == 0:
            return a
        return self._bit_shift_blocks(a, a.blocks[-1:] + a.blocks[:-1], sub, left=True)

    scalar_rotate_left_parallelized = scalar_rotate_left

    def scalar_rotate_right(self, a: RadixCiphertext, r: int) -> RadixCiphertext:
        a = self._maybe_propagate(a)
        bits = int(math.log2(self.msg_mod))
        nb = a.num_blocks
        r %= nb * bits
        if r == 0:
            return a
        blk, sub = divmod(r, bits)
        a = type(a)(blocks=[a.blocks[(i + blk) % nb] for i in range(nb)])
        if sub == 0:
            return a
        return self._bit_shift_blocks(a, a.blocks[1:] + a.blocks[:1], sub, left=False)

    scalar_rotate_right_parallelized = scalar_rotate_right

    def rotate_left(self, a: RadixCiphertext, amount: RadixCiphertext) -> RadixCiphertext:
        """Rotation by an encrypted amount, taken mod 2^ceil(log2(bits))
        (mod the width whenever it is a power of two, as for every FheUint)."""
        return self._shift_rotate_by_encrypted(a, amount, "rotl")

    def rotate_right(self, a: RadixCiphertext, amount: RadixCiphertext) -> RadixCiphertext:
        return self._shift_rotate_by_encrypted(a, amount, "rotr")

    rotate_left_parallelized = rotate_left
    rotate_right_parallelized = rotate_right

    # ------------------------------------------------------------------
    # width casts (reference cast_to_unsigned, extend/trim)
    # ------------------------------------------------------------------

    def cast_to_size(self, a: RadixCiphertext, nb: int) -> RadixCiphertext:
        a = self._maybe_propagate(a)
        if nb <= a.num_blocks:
            return type(a)(blocks=a.blocks[:nb])
        zero = self._trivial_zero_block(a.batch_shape)
        return type(a)(blocks=a.blocks + [zero] * (nb - a.num_blocks))

    # ------------------------------------------------------------------
    # scalar bitwise (reference radix_parallel/scalar_bitwise_op.rs): one
    # call with the scalar's radix digits in the LUTs
    # ------------------------------------------------------------------

    def _scalar_bitwise(self, a: RadixCiphertext, scalar: int, op) -> RadixCiphertext:
        a = self._maybe_propagate(a)
        m = self.msg_mod
        luts = [self.key.generate_lookup_table(lambda x, s=s: op(x % m, s) % m)
                for s in self._scalar_blocks(scalar, a.num_blocks)]
        return type(a)(blocks=self._apply_luts_stacked(a.blocks, luts))

    def scalar_bitand(self, a, scalar: int):
        return self._scalar_bitwise(a, scalar, lambda x, s: x & s)

    def scalar_bitor(self, a, scalar: int):
        return self._scalar_bitwise(a, scalar, lambda x, s: x | s)

    def scalar_bitxor(self, a, scalar: int):
        return self._scalar_bitwise(a, scalar, lambda x, s: x ^ s)

    scalar_bitand_parallelized = scalar_bitand
    scalar_bitor_parallelized = scalar_bitor
    scalar_bitxor_parallelized = scalar_bitxor

    # ------------------------------------------------------------------
    # scalar min/max, small-scalar and single-block multiplies
    # ------------------------------------------------------------------

    def scalar_min(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        triv = self.create_trivial_radix(scalar, a.num_blocks, a.batch_shape)
        return self.cmux(self.scalar_le(a, scalar), a, triv)

    def scalar_max(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        triv = self.create_trivial_radix(scalar, a.num_blocks, a.batch_shape)
        return self.cmux(self.scalar_ge(a, scalar), a, triv)

    scalar_min_parallelized = scalar_min
    scalar_max_parallelized = scalar_max

    def small_scalar_mul(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        """scalar < msg_mod: one linear blockwise multiply and a propagation
        (reference small_scalar_mul_parallelized)."""
        if not 0 <= scalar < self.msg_mod:
            raise ValueError("small_scalar_mul needs 0 <= scalar < msg_mod")
        if scalar == 0:
            return self.create_trivial_zero_radix(a.num_blocks, a.batch_shape)
        a = self._maybe_propagate(a)
        return self.full_propagate(type(a)(blocks=[self.key.unchecked_scalar_mul(b, scalar)
                                                   for b in a.blocks]))

    small_scalar_mul_parallelized = small_scalar_mul

    def block_mul(self, a: RadixCiphertext, b: Block, index: int = 0) -> RadixCiphertext:
        """a times one shortint block placed at `index` (reference
        block_mul_parallelized): every lsb/msb partial product in one call."""
        a = self._maybe_propagate(a)
        if b.degree >= self.msg_mod:
            b = self.key.message_extract(b)
        nb = a.num_blocks
        outs, places = self._partial_products(a.blocks, [b], nb - index)
        lo = [self._trivial_zero_block(a.batch_shape) for _ in range(nb)]
        hi = [self._trivial_zero_block(a.batch_shape) for _ in range(nb)]
        for blk, pl in zip(outs, places):
            pl += index
            tgt = lo if lo[pl].degree == 0 else hi
            tgt[pl] = blk if tgt[pl].degree == 0 else self.key.unchecked_add(tgt[pl], blk)
        return self._sum_partials([type(a)(blocks=lo), type(a)(blocks=hi)])

    block_mul_parallelized = block_mul

    # ------------------------------------------------------------------
    # scalar division (reference radix_parallel/scalar_div_mod.rs):
    # Granlund–Montgomery round-up multiply-high, exact for every input
    # ------------------------------------------------------------------

    def scalar_div_rem(self, a: RadixCiphertext, divisor: int):
        q = self.scalar_div(a, divisor)
        return q, self.sub(a, self.scalar_mul(q, divisor))

    def scalar_div(self, a: RadixCiphertext, divisor: int) -> RadixCiphertext:
        if divisor <= 0:
            raise ValueError("scalar_div needs a positive divisor")
        nb = a.num_blocks
        bits = int(math.log2(self.msg_mod))
        w = nb * bits
        if divisor == 1:
            return self._maybe_propagate(a)
        if divisor >= 1 << w:
            return self.create_trivial_zero_radix(nb, a.batch_shape)
        if divisor & (divisor - 1) == 0:
            return self.scalar_right_shift(a, divisor.bit_length() - 1)
        # m·d in (2^(w+sh), 2^(w+sh) + 2^sh] ⇒ floor(m·x / 2^(w+sh)) = x // d
        sh = (divisor - 1).bit_length()
        mul = (1 << (w + sh)) // divisor + 1
        # x·m < 2^(w + bits(m)): a radix wide enough for the whole product
        wide = self.cast_to_size(a, nb + -(-mul.bit_length() // bits))
        return self.cast_to_size(self.scalar_right_shift(self.scalar_mul(wide, mul), w + sh),
                                 nb)

    def scalar_rem(self, a: RadixCiphertext, divisor: int) -> RadixCiphertext:
        return self.scalar_div_rem(a, divisor)[1]

    scalar_div_parallelized = scalar_div
    scalar_rem_parallelized = scalar_rem
    scalar_div_rem_parallelized = scalar_div_rem

    # ------------------------------------------------------------------
    # signed scalar comparisons and division (reference signed_scalar_*):
    # two's complement onto unsigned order by an offset of 2^(w-1)
    # ------------------------------------------------------------------

    def _scalar_cmp_signed(self, a, scalar: int, accept):
        w = a.num_blocks * int(math.log2(self.msg_mod))
        return self._scalar_cmp(self._flip_sign_bit(a),
                                (scalar + (1 << (w - 1))) % (1 << w), accept)

    def scalar_lt_signed(self, a, s):
        return self._scalar_cmp_signed(a, s, (LT,))

    def scalar_le_signed(self, a, s):
        return self._scalar_cmp_signed(a, s, (LT, EQ))

    def scalar_gt_signed(self, a, s):
        return self._scalar_cmp_signed(a, s, (GT,))

    def scalar_ge_signed(self, a, s):
        return self._scalar_cmp_signed(a, s, (GT, EQ))

    def _sign_bit(self, a: RadixCiphertext) -> BooleanBlock:
        a = self._maybe_propagate(a)
        bits = int(math.log2(self.msg_mod))
        lut = self.key.generate_lookup_table(lambda x: (x >> (bits - 1)) & 1)
        return BooleanBlock(block=self.key.apply_lookup_table(a.blocks[-1], lut))

    def signed_scalar_div_rem(self, a: RadixCiphertext, divisor: int):
        """Truncating division of a signed radix by a clear divisor
        (reference signed_scalar_div_rem_parallelized)."""
        if divisor == 0:
            raise ZeroDivisionError("signed_scalar_div by zero")
        neg_in = self._sign_bit(a)
        abs_a = self.cmux(neg_in, self.neg(a), a)
        q_u = self.scalar_div(abs_a, abs(divisor))
        r_u = self.sub(abs_a, self.scalar_mul(q_u, abs(divisor)))
        if divisor < 0:
            q = self.cmux(neg_in, q_u, self.neg(q_u))
        else:
            q = self.cmux(neg_in, self.neg(q_u), q_u)
        r = self.cmux(neg_in, self.neg(r_u), r_u)
        return type(a)(blocks=q.blocks), type(a)(blocks=r.blocks)

    def signed_scalar_div(self, a, divisor: int):
        return self.signed_scalar_div_rem(a, divisor)[0]

    def signed_scalar_rem(self, a, divisor: int):
        return self.signed_scalar_div_rem(a, divisor)[1]

    signed_scalar_div_parallelized = signed_scalar_div
    signed_scalar_rem_parallelized = signed_scalar_rem
    signed_scalar_div_rem_parallelized = signed_scalar_div_rem

    # ------------------------------------------------------------------
    # arithmetic right shift (reference
    # unchecked_scalar_right_shift_arithmetic_parallelized): the logical
    # shift, then the sign-extension mask OR-ed in under a cmux on the sign
    # ------------------------------------------------------------------

    def scalar_right_shift_arithmetic(self, a: RadixCiphertext, shift: int) -> RadixCiphertext:
        w = a.num_blocks * int(math.log2(self.msg_mod))
        shift = min(shift, w - 1)
        if shift == 0:
            return self._maybe_propagate(a)
        sign = self._sign_bit(a)
        logical = self.scalar_right_shift(a, shift)
        mask = ((1 << w) - 1) ^ ((1 << (w - shift)) - 1)
        return self.cmux(sign, self.scalar_bitor(logical, mask), logical)

    scalar_right_shift_arithmetic_parallelized = scalar_right_shift_arithmetic

    def right_shift_arithmetic(self, a: RadixCiphertext,
                               amount: RadixCiphertext) -> RadixCiphertext:
        """Sign-extending shift by an encrypted amount: a cmux ladder over
        the amount's bits with arithmetic rungs, or the GGSW path with nb
        sign-fill blocks packed behind the data, at a power-of-two width
        only (tfhe_tpu server_key.py:1466-1475: elsewhere the selector
        reaches past the sign fill)."""
        from .shift_key import _shift_rotate_ggsw, ggsw_shift_supported
        total_bits = a.num_blocks * int(math.log2(self.msg_mod))
        if total_bits & (total_bits - 1) == 0 and ggsw_shift_supported(
                self.shift_key, self.msg_mod, a.num_blocks, amount.num_blocks):
            return _shift_rotate_ggsw(self, a, amount, "ashr")
        bits = self._amount_bits(amount, max(1, int(math.ceil(math.log2(total_bits)))))
        out = self._maybe_propagate(a)
        for i, bit in enumerate(bits):
            if bit is not None:
                out = self.cmux(BooleanBlock(block=bit),
                                self.scalar_right_shift_arithmetic(out, 1 << i), out)
        return out

    right_shift_arithmetic_parallelized = right_shift_arithmetic

    # ------------------------------------------------------------------
    # overflowing variants (reference unsigned/signed_overflowing_* and the
    # scalar twins)
    # ------------------------------------------------------------------

    def unsigned_overflowing_scalar_add(self, a: RadixCiphertext, scalar: int):
        triv = self.create_trivial_radix(scalar, a.num_blocks, a.batch_shape)
        return self.unsigned_overflowing_add(a, triv)

    def unsigned_overflowing_scalar_sub(self, a: RadixCiphertext, scalar: int):
        borrow = self.scalar_lt(a, scalar)
        return self.scalar_sub(a, scalar), borrow

    def _pack3_bool(self, x: Block, y: Block, z: Block, f) -> Block:
        """LUT over three degree-1 blocks packed as 4x + 2y + z (needs
        max_degree >= 7, true for every set with carry >= 2)."""
        lut = self.key.generate_lookup_table(
            lambda v: int(f((v >> 2) & 1, (v >> 1) & 1, v & 1)))
        return self.key.apply_lookup_table(self._pack(self._pack(x, y, 2), z, 2), lut)

    def signed_overflowing_add(self, a: RadixCiphertext, b: RadixCiphertext):
        """(sum mod 2^w, overflow): overflow where the operands share a sign
        the result does not (reference signed_overflowing_add_parallelized)."""
        sa, sb = self._sign_bit(a), self._sign_bit(b)
        s = self.add_parallelized(a, b)
        sr = self._sign_bit(s)
        ov = self._pack3_bool(sa.block, sb.block, sr.block, lambda x, y, z: x == y and x != z)
        return s, BooleanBlock(block=ov)

    def signed_overflowing_sub(self, a: RadixCiphertext, b: RadixCiphertext):
        sa, sb = self._sign_bit(a), self._sign_bit(b)
        d = self.sub(a, b)
        sr = self._sign_bit(d)
        ov = self._pack3_bool(sa.block, sb.block, sr.block, lambda x, y, z: x != y and x != z)
        return d, BooleanBlock(block=ov)

    def signed_overflowing_scalar_add(self, a: RadixCiphertext, scalar: int):
        w = a.num_blocks * int(math.log2(self.msg_mod))
        triv = self.create_trivial_radix(scalar % (1 << w), a.num_blocks, a.batch_shape)
        return self.signed_overflowing_add(a, triv)

    def signed_overflowing_scalar_sub(self, a: RadixCiphertext, scalar: int):
        w = a.num_blocks * int(math.log2(self.msg_mod))
        triv = self.create_trivial_radix(scalar % (1 << w), a.num_blocks, a.batch_shape)
        return self.signed_overflowing_sub(a, triv)

    # ------------------------------------------------------------------
    # CRT ops (reference integer/server_key/crt_parallel/); each residue op
    # bootstraps every block, so the smart and unchecked twins are the same
    # ------------------------------------------------------------------

    def _crt_map(self, a: CrtCiphertext, f) -> CrtCiphertext:
        """Residue i ↦ f(v, m_i), one PBS a block."""
        return CrtCiphertext(blocks=[self.key.evaluate_univariate(x, lambda v, mi=mi: f(v, mi))
                                     for x, mi in zip(a.blocks, a.moduli)], moduli=a.moduli)

    def crt_add(self, a: CrtCiphertext, b: CrtCiphertext) -> CrtCiphertext:
        return self._crt_map(CrtCiphertext(blocks=[self.key.unchecked_add(x, y) for x, y
                                                   in zip(a.blocks, b.blocks)],
                                           moduli=a.moduli), lambda v, mi: v % mi)

    def crt_mul(self, a: CrtCiphertext, b: CrtCiphertext) -> CrtCiphertext:
        """Residue-wise product.  The two residues are packed as x * m + y,
        so every modulus must be <= msg_mod: a residue y = m would carry
        into x's digit and the product would be wrong (the JAX package
        computes it all the same); this raises instead."""
        m = self.msg_mod
        if max(a.moduli) > m:
            raise ValueError(f"crt_mul packs residues as x * {m} + y: every modulus must be "
                             f"<= the message modulus {m}, not {tuple(a.moduli)}")
        blocks = []
        for x, y, mi in zip(a.blocks, b.blocks, a.moduli):
            # each residue below msg_mod before packing
            xr = self.key.evaluate_univariate(x, lambda v, mi=mi: v % mi)
            yr = self.key.evaluate_univariate(y, lambda v, mi=mi: v % mi)
            blocks.append(self.key.apply_lookup_table(
                self.key.unchecked_bivariate_pack(xr, yr), self.key.generate_lookup_table(
                    lambda v, mi=mi: ((v // m) * (v % m)) % mi)))
        return CrtCiphertext(blocks=blocks, moduli=a.moduli)

    def crt_neg(self, a: CrtCiphertext) -> CrtCiphertext:
        return self._crt_map(a, lambda v, mi: (-v) % mi)

    def crt_scalar_add(self, a: CrtCiphertext, scalar: int) -> CrtCiphertext:
        return self._crt_map(a, lambda v, mi: (v + scalar) % mi)

    def crt_sub(self, a: CrtCiphertext, b: CrtCiphertext) -> CrtCiphertext:
        """Per-residue subtraction: the add of the residue-wise negation."""
        return self.crt_add(a, self.crt_neg(b))

    def crt_scalar_sub(self, a: CrtCiphertext, scalar: int) -> CrtCiphertext:
        return self.crt_scalar_add(a, -scalar)

    def crt_scalar_mul(self, a: CrtCiphertext, scalar: int) -> CrtCiphertext:
        return self._crt_map(a, lambda v, mi: (v * scalar) % mi)

    def pbs_crt_compliant_function(self, a: CrtCiphertext,
                                   f: Callable[[int], int]) -> CrtCiphertext:
        """x ↦ f(x) residue-wise: valid where f commutes with the CRT
        projection, e.g. polynomials (reference
        pbs_crt_compliant_function_parallelized)."""
        return self._crt_map(a, lambda v, mi: f(v) % mi)

    def full_extract_message(self, a: CrtCiphertext) -> CrtCiphertext:
        """Every residue block reduced below its modulus (reference
        full_extract_message_assign_parallelized)."""
        return self._crt_map(a, lambda v, mi: v % mi)

    unchecked_crt_add = smart_crt_add = crt_add
    unchecked_crt_sub = smart_crt_sub = crt_sub
    unchecked_crt_mul = smart_crt_mul = crt_mul
    unchecked_crt_neg = smart_crt_neg = crt_neg
    unchecked_crt_scalar_add = smart_crt_scalar_add = crt_scalar_add
    unchecked_crt_scalar_sub = smart_crt_scalar_sub = crt_scalar_sub
    unchecked_crt_scalar_mul = smart_crt_scalar_mul = crt_scalar_mul


def gen_keys(params="PARAM_MESSAGE_2_CARRY_2_KS_PBS", num_blocks: int = 4, seed: int = 0,
             shift_key=None, device="cuda"):
    """→ (RadixClientKey, ServerKey) (reference integer::gen_keys_radix), on
    the card unless given device="cpu"; without a card that raises.
    shift_key: None (layered shifts), or a WoP-PBS parameter set, its name
    or "auto" to build the GGSW-selector shift key too (shift_key.py)."""
    ck, sk = shortint.gen_keys(params, seed=seed, device=device)
    shk = None
    if shift_key is not None:
        from .shift_key import new_shift_key
        shk = new_shift_key(ck, sk, shift_key, seed=seed)
    return RadixClientKey(key=ck, num_blocks=num_blocks), ServerKey(key=sk, shift_key=shk)
