"""Shifts and rotates by an encrypted amount through GGSW selectors.

Counterpart of `tfhe_tpu/integer/shift_key.py` (reference semantics:
integer/server_key/radix_parallel/{shift,rotate}.rs), on the combined
WoP-PBS regime (`shortint/wopbs.py` `new_wopbs_key`):

  1. the amount's block-granular bits are circuit-bootstrapped into GGSWs
     directly: one WoP-PBS-regime PBS per (bit, cbs level) with a raw LUT
     emitting bit * q/B^l, then per level and GGSW row one private
     functional keyswitch;
  2. the radix blocks are packed into one GLWE polynomial by a packing
     keyswitch (compute big LWE → WoP-PBS GLWE key), doubled for rotates
     and followed by sign-fill blocks for the arithmetic shift;
  3. the block-granular shift is log2(width) CMuxes (X^{±2^j} monomials);
  4. one 2-LUT refresh sweep applies the sub-block bit shift and returns
     fresh compute-regime blocks.

At uint32 on 2_2 with cbs (4, 4): 16 CBS PBS + 1 sub-bit PBS + 31 refresh
PBS = 48 PBS, 4 external products and 2 keyswitch passes (tfhe_tpu
shift_key.py:15-17), against ~154-181 PBS on the layered path.  On the
card: two K1 calls (the CBS round and the refresh sweep), the pass and K2′
for their keyswitches, the packing keyswitch and the private functional
keyswitches, one K7 launch a CMux.

The casting keyswitches are one hop at SHIFT_CAST_KS_DECOMP (base 4, 8
levels; the JAX package's measurement: the combined regime's double hop
put 2 wrong values in 2,560 chained rotations on its chip).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from ..core import rng, threefry
from ..core.algorithms.bootstrap import sample_extract
from ..core.algorithms.encryption import (generate_keyswitch_key_from_key,
                                          generate_packing_keyswitch_key)
from ..core.algorithms.keyswitch import _static_monomial_mul, packing_keyswitch_lwe_list_to_glwe
from ..core.algorithms.wopbs import (_monomial_div_static, cmux_ntt, ggsw_to_ntt,
                                     private_functional_keyswitch)
from ..core.entities import GgswCiphertext, GlweCiphertext, LweCiphertext
from ..core.params import DecompParams
from ..shortint.ciphertext import Ciphertext as Block
from ..shortint.ciphertext import NoiseLevel
from ..shortint.client_key import ClientKey
from ..shortint.server_key import ServerKey as ShortintServerKey
from ..shortint.wopbs import CombinedWopbsKey, _wopbs_client_key, new_wopbs_key

SHIFT_CBS_DECOMP = DecompParams(4, 4)
# one-hop casting keyswitches, base 4 x 8 levels (tfhe_tpu shift_key.py:60-66)
SHIFT_CAST_KS_DECOMP = DecompParams(2, 8)


@dataclass(frozen=True)
class ShiftKey:
    """The GGSW shift's keys (tfhe_tpu shift_key.py:69):
      wopbs               the combined-regime WoP-PBS key;
      pksk                the packing keyswitching key, compute big LWE →
                          WoP-PBS GLWE key;
      cbs_server_key      a WoP-PBS-regime shortint key whose KSK casts
                          compute big → WoP-PBS small directly;
      refresh_server_key  a compute-regime shortint key whose KSK casts
                          WoP-PBS big → compute small."""

    wopbs: CombinedWopbsKey
    pksk: Any
    cbs_server_key: Any = None
    refresh_server_key: Any = None
    cbs_decomp: DecompParams = SHIFT_CBS_DECOMP


def new_shift_key(ck: ClientKey, sk: ShortintServerKey, wparams="auto",
                  cbs_decomp: DecompParams = SHIFT_CBS_DECOMP, seed: int = 0) -> ShiftKey:
    """The shift key (tfhe_tpu shift_key.py:94), on the client key's device:
    the combined WoP-PBS key, the block-packing keyswitching key (masks
    under fork(key_from_seed(seed), 0x5F1F)) and the two casting keys
    (under split(fork(key_from_seed(seed), 0x5F20))); masks as the JAX
    package draws them, noise from generators of the seed."""
    dev = ck.device
    wk = new_wopbs_key(ck, sk, wparams, seed=seed)
    wp = wk.params
    wck = _wopbs_client_key(ck, wp, seed)
    root = threefry.key_from_seed(seed, dev)
    pksk = generate_packing_keyswitch_key(threefry.fork(root, 0x5F1F),
                                          rng.generator(seed, 0x5F1F, device=dev), ck.big_sk,
                                          wck.glwe_sk, wp.pfks_decomp, wp.pfks_noise_std)
    k_in, k_out = threefry.split(threefry.fork(root, 0x5F20))
    ksk_in = generate_keyswitch_key_from_key(k_in, rng.generator(seed, 0x5F20, 0, device=dev),
                                             ck.big_sk, wck.lwe_sk, SHIFT_CAST_KS_DECOMP,
                                             wp.lwe_noise_std)
    ksk_out = generate_keyswitch_key_from_key(k_out, rng.generator(seed, 0x5F20, 1, device=dev),
                                              wck.big_sk, ck.lwe_sk, SHIFT_CAST_KS_DECOMP,
                                              ck.params.lwe_noise_std)
    return ShiftKey(wopbs=wk, pksk=pksk,
                    cbs_server_key=ShortintServerKey(ksk=ksk_in,
                                                     bsk=wk.wopbs_key.server_key.bsk,
                                                     params=wp),
                    refresh_server_key=ShortintServerKey(ksk=ksk_out, bsk=sk.bsk,
                                                         params=ck.params),
                    cbs_decomp=cbs_decomp)


def ggsw_shift_supported(shift_key: Optional[ShiftKey], msg_mod: int, num_blocks: int,
                         amount_blocks: int) -> bool:
    """The GGSW path's gate (tfhe_tpu shift_key.py:122): a key, a
    power-of-two number of bits a block, at least one block-granular
    selector bit, and room in the polynomial for the doubled rotate window."""
    if shift_key is None or shift_key.cbs_server_key is None:
        return False
    bp = int(math.log2(msg_mod))
    if bp <= 0 or (bp & (bp - 1)):
        return False
    n_sel = max(1, math.ceil(math.log2(num_blocks * bp)))
    sb = int(math.log2(bp)) if bp > 1 else 0
    if n_sel <= sb:
        return False
    return 3 * num_blocks <= shift_key.wopbs.params.polynomial_size


def _shift_rotate_ggsw(isk, a, amount, kind: str):
    """The GGSW shift (from the integer ServerKey's encrypted-amount shifts,
    tfhe_tpu shift_key.py:140).  isk: the integer ServerKey; a, amount:
    RadixCiphertexts; kind in {shl, shr, rotl, rotr, ashr}."""
    sk: ShiftKey = isk.shift_key
    wk = sk.wopbs
    wsk = wk.wopbs_key.server_key
    m = isk.msg_mod
    carry = isk.key.carry_modulus
    space = m * carry
    bp = int(math.log2(m))
    sb = int(math.log2(bp)) if bp > 1 else 0
    a = isk._maybe_propagate(a)
    amount = isk._maybe_propagate(amount)
    nb = a.num_blocks
    n_sel = max(1, math.ceil(math.log2(nb * bp)))
    cbs = sk.cbs_decomp
    lc = cbs.level

    # 1. the amount blocks the selector bits need (cast inside the CBS PBS)
    wblocks: Dict[int, Block] = {g: amount.blocks[g] for g in
                                 sorted({j // bp for j in range(n_sel)
                                         if j // bp < amount.num_blocks})}

    # 2. one stacked WoP-PBS-regime round: CBS level LWEs, then sub-block bits
    jobs: List[Block] = []
    luts = []
    ggsw_bits: List[int] = []
    for j in range(sb, n_sel):
        g, o = divmod(j, bp)
        if g not in wblocks:
            continue                       # a missing high block: the bit is zero
        ggsw_bits.append(j)
        for lvl in range(1, lc + 1):
            alpha = 1 << (64 - cbs.base_log * lvl)
            jobs.append(wblocks[g])
            luts.append(wsk.generate_lookup_table_raw([((x >> o) & 1) * alpha
                                                       for x in range(space)]))
    n_cbs = len(jobs)
    for t in range(sb):
        g, o = divmod(t, bp)
        if g in wblocks:
            jobs.append(wblocks[g])
            luts.append(wsk.generate_lookup_table(lambda x, o=o: (x >> o) & 1))
    outs = isk._apply_luts_stacked(jobs, luts, sk=sk.cbs_server_key) if jobs else []

    # 3. the GGSWs: one private functional keyswitch per (bit, level, row)
    pf = wk.wopbs_key.pfpksk
    ggsws = []
    for bi in range(len(ggsw_bits)):
        lv = torch.stack([o.lwe.data for o in outs[bi * lc:(bi + 1) * lc]], dim=-2)
        rows = [private_functional_keyswitch(LweCiphertext(data=lv), pf, r).data
                for r in range(pf.data.shape[0])]
        ggsws.append(ggsw_to_ntt(GgswCiphertext(data=torch.stack(rows, dim=-3), decomp=cbs)))
    subs = outs[n_cbs:]

    # 4. the data blocks packed into one GLWE
    rotate = kind in ("rotl", "rotr")
    if rotate:
        blocks_list = a.blocks * 2
    elif kind == "ashr":
        sign = isk._sign_bit(a)                                   # 1 PBS
        sign_fill = isk.key.unchecked_scalar_mul(sign.block, m - 1)
        blocks_list = a.blocks + [sign_fill] * nb
    else:
        blocks_list = a.blocks
    cts = torch.stack([b.lwe.data for b in blocks_list], dim=-2)
    acc = packing_keyswitch_lwe_list_to_glwe(LweCiphertext(data=cts), sk.pksk)

    # 5. the block-granular rotation: one CMux a selector bit
    left = kind in ("shl", "rotl")
    for bi, j in enumerate(ggsw_bits):
        nblk = 1 << (j - sb)
        if left:
            moved = GlweCiphertext(data=_static_monomial_mul(acc.data, nblk))
        else:
            moved = GlweCiphertext(data=_monomial_div_static(acc.data, nblk))
        acc = cmux_ntt(acc, moved, ggsws[bi], cbs)

    # 6. the result window (rotl reads the doubled copy's upper half; ashr
    # one block more, the top block's upper neighbour)
    base = nb if kind == "rotl" else 0
    n_ext = nb + 1 if kind == "ashr" else nb
    vs = [sample_extract(acc, base + i) for i in range(n_ext)]

    # 7. the sub-block bit shift and the refresh through the casting PBS
    def wb(lwe_ct, degree):
        return Block(lwe=lwe_ct, degree=degree, message_modulus=m, carry_modulus=carry,
                     noise_level=NoiseLevel.NOMINAL)

    psk = sk.refresh_server_key
    if sb == 0:
        lut_id = psk.generate_lookup_table(lambda x: x % m)
        blocks = isk._apply_luts_stacked([wb(v, m - 1) for v in vs[:nb]], [lut_id] * nb,
                                         sk=psk)
        return type(a)(blocks=blocks)

    sub_data = subs[0].lwe.data
    for t_i in range(1, sb):
        sub_data = sub_data + subs[t_i].lwe.data * (1 << t_i)

    def pack(v):
        return wb(LweCiphertext(data=v.data * bp + sub_data), (m - 1) * bp + bp - 1)

    if left:
        lut_lo = psk.generate_lookup_table(lambda x: ((x // bp) << (x % bp)) % m)
        lut_hi = psk.generate_lookup_table(
            lambda x: ((x // bp) >> (bp - (x % bp))) if (x % bp) else 0)
    else:
        lut_lo = psk.generate_lookup_table(lambda x: (x // bp) >> (x % bp))
        lut_hi = psk.generate_lookup_table(
            lambda x: (((x // bp) << (bp - (x % bp))) % m) if (x % bp) else 0)

    jobs2, luts2, slots = [], [], []
    for i in range(nb):
        jobs2.append(pack(vs[i]))
        luts2.append(lut_lo)
        slots.append(i)
        ni = i - 1 if left else i + 1     # the neighbour donating the cross bits
        if rotate:
            ni %= nb
        elif kind != "ashr" and (ni < 0 or ni >= nb):
            continue                      # logical shifts fill with zeros
        jobs2.append(pack(vs[ni]))
        luts2.append(lut_hi)
        slots.append(i)
    outs2 = isk._apply_luts_stacked(jobs2, luts2, sk=psk)
    parts: Dict[int, List[Block]] = {}
    for i, o in zip(slots, outs2):
        parts.setdefault(i, []).append(o)
    blocks = []
    for i in range(nb):
        out = parts[i][0]
        for extra in parts[i][1:]:
            # lo and hi occupy disjoint bit ranges: the degree stays below m
            out = isk.key.unchecked_add(out, extra).with_(degree=m - 1)
        blocks.append(out)
    return type(a)(blocks=blocks)


__all__ = ["SHIFT_CBS_DECOMP", "SHIFT_CAST_KS_DECOMP", "ShiftKey", "new_shift_key",
           "ggsw_shift_supported"]
