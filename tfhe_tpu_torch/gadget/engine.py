"""Gadget engine: odd-p encryption, accumulators, gadget execution, MVB,
tree bootstrapping, encoding switching, LWE multiplication and WoP-PBS.

Counterpart of `tfhe_tpu/gadget/engine.py` (reference gadget/engine/mod.rs,
gadget/engine/bootstrapping.rs, gadget/server_key/mod.rs,
gadget/gadget/mod.rs), on the port's kernels:

* every PBS (`apply_bootstrapping_pattern`, the tree's last bootstrap) is
  `programmable_bootstrap`: K1 on the card, the fused delta form the JAX
  package's fused kernel computes; the tree's accumulator is a per-row
  GLWE with a nonzero mask (`pack_into_new_accumulator`);
* MVB's common factor is `blind_rotate_only`, the rotate-subtract form of
  the JAX package's XLA `blind_rotate` (engine.py:371): K7, one launch a
  step.  The two rotation forms differ in low bits (ROADMAP C4), so each
  function keeps the JAX function's;
* the keyswitches and the packing keyswitches are `keyswitch.contract`:
  the decomposition pass and K2′ on the card for every named gadget set
  (KS base_log 2 to 5).  A call's packing keyswitches run as one batch
  (rows are independent, so the words are the JAX package's);
* the polynomial products (MVB's v_i, the packing windows, `glwe_mult`) are
  `negacyclic_polymul`, plain torch ops, with the JAX package's bounds.

Torus words are int64 bit patterns: Δ = floor(2^64 / p) is 2^63 at p = 2
(`as_i64` before it meets a tensor), the accumulator words Δ * accu[k]
wrap mod 2^64, and every right shift is logical (`numeric.shr`).
Accumulators and the MVB difference polynomials are built on the host, as
the JAX package builds them, and carried to the key's device.

Keys come from the port's torch generators (and threefry for the packing
key's masks): a port key does not equal the JAX package's of the same
seed; `interop.gadget_keys` carries the JAX package's arrays across.  Every
entry point runs on the card unless given device="cpu" (or a key on the
CPU); without a card that raises.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..core import rng, threefry
from ..core.algorithms import (blind_rotate_only, bootstrap_key_to_ntt, decrypt_lwe,
                               encrypt_lwe, external_product_num_primes,
                               generate_bootstrap_key, generate_glwe_secret_key,
                               generate_keyswitch_key, generate_lwe_secret_key,
                               keyswitch_lwe, packing_keyswitch_lwe_to_glwe,
                               programmable_bootstrap, sample_extract, trivial_glwe,
                               trivial_lwe)
from ..core.algorithms.encryption import generate_packing_keyswitch_key
from ..core.algorithms.glwe_mult import generate_relinearization_key, glwe_mult
from ..core.entities import (GlweCiphertext, GlweRelinearizationKey, GlweSecretKey,
                             LweCiphertext, LweKeyswitchKey, LwePackingKeyswitchKey,
                             LweSecretKey, NttBootstrapKey)
from ..core.numeric import as_i64, from_numpy_u64, shr
from ..core.params import EncryptionKeyChoice, GadgetParameters, PBSOrder, gadget_params
from ..core.poly import negacyclic_polymul
from ..cuda_lib import resolve_device
from .encoding import Encoding

_MOD = 1 << 64


def delta_for_modulus(p: int) -> int:
    """Δ = floor(2^64 / p): odd p has no power-of-two structure (reference
    encode_message_into_plaintext, gadget/engine/mod.rs:126-134).  A Python
    int: at p = 2 it is 2^63, beyond int64 (`as_i64` gives its bits)."""
    return _MOD // p


@dataclass(frozen=True)
class ClientKey:
    lwe_sk: LweSecretKey
    glwe_sk: GlweSecretKey
    params: GadgetParameters

    @property
    def device(self) -> torch.device:
        return self.lwe_sk.bits.device

    @property
    def encryption_key(self) -> LweSecretKey:
        if self.params.encryption_key_choice == EncryptionKeyChoice.BIG:
            return self.glwe_sk.as_lwe_secret_key()
        return self.lwe_sk


@dataclass(frozen=True)
class ServerKey:
    """BSK (the port's spectra) + KSK + packing KSK + relinearization key
    (reference gadget ServerKey, engine/bootstrapping.rs:253-259)."""

    bsk: NttBootstrapKey
    ksk: LweKeyswitchKey
    pksk: LwePackingKeyswitchKey
    rlk: GlweRelinearizationKey
    params: GadgetParameters

    @property
    def device(self) -> torch.device:
        return self.ksk.data.device

    def accumulator(self, enc_in: Encoding, enc_out: Encoding) -> GlweCiphertext:
        """The PBS accumulator from enc_in to enc_out (`build_accumulator_glwe`),
        made once a key on its device: building it copies host words to the
        card, which waits for the work queued before it."""
        cache = self.__dict__.setdefault("_accumulators", {})
        if (enc_in, enc_out) not in cache:
            cache[enc_in, enc_out] = build_accumulator_glwe(self.params, enc_in, enc_out,
                                                            self.device)
        return cache[enc_in, enc_out]


@dataclass(frozen=True)
class Ciphertext:
    """An LWE batch and its encoding (reference gadget Ciphertext,
    gadget/ciphertext/mod.rs:14-18)."""

    lwe: LweCiphertext
    encoding: Encoding

    @property
    def device(self) -> torch.device:
        return self.lwe.data.device


def gen_keys(params: GadgetParameters | str = "DEFAULT_PARAMETERS", seed: int = 0,
             device="cuda"):
    """→ (ClientKey, ServerKey) on `device` (reference gadget::gen_keys,
    gadget/mod.rs:109-118, with the packing KSK and the relinearization key
    of Bootstrapper::new_server_key, engine/bootstrapping.rs:306-383)."""
    if isinstance(params, str):
        params = gadget_params(params)
    device = resolve_device(device)

    def gen(i):
        return rng.generator(seed, 0x6A0, i, device=device)

    lwe_sk = generate_lwe_secret_key(gen(1), params.lwe_dimension)
    glwe_sk = generate_glwe_secret_key(gen(2), params.glwe_dimension, params.polynomial_size)
    ck = ClientKey(lwe_sk=lwe_sk, glwe_sk=glwe_sk, params=params)
    bsk_std = generate_bootstrap_key(gen(3), lwe_sk, glwe_sk, params.pbs_decomp,
                                     params.glwe_noise_std)
    npr = external_product_num_primes(params.polynomial_size, params.glwe_size,
                                      params.pbs_decomp)
    bsk = bootstrap_key_to_ntt(bsk_std, npr)
    del bsk_std
    big_sk = glwe_sk.as_lwe_secret_key()
    ksk = generate_keyswitch_key(gen(4), big_sk, lwe_sk, params.ks_decomp,
                                 params.lwe_noise_std)
    pksk = generate_packing_keyswitch_key(
        threefry.fork(threefry.key_from_seed(seed, device), 0x6A0, 5), gen(5), big_sk,
        glwe_sk, params.ks_decomp, params.glwe_noise_std)
    rlk = generate_relinearization_key(gen(6), glwe_sk, params.pbs_decomp,
                                       params.glwe_noise_std)
    return ck, ServerKey(bsk=bsk, ksk=ksk, pksk=pksk, rlk=rlk, params=params)


# ---------------------------------------------------------------------------
# encryption
# ---------------------------------------------------------------------------


def _plaintexts(messages, encoding: Encoding, device) -> torch.Tensor:
    """Z_o messages → Δ_p * (their canonical Z_p value), int64 words."""
    table = [as_i64(encoding.get_part_single_value_if_canonical(i)
                    * delta_for_modulus(encoding.modulus_p))
             for i in range(encoding.origin_modulus)]
    msgs = torch.as_tensor(messages, device=device).to(torch.int64)
    return torch.tensor(table, dtype=torch.int64, device=device)[msgs]


def encrypt_arithmetic(ck: ClientKey, messages, encoding: Encoding,
                       seed: int = 0) -> Ciphertext:
    """Encrypt Z_o messages [...] under a canonical encoding, on the key's
    device, with the parameters' fresh noise for the encryption key."""
    pts = _plaintexts(messages, encoding, ck.device)
    std = (ck.params.glwe_noise_std
           if ck.params.encryption_key_choice == EncryptionKeyChoice.BIG
           else ck.params.lwe_noise_std)
    ct = encrypt_lwe(rng.generator(seed, 0x6A, device=ck.device), ck.encryption_key, pts, std)
    return Ciphertext(lwe=ct, encoding=encoding)


def encrypt_boolean(ck: ClientKey, messages, encoding: Encoding, seed: int = 0) -> Ciphertext:
    return encrypt_arithmetic(ck, torch.as_tensor(messages).to(torch.int64), encoding, seed)


def decrypt(ck: ClientKey, ct: Ciphertext) -> torch.Tensor:
    """Round the phase to the nearest Z_p slot, then invert the encoding
    (reference decrypt_arithmetic, gadget/engine/mod.rs:165-192): int64 Z_o
    values on the key's device; a slot no part holds raises."""
    phase = decrypt_lwe(ct.lwe, ck.encryption_key)
    p = ct.encoding.modulus_p
    zp = _round_torus_to_zp(phase, p)
    inv = torch.full((p,), -1, dtype=torch.int64)
    for i in range(ct.encoding.origin_modulus):
        for x in ct.encoding.parts[i]:
            inv[x] = i
    out = inv.to(zp.device)[zp]
    bad = out < 0
    if bool(bad.any()):
        raise ValueError(f"No value in Zo found for Zp elems {zp[bad].cpu().numpy()}")
    return out


def _round_torus_to_zp(phase: torch.Tensor, p: int) -> torch.Tensor:
    """round(phase * p / 2^64) mod p exactly: floor((phase*p + 2^63) / 2^64)
    from the 32-bit halves of the unsigned phase.  The shifts are logical,
    so the quotient is below 2^32 and non-negative before its `% p`."""
    hi = shr(phase, 32)
    lo = phase & 0xFFFFFFFF
    total_mid = hi * p + shr(lo * p, 32) + (1 << 31)
    return torch.remainder(shr(total_mid, 32), p)


def trivial_encrypt(params: GadgetParameters, messages, encoding: Encoding,
                    device="cuda") -> Ciphertext:
    pts = _plaintexts(messages, encoding, resolve_device(device))
    n = (params.big_lwe_dimension if params.encryption_key_choice == EncryptionKeyChoice.BIG
         else params.lwe_dimension)
    return Ciphertext(lwe=trivial_lwe(pts, n), encoding=encoding)


# ---------------------------------------------------------------------------
# odd-p accumulator (reference engine/bootstrapping.rs:41-209)
# ---------------------------------------------------------------------------


def create_accumulator_data(enc_in: Encoding, enc_out: Encoding) -> np.ndarray:
    """accu[k] for k in Z_p: even slots take enc_in value k/2, odd slots the
    negated value of (p+1)/2 + (k-1)/2 (negacyclic mirror)."""
    assert enc_in.is_valid() and enc_out.is_canonical()
    p = enc_in.modulus_p
    assert p % 2 == 1
    accu = np.zeros(p, dtype=np.uint64)
    for k in range(p):
        if k % 2 == 0:
            i = enc_in.inverse_encoding(k // 2)
            accu[k] = 0 if i is None else enc_out.get_part_single_value_if_canonical(i)
        else:
            i = enc_in.inverse_encoding((p + 1) // 2 + (k - 1) // 2)
            accu[k] = (0 if i is None else
                       enc_out.negative_on_p_ring(
                           enc_out.get_part_single_value_if_canonical(i)))
    return accu


def create_accumulator_data_wopbs(enc_in: Encoding, enc_out: Encoding) -> np.ndarray:
    p = enc_in.modulus_p
    assert p % 2 == 0 and p != 2
    accu = np.zeros(p, dtype=np.uint64)
    for k in range(p):
        i = enc_in.inverse_encoding(k)
        accu[k] = 0 if i is None else enc_out.get_part_single_value_if_canonical(i)
    return accu


def build_accumulator_glwe(params: GadgetParameters, enc_in: Encoding, enc_out: Encoding,
                           device) -> GlweCiphertext:
    """Half-window accumulator filling (reference as_buffers,
    engine/bootstrapping.rs:150-209), each word Δ * value mod 2^64."""
    n_poly = params.polynomial_size
    p, new_p = enc_in.modulus_p, enc_out.modulus_p
    dlt = delta_for_modulus(new_p)
    body = np.zeros(n_poly, dtype=np.uint64)

    def word(v) -> np.uint64:
        return np.uint64(dlt * int(v) % _MOD)

    if p != 2:
        accu = (create_accumulator_data(enc_in, enc_out) if p % 2 == 1
                else create_accumulator_data_wopbs(enc_in, enc_out))
        const_shift = n_poly // (2 * p)
        body[:const_shift] = word(accu[0])
        for k in range(1, p):
            body[const_shift + (k - 1) * n_poly // p:
                 const_shift + k * n_poly // p] = word(accu[k])
        body[n_poly - const_shift:] = word((new_p - int(accu[0])) % new_p)
    else:
        new_false = enc_out.get_part_single_value_if_canonical(0)
        new_true = enc_out.get_part_single_value_if_canonical(1)
        assert new_false == (new_p - new_true) % new_p, \
            "p=2 output encoding must be negacyclic"
        if enc_in.is_partition_containing(1, 0):
            v0, v1 = new_true, new_false
        else:
            v0, v1 = new_false, new_true
        body[:n_poly // 2] = word(v0)
        body[n_poly // 2:] = word(v1)
    return trivial_glwe(from_numpy_u64(body, device), params.glwe_dimension)


def build_common_factor_accumulator(params: GadgetParameters, enc_out: Encoding,
                                    device) -> GlweCiphertext:
    """All-ones accumulator for the MVB common-factor rotation (reference
    as_buffers_common_factor, engine/bootstrapping.rs:214-230)."""
    p = enc_out.modulus_p
    val = ((1 << 63) if p % 2 == 0 else _MOD) // p
    body = torch.full((params.polynomial_size,), as_i64(val), dtype=torch.int64,
                      device=device)
    return trivial_glwe(body, params.glwe_dimension)


# ---------------------------------------------------------------------------
# bootstrap patterns
# ---------------------------------------------------------------------------


def apply_bootstrapping_pattern(sk: ServerKey, lwe: LweCiphertext, enc_inter: Encoding,
                                enc_out: Encoding) -> LweCiphertext:
    """One keyswitch and one PBS in the parameters' order (on the card: the
    pass, K2′ and K1)."""
    acc = sk.accumulator(enc_inter, enc_out)
    if sk.params.pbs_order == PBSOrder.KEYSWITCH_BOOTSTRAP:
        return programmable_bootstrap(keyswitch_lwe(lwe, sk.ksk), acc, sk.bsk)
    return keyswitch_lwe(programmable_bootstrap(lwe, acc, sk.bsk), sk.ksk)


def exec_gadget_with_extraction(sk: ServerKey, enc_inter: Encoding, enc_out: Encoding,
                                inputs: Sequence[Ciphertext]) -> Ciphertext:
    """Σ inputs + one PBS (reference exec_gadget_with_extraction,
    gadget/engine/mod.rs:263)."""
    total = inputs[0].lwe.data
    for c in inputs[1:]:
        total = total + c.lwe.data
    out = apply_bootstrapping_pattern(sk, LweCiphertext(data=total), enc_inter, enc_out)
    return Ciphertext(lwe=out, encoding=enc_out)


def apply_lut(sk: ServerKey, ct: Ciphertext, enc_out: Encoding,
              f: Callable[[int], int]) -> Ciphertext:
    """(reference apply_lut, gadget/engine/mod.rs:304)."""
    enc_inter = ct.encoding.apply_lut_to_encoding(f)
    out = apply_bootstrapping_pattern(sk, ct.lwe, enc_inter, enc_out)
    return Ciphertext(lwe=out, encoding=enc_out)


# ---------------------------------------------------------------------------
# encoding switching (linear; reference engine/mod.rs:517-672)
# ---------------------------------------------------------------------------


def _add_to_body(data: torch.Tensor, value: int) -> torch.Tensor:
    out = data.clone()
    out[..., -1] += as_i64(value)
    return out


def encoding_switching_mul_constant(ct: Ciphertext, coefficient: int) -> Ciphertext:
    return Ciphertext(lwe=LweCiphertext(data=ct.lwe.data * as_i64(coefficient)),
                      encoding=ct.encoding.multiply_encoding_by_constant(coefficient))


def encoding_switching_sum_constant(ct: Ciphertext, constant: int) -> Ciphertext:
    p = ct.encoding.modulus_p
    return Ciphertext(lwe=LweCiphertext(data=_add_to_body(ct.lwe.data, (_MOD // p) * constant)),
                      encoding=ct.encoding.add_constant(constant))


def simple_sum(cts: Sequence[Ciphertext]) -> Ciphertext:
    total = cts[0].lwe.data
    for c in cts[1:]:
        total = total + c.lwe.data
    return Ciphertext(lwe=LweCiphertext(data=total), encoding=cts[0].encoding)


def simple_plaintext_sum(ct: Ciphertext, constant: int, modulus: int) -> Ciphertext:
    return Ciphertext(lwe=LweCiphertext(data=_add_to_body(ct.lwe.data,
                                                          (_MOD // modulus) * constant)),
                      encoding=ct.encoding)


def simple_mul_constant(ct: Ciphertext, coeff: int, modulus: int) -> Ciphertext:
    """Cleartext multiply without touching the encoding (reference
    simple_mul_constant, gadget/engine/mod.rs:610-640)."""
    return Ciphertext(lwe=LweCiphertext(data=ct.lwe.data * (coeff % modulus)),
                      encoding=ct.encoding)


def linear_combination(cts: Sequence[Ciphertext], coefficients: Sequence[int],
                       modulus: int) -> Ciphertext:
    """Σ coeff_i · ct_i over a shared encoding (reference linear_combination,
    gadget/server_key/mod.rs:128-135)."""
    return simple_sum([simple_mul_constant(c, k, modulus)
                       for c, k in zip(cts, coefficients)])


# ---------------------------------------------------------------------------
# multi-value bootstrap (reference mvb_bootstrap, engine/bootstrapping.rs:567-620)
# ---------------------------------------------------------------------------


def _create_vi_for_mvb(params: GadgetParameters, enc_inter: Encoding,
                       enc_out: Encoding) -> np.ndarray:
    """Sparse difference polynomial v_i (reference create_vi_for_mvb,
    engine/bootstrapping.rs:503-545)."""
    accu = create_accumulator_data(enc_inter, enc_out).astype(np.int64)
    n_poly = params.polynomial_size
    p, new_p = enc_inter.modulus_p, enc_out.modulus_p
    if new_p % 2 == 1:
        accu = accu * ((new_p + 1) // 2) % new_p
    elif new_p == 2:
        new_p = 4
    v = np.zeros(n_poly, dtype=np.int64)
    for i in range(p - 1):
        v[n_poly // (2 * p) + i * n_poly // p] = (accu[i + 1] - accu[i]) % new_p
    v[n_poly // (2 * p) + (p - 1) * n_poly // p] = (new_p - accu[0] - accu[p - 1]) % new_p
    return v


def bootstrap_common_factor(sk: ServerKey, lwe_small: LweCiphertext,
                            enc_out: Encoding) -> GlweCiphertext:
    """The all-ones accumulator rotated by the phase of lwe_small:
    `blind_rotate_only` (K7 a step on the card), the JAX package's XLA
    rotate-subtract form (engine.py:371), not the PBS's K1."""
    acc = build_common_factor_accumulator(sk.params, enc_out, sk.device)
    return blind_rotate_only(lwe_small, acc, sk.bsk)


def mvb_bootstrap_with_common_factor(sk: ServerKey, v0: GlweCiphertext, enc_in: Encoding,
                                     encs_out: Sequence[Encoding],
                                     lut_fis: Sequence[Sequence[int]]) -> List[LweCiphertext]:
    outs = []
    for enc_out, lut in zip(encs_out, lut_fis):
        enc_inter = enc_in.apply_lut_to_encoding(lambda x: lut[x])
        vi = _create_vi_for_mvb(sk.params, enc_inter, enc_out)
        prod = negacyclic_polymul(
            v0.data, torch.from_numpy(vi).to(v0.data.device),
            log_bound=64 + np.log2(sk.params.polynomial_size)
            + np.log2(max(int(np.abs(vi).max()), 1) + 1) + 1)
        outs.append(sample_extract(GlweCiphertext(data=prod), 0))
    return outs


def mvb(sk: ServerKey, ct: Ciphertext, encs_out: Sequence[Encoding],
        lut_fis: Sequence[Sequence[int]]) -> List[Ciphertext]:
    """m LUT outputs for one blind rotation (reference mvb,
    gadget/engine/mod.rs:326-374)."""
    if sk.params.pbs_order == PBSOrder.KEYSWITCH_BOOTSTRAP:
        v0 = bootstrap_common_factor(sk, keyswitch_lwe(ct.lwe, sk.ksk), encs_out[0])
        lwes = mvb_bootstrap_with_common_factor(sk, v0, ct.encoding, encs_out, lut_fis)
        return [Ciphertext(lwe=l, encoding=e) for l, e in zip(lwes, encs_out)]
    v0 = bootstrap_common_factor(sk, ct.lwe, encs_out[0])
    lwes = mvb_bootstrap_with_common_factor(sk, v0, ct.encoding, encs_out, lut_fis)
    return [Ciphertext(lwe=keyswitch_lwe(l, sk.ksk), encoding=e)
            for l, e in zip(lwes, encs_out)]


# ---------------------------------------------------------------------------
# tree bootstrapping (reference simple_tree_bootstrapping, engine/mod.rs:415-514
# and pack_into_new_accumulator, engine/bootstrapping.rs:690-773)
# ---------------------------------------------------------------------------


def pack_into_new_accumulator(sk: ServerKey, lwes: List[LweCiphertext], p: int) -> GlweCiphertext:
    """Pack MVB outputs into a fresh accumulator GLWE: each ciphertext is
    packing-keyswitched and smeared over its half-window by a negacyclic
    product with the window's indicator polynomial.  The p packing
    keyswitches run as one call (one pass and one K2′ on the card), and the
    p + 1 window products as one batched product."""
    assert p % 2 == 1, "odd output modulus required (reference assert)"
    n_poly = sk.params.polynomial_size
    size_slice = n_poly // p
    nb = len(lwes)
    zero = torch.zeros_like(lwes[0].data)
    ordered = []                       # the odd/even reordering (reference :700-720)
    for k in range(p):
        if k % 2 == 0:
            ordered.append(lwes[k // 2].data if k // 2 < nb else zero)
        else:
            idx = (p + 1) // 2 + (k - 1) // 2
            ordered.append(-lwes[idx].data if idx < nb else zero)
    glwes = packing_keyswitch_lwe_to_glwe(LweCiphertext(data=torch.stack(ordered)),
                                          sk.pksk).data              # [p, ..., k+1, N]
    windows = np.zeros((p + 1, n_poly), dtype=np.int64)
    windows[0, :size_slice // 2] = 1
    for k in range(1, p):
        off = size_slice // 2 + (k - 1) * size_slice
        windows[k, off:off + size_slice] = 1
    windows[p, n_poly - size_slice // 2:] = 1      # -ordered[0] over N - slice/2 .. N
    w = torch.from_numpy(windows).to(glwes.device)
    w = w.reshape((p + 1,) + (1,) * (glwes.dim() - 2) + (n_poly,))
    contrib = negacyclic_polymul(torch.cat([glwes, glwes[:1]]), w,
                                 log_bound=64 + np.log2(n_poly) + 1)
    return GlweCiphertext(data=contrib[:p].sum(dim=0) - contrib[p])


def compute_common_factor(sk: ServerKey, ct: Ciphertext, enc_out: Encoding) -> GlweCiphertext:
    """KS then the all-ones blind rotation whose result seeds every MVB
    output (reference compute_common_factor, gadget/engine/mod.rs:397-413)."""
    return bootstrap_common_factor(sk, keyswitch_lwe(ct.lwe, sk.ksk), enc_out)


def simple_tree_bootstrapping(sk: ServerKey, inputs: Sequence[Ciphertext], enc_out: Encoding,
                              t: int, lut_fi: Sequence[int],
                              common_factor: GlweCiphertext = None) -> Ciphertext:
    """Depth-2 tree bootstrap: MVB on inputs[1] over t/o_0 sub-LUTs, pack the
    outputs into a new accumulator, bootstrap inputs[0] against it (on the
    card: K1 on a per-row accumulator with a nonzero mask; reference
    simple_tree_bootstrapping, gadget/engine/mod.rs:415-514)."""
    c0 = inputs[1]
    o0 = c0.encoding.origin_modulus
    assert sk.params.pbs_order == PBSOrder.KEYSWITCH_BOOTSTRAP
    first_functions = [[lut_fi[x + j * o0] for x in range(o0)] for j in range(t // o0)]
    v0 = compute_common_factor(sk, c0, enc_out) if common_factor is None else common_factor
    firsts = mvb_bootstrap_with_common_factor(sk, v0, c0.encoding, [enc_out] * (t // o0),
                                              first_functions)
    next_acc = pack_into_new_accumulator(sk, firsts, c0.encoding.modulus_p)
    small1 = keyswitch_lwe(inputs[0].lwe, sk.ksk)
    return Ciphertext(lwe=programmable_bootstrap(small1, next_acc, sk.bsk), encoding=enc_out)


def full_tree_bootstrapping(sk: ServerKey, inputs: Sequence[Ciphertext],
                            encodings_out: Sequence[Encoding], t: int,
                            f: Callable[[int], int]) -> List[Ciphertext]:
    """x ↦ f(x) over the product of the inputs' origin moduli, returned as
    its two base-o digits [high, low]; one common factor feeds both depth-2
    trees (reference full_tree_bootstrapping, gadget/server_key/mod.rs:53-95)."""
    origin_mods = [c.encoding.origin_modulus for c in inputs]
    prod = 1
    for o in origin_mods:
        prod *= o
    assert prod == t, "inputs' origin moduli must multiply to t"
    o = origin_mods[0]
    lut_f0 = [f(x) % o for x in range(t)]
    lut_f1 = [(f(x) - f(x) % o) // o for x in range(t)]
    common = compute_common_factor(sk, inputs[1], encodings_out[0])
    r0 = simple_tree_bootstrapping(sk, inputs, encodings_out[0], t, lut_f0,
                                   common_factor=common)
    r1 = simple_tree_bootstrapping(sk, inputs, encodings_out[1], t, lut_f1,
                                   common_factor=common)
    return [r1, r0]


def encoding_switching_lut(sk: ServerKey, ct: Ciphertext, enc_out: Encoding) -> Ciphertext:
    """Identity LUT into a different encoding (reference
    encoding_switching_lut, gadget/server_key/mod.rs:97-99)."""
    return apply_lut(sk, ct, enc_out, lambda x: x)


# ---------------------------------------------------------------------------
# LWE multiplication via GLWE tensor product (reference lwe_mult,
# gadget/engine/mod.rs:680-750) and WoP-PBS (woppbs_lut, :755-802)
# ---------------------------------------------------------------------------


def lwe_mult(sk: ServerKey, lhs: Ciphertext, rhs: Ciphertext,
             output_encoding: Encoding) -> Ciphertext:
    """Both operands packing-keyswitched in one call, then `glwe_mult` with
    the relinearization key and coefficient 0 extracted."""
    assert lhs.encoding.modulus_p == rhs.encoding.modulus_p
    log_p = int(np.log2(lhs.encoding.modulus_p))
    pair = torch.stack(torch.broadcast_tensors(lhs.lwe.data, rhs.lwe.data))
    glwes = packing_keyswitch_lwe_to_glwe(LweCiphertext(data=pair), sk.pksk).data
    prod = glwe_mult(GlweCiphertext(data=glwes[0]), GlweCiphertext(data=glwes[1]), sk.rlk,
                     log_p)
    return Ciphertext(lwe=sample_extract(prod, 0), encoding=output_encoding)


def woppbs_lut(sk: ServerKey, ct: Ciphertext, enc_out: Encoding,
               f: Callable[[int], int]) -> Ciphertext:
    """WoP-PBS via multiplication: PBS(f) × PBS(all-ones) (reference
    woppbs_lut, gadget/engine/mod.rs:755-802)."""
    enc_inter = ct.encoding.apply_lut_to_encoding(f)
    ct_f = apply_bootstrapping_pattern(sk, ct.lwe, enc_inter, enc_out)
    enc_ones = Encoding.new_all_one_wopbs(ct.encoding.origin_modulus)
    ct_ones = apply_bootstrapping_pattern(sk, ct.lwe, ct.encoding, enc_ones)
    return lwe_mult(sk, Ciphertext(lwe=ct_f, encoding=enc_out),
                    Ciphertext(lwe=ct_ones, encoding=enc_ones), enc_out)


# ---------------------------------------------------------------------------
# Gadget: truth table + encodings (reference gadget/gadget/mod.rs:6-147)
# ---------------------------------------------------------------------------


class Gadget:
    """A Boolean function evaluated as Σ inputs + one PBS."""

    def __init__(self, enc_in: List[Encoding], enc_inter: Encoding, enc_out: Encoding,
                 truth_table: Callable[..., int]):
        self.enc_in = list(enc_in)
        self.enc_inter = enc_inter
        self.enc_out = enc_out
        self.truth_table = truth_table

    @classmethod
    def new_canonical(cls, fn: Callable[..., int], arity: int, values_in: List[int],
                      value_out: int, p_in: int, p_out: int) -> "Gadget":
        """Input i contributes values_in[i] when true; the sum's encoding is
        derived from the truth table (the §3.4 pattern)."""
        enc_in = [Encoding.new_canonical_binary(v, p_in) for v in values_in]
        parts = {0: set(), 1: set()}
        for bits in itertools.product([0, 1], repeat=arity):
            s = sum(v for b, v in zip(bits, values_in) if b) % p_in
            parts[int(fn(*bits))].add(s)
        if parts[0] & parts[1]:
            raise ValueError("truth table is not computable with these p-encodings"
                             f": overlapping sums {parts[0] & parts[1]}")
        enc_inter = Encoding(2, [sorted(parts[0]), sorted(parts[1])], p_in)
        enc_out = Encoding.new_canonical_binary(value_out, p_out)
        return cls(enc_in, enc_inter, enc_out, fn)

    def exec(self, sk: ServerKey, inputs: Sequence[Ciphertext]) -> Ciphertext:
        for ct, enc in zip(inputs, self.enc_in):
            assert ct.encoding == enc, "input encoding mismatch"
        return exec_gadget_with_extraction(sk, self.enc_inter, self.enc_out, list(inputs))

    def exec_clear(self, bits: Sequence[int]) -> int:
        """Clear-model evaluation (reference exec_clear, gadget/gadget/mod.rs:134-136)."""
        return int(self.truth_table(*[int(b) for b in bits]))

    @staticmethod
    def split_int_in_booleans(x: int, expected_length: int,
                              big_endian: bool = False) -> List[int]:
        """(reference split_int_in_booleans, gadget/gadget/mod.rs:82-94)."""
        bits = [(x >> i) & 1 for i in range(expected_length)]
        return bits[::-1] if big_endian else bits

    @staticmethod
    def vec_bool_to_int(bits: Sequence[int], big_endian: bool = False) -> int:
        """(reference vec_bool_to_int, gadget/gadget/mod.rs:97-107)."""
        seq = list(bits)[::-1] if big_endian else list(bits)
        return sum((1 << i) for i, b in enumerate(seq) if b)

    def cast_before_gadget(self, coefficients: Sequence[int],
                           inputs: Sequence[Ciphertext]) -> List[Ciphertext]:
        """Scale {0,1}-encoded inputs onto this gadget's input encodings
        (reference cast_before_gadget, gadget/gadget/mod.rs:150-155)."""
        return [encoding_switching_mul_constant(x, c)
                for x, c in zip(inputs, coefficients) if c != 0]

    def cast_before_gadget_from_1(self, inputs: Sequence[Ciphertext]) -> List[Ciphertext]:
        coeffs = [e.get_part_single_value_if_canonical(1) for e in self.enc_in]
        return self.cast_before_gadget(coeffs, inputs)

    @staticmethod
    def modulus_switching(sk: ServerKey, inputs: Sequence[Ciphertext],
                          p_in_vec: Sequence[int], p_out: int) -> List[Ciphertext]:
        """Move each input to modulus p_out via an identity gadget
        (reference modulus_switching, gadget/gadget/mod.rs:164-174)."""
        assert len(inputs) == len(p_in_vec)
        out = []
        for x, p_i in zip(inputs, p_in_vec):
            if p_i == p_out:
                out.append(x)
                continue
            g = Gadget.new_canonical(lambda b: b, 1, [1], 1, p_i, p_out)
            out.append(g.exec(sk, [x]))
        return out

    def test_full(self, ck: ClientKey, sk: ServerKey) -> bool:
        """Exhaustive truth-table check, encrypt→exec→decrypt per input row
        (the reference's debug helper, gadget/gadget/mod.rs:110-131)."""
        arity = len(self.enc_in)
        for x in range(1 << arity):
            bits = self.split_int_in_booleans(x, arity)
            cts = [encrypt_arithmetic(ck, b, e, seed=1000 + x * 17 + i)
                   for i, (b, e) in enumerate(zip(bits, self.enc_in))]
            if int(decrypt(ck, self.exec(sk, cts))) != self.exec_clear(bits):
                return False
        return True
