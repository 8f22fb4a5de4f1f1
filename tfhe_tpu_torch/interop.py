"""Keys carried across from the JAX package, as numpy arrays.

The JAX package's key arrays (`np.asarray` of its entities' fields) become
the port's keys, so that both packages compute the same thing on the same
keys.  Nothing here imports jax.

  secret keys            int8 bits            → LweSecretKey / GlweSecretKey
  LweKeyswitchKey.data   [big_n, l, n+1] u64  → LweKeyswitchKey
  LweBootstrapKey.data   [n, l, k+1, k+1, N]  → the port's NttBootstrapKey
  NttLweBootstrapKey.data [n, P, J, R, N] u64 residues in the JAX DIF order
                                              → the port's NttBootstrapKey
  multi-bit standard BSK [n/g, 2^g, l, k+1, k+1, N] u64
                                              → the port's NttMultiBitBootstrapKey
  NttMultiBitBootstrapKey.data [n/g, 2^g, P, J, R, N] u64 residues, DIF order
                                              → the port's NttMultiBitBootstrapKey
                                                (also the DIF key of the JAX
                                                per-step route, MXU off)
  bootstrap_key_to_ntt_paired output [n, 2, P, J, R, N] u32, DIF order
                                              → the port's paired NttBootstrapKey

The WoP-PBS and casting keys cross as their arrays around port keys:
  CbsPfpkskList.data [k+1, n_in+1, l, k+1, N] u64 → CbsPfpkskList
                                              (`cbs_pfpksk`)
  WopbsKey, CombinedWopbsKey                  → their port classes over
                                                port server keys (`wopbs_key`,
                                                `combined_wopbs_key`)
  shortint KeySwitchingKey.ksk.data           → KeySwitchingKey (`casting_key`)
  ShiftKey                                    → the port's over a combined
                                                WoP-PBS key and two server
                                                keys, its packing KSK from
                                                its data (`shift_key`)
and the hlapi keys wrap the shortint and integer keys (`hlapi_keys`).

The gadget keys cross as their arrays (`gadget_keys`): the two secret
keys' bits, the BSK's DIF-order `NttLweBootstrapKey.data`, the KSK
[kN, l, n+1], the packing KSK [kN, l, k+1, N] and the relinearization key
[pairs, l, k+1, N] (u64); a gadget ciphertext as its [..., n+1] u64 array
and its encoding (`gadget_ciphertext`; the `Encoding` class is the JAX
package's, copied whole).

A boolean server key crosses as its KSK data and its DIF-order
`NttLweBootstrapKey.data` (`boolean_server_key`), a boolean ciphertext as
its [..., n+1] u64 array (`bool_ciphertext`).  On the 32-bit torus
(log_q = 32) the words are uint32 and are lifted (`core/numeric.py`); the
BSK's residues are those of 32-bit words over the JAX package's 32-bit
prime count, inverted and lifted, then converted at the port's 64-bit
count to the "rotate" route (`core.numeric.to_numpy_torus` drops them again).  An integer ciphertext
crosses as its blocks' LWE arrays ([..., n+1] u64
each) and their metadata (`radix_ciphertext`); an integer key is a
shortint key and crosses as one.

The DIF residues are inverted with the port's copy of the JAX plan tables
and Garner (signed lift, exact: |coefficient| < 2^64 < M/2), back to the
standard coefficients, from which the port builds its own spectra.

Like every entry point of the port, each constructor puts its key on the
card unless given `device="cpu"`; without a card that raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.algorithms.encryption import (bootstrap_key_to_ntt, bootstrap_key_to_ntt_paired,
                                         trivial_ggsw_one_ntt)
from .core.algorithms.keyswitch import keyswitch_key as make_keyswitch_key
from .core.algorithms.multi_bit import multi_bit_bootstrap_key_to_ntt
from .core.algorithms.wopbs import CbsPfpkskList
from .core.entities import (GlweSecretKey, LweBootstrapKey, LweCiphertext,
                            LweKeyswitchKey, LweMultiBitBootstrapKey, LweSecretKey,
                            NttBootstrapKey, NttMultiBitBootstrapKey)
from .core.numeric import from_numpy_torus, from_numpy_u64, lift32
from .core.params import DecompParams
from .core.poly import ntt
from .cuda_lib import resolve_device
from .boolean import BoolCiphertext
from .core.entities import GlweRelinearizationKey, LwePackingKeyswitchKey
from .gadget import engine as gadget_engine
from .gadget.encoding import Encoding
from .boolean import ServerKey as BooleanServerKey
from .integer.ciphertext import CrtCiphertext, RadixCiphertext, SignedRadixCiphertext
from .shortint.ciphertext import Ciphertext
from .shortint.key_switching_key import KeySwitchingKey
from .shortint.wopbs import CombinedWopbsKey, WopbsKey


def lwe_secret_key(bits, device="cuda") -> LweSecretKey:
    return LweSecretKey(bits=torch.as_tensor(np.asarray(bits, dtype=np.int64),
                                             device=resolve_device(device)))


def glwe_secret_key(bits, device="cuda") -> GlweSecretKey:
    return GlweSecretKey(bits=torch.as_tensor(np.asarray(bits, dtype=np.int64),
                                              device=resolve_device(device)))


def keyswitch_key(data, decomp: DecompParams, device="cuda") -> LweKeyswitchKey:
    """KSK [n_in, l, n_out+1] u64 (or u32, lifted); on the card with the
    limb layout K2′ reads, where the set takes the tensor-core keyswitch."""
    return make_keyswitch_key(from_numpy_torus(data, resolve_device(device)), decomp)


def bootstrap_key_from_standard(data, decomp: DecompParams, num_primes: int,
                                device="cuda") -> NttBootstrapKey:
    """Standard BSK [n, l, k+1, k+1, N] u64 → the port's spectra."""
    std = LweBootstrapKey(data=from_numpy_u64(data, resolve_device(device)),
                          decomp=decomp)
    return bootstrap_key_to_ntt(std, num_primes)


def paired_bootstrap_key_from_standard(data, decomp: DecompParams, num_primes: int,
                                       device="cuda") -> NttBootstrapKey:
    """Standard BSK [n, l, k+1, k+1, N] u64 → the port's paired key, spectra
    [n, 2, P, J, R, N] of [GGSW(1 - s_i), GGSW(s_i)], whatever the
    switches say."""
    return bootstrap_key_to_ntt_paired(bootstrap_key_from_standard(data, decomp, num_primes,
                                                                   device))


def multi_bit_bootstrap_key_from_standard(data, decomp: DecompParams,
                                          grouping_factor: int, num_primes: int,
                                          device="cuda") -> NttMultiBitBootstrapKey:
    """Standard multi-bit BSK [n/g, 2^g, l, k+1, k+1, N] u64 → the port's
    spectra."""
    std = LweMultiBitBootstrapKey(data=from_numpy_u64(data, resolve_device(device)),
                                  decomp=decomp, grouping_factor=grouping_factor)
    return multi_bit_bootstrap_key_to_ntt(std, num_primes)


def standard_from_dif(data, primes) -> np.ndarray:
    """JAX NttLweBootstrapKey.data [n, P, J, R, N] (DIF-order residues) →
    standard coefficients [n, l*(k+1), k+1, N] u64 (the contraction axis
    stays flattened).  Raises unless `primes` equal primes_for(N)[:P], and
    unless the data are residues over those primes of 64-bit words: every
    residue below its prime and every coefficient's lift within
    [-2^63, 2^63) (ROADMAP C2: a key made on another prime pool fails
    this, whatever primes it is said to be on)."""
    data = np.asarray(data)
    n_in, P, J, R, n = data.shape
    plan = ntt.get_plan(n, P)
    if tuple(int(p) for p in primes) != plan.primes:
        raise ValueError(f"key primes {tuple(primes)} differ from primes_for({n})"
                         f"[:{P}] = {plan.primes}")
    res = torch.from_numpy(data.astype(np.int64)).permute(0, 2, 3, 1, 4)  # [n,J,R,P,N]
    p = torch.tensor(plan.primes, dtype=torch.int64).reshape(P, 1)
    if bool((res >= p).any()) or bool((res < 0).any()):
        raise ValueError(f"residues at or above their primes {plan.primes}")
    natural = ntt.dif_inverse(plan, res)
    coeffs = ntt.garner_to_torus(plan, natural)
    # the int64 lift reduces back to the residues exactly when the lift of
    # the CRT value lies in [-2^63, 2^63)
    if not torch.equal(ntt.reduce(plan, coeffs), natural):
        raise ValueError(f"the residues lift to values beyond 64 bits over primes_for({n})"
                         f"[:{P}]: a key made on another prime pool")
    return coeffs.numpy().view(np.uint64)


def bootstrap_key_from_dif(data, primes, decomp: DecompParams,
                           device="cuda", log_q: int = 64) -> NttBootstrapKey:
    """JAX NttLweBootstrapKey.data → the port's spectra (through the
    standard coefficients).  At log_q = 32 the residues are those of 32-bit
    words (the JAX package's 32-bit prime count): the coefficients are
    lifted and converted at the port's 64-bit prime count to the "rotate"
    route."""
    std = standard_from_dif(data, primes)
    n_in, J, R, n = std.shape
    std = std.reshape(n_in, J // R, R, R, n)
    if log_q == 32:
        from .core.algorithms.bootstrap import external_product_num_primes
        words = lift32(torch.from_numpy(std.view(np.int64) & 0xFFFFFFFF))
        bsk = LweBootstrapKey(data=words.to(resolve_device(device)), decomp=decomp)
        return bootstrap_key_to_ntt(bsk, external_product_num_primes(n, R, decomp), 32)
    return bootstrap_key_from_standard(std, decomp, np.asarray(data).shape[1], device)


def paired_bootstrap_key_from_dif(data, primes, decomp: DecompParams,
                                  device="cuda") -> NttBootstrapKey:
    """JAX `bootstrap_key_to_ntt_paired` output [n, 2, P, J, R, N] (DIF-order
    residues of [GGSW_trivial(1) - GGSW(s_i), GGSW(s_i)]) → the port's
    paired key.  pair1 crosses through the standard coefficients; pair0 is
    checked to be GGSW_trivial(1) - pair1 slot by slot (the trivial GGSW's
    spectrum is the same in every order) and rebuilt in the port's order.
    Raises unless `primes` equal primes_for(N)[:P] and pair0 checks."""
    data = np.asarray(data).astype(np.int64)
    n_in, two, P, J, R, n = data.shape
    if two != 2:
        raise ValueError(f"a paired key has 2 GGSWs per step, not {two}")
    std = standard_from_dif(data[:, 1], primes).reshape(n_in, J // R, R, R, n)
    g1 = trivial_ggsw_one_ntt(n, R, decomp, P).numpy()
    p = np.asarray([int(q) for q in primes], dtype=np.int64).reshape(P, 1, 1, 1)
    if not np.array_equal(data[:, 0], (g1 + p - data[:, 1]) % p):
        raise ValueError("pair0 of the paired key is not GGSW_trivial(1) - pair1")
    return paired_bootstrap_key_from_standard(std, decomp, P, device)


def multi_bit_bootstrap_key_from_dif(data, primes, decomp: DecompParams,
                                     grouping_factor: int,
                                     device="cuda") -> NttMultiBitBootstrapKey:
    """JAX NttMultiBitBootstrapKey.data [n/g, 2^g, P, J, R, N] (DIF-order
    residues) → the port's spectra (through the standard coefficients).
    Raises unless `primes` equal primes_for(N)[:P]."""
    data = np.asarray(data)
    ng, nv, P, J, R, n = data.shape
    std = standard_from_dif(data.reshape((ng * nv,) + data.shape[2:]), primes)
    std = std.reshape(ng, nv, J // R, R, R, n)
    return multi_bit_bootstrap_key_from_standard(std, decomp, grouping_factor, P, device)


def boolean_server_key(ksk, bsk_dif, primes, params, device="cuda") -> BooleanServerKey:
    """A JAX boolean server key's arrays (`boolean.gen_server_key`): its KSK
    data [kN, l, n+1] u64 (u32 on the 32-bit torus) and its
    NttLweBootstrapKey.data [n, P, J, R, N] (DIF-order residues over
    `primes`) → the port's boolean ServerKey."""
    return BooleanServerKey(bsk=bootstrap_key_from_dif(bsk_dif, primes, params.pbs_decomp,
                                                       device, params.log_q),
                            ksk=keyswitch_key(ksk, params.ks_decomp, device), params=params)


def bool_ciphertext(data, device="cuda") -> BoolCiphertext:
    """A JAX BoolCiphertext's words [..., n+1] u64 (u32 on the 32-bit
    torus, lifted) → the port's."""
    data = np.asarray(data)
    return BoolCiphertext(lwe=LweCiphertext(data=from_numpy_torus(data, resolve_device(device))),
                          log_q=32 if data.dtype == np.uint32 else 64)


def radix_ciphertext(blocks, degrees, noise_levels, message_modulus: int,
                     carry_modulus: int, kind: str = "radix", moduli=(),
                     device="cuda"):
    """A JAX integer ciphertext's blocks (numpy u64 [..., n+1] each, little
    endian), with each block's degree and noise level → the port's
    RadixCiphertext (kind "radix"), SignedRadixCiphertext ("signed") or
    CrtCiphertext ("crt", with its moduli)."""
    if not len(blocks) == len(degrees) == len(noise_levels):
        raise ValueError(f"{len(blocks)} blocks, {len(degrees)} degrees and "
                         f"{len(noise_levels)} noise levels")
    dev = resolve_device(device)
    out = [Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(b, dev)), degree=int(d),
                      message_modulus=message_modulus, carry_modulus=carry_modulus,
                      noise_level=int(nl))
           for b, d, nl in zip(blocks, degrees, noise_levels)]
    if kind == "radix":
        return RadixCiphertext(blocks=out)
    if kind == "signed":
        return SignedRadixCiphertext(blocks=out)
    if kind == "crt":
        if len(moduli) != len(out):
            raise ValueError(f"{len(out)} CRT blocks and {len(moduli)} moduli")
        return CrtCiphertext(blocks=out, moduli=tuple(int(m) for m in moduli))
    raise ValueError(f"kind is 'radix', 'signed' or 'crt', not {kind!r}")


def cbs_pfpksk(data, decomp: DecompParams, device="cuda") -> CbsPfpkskList:
    """A JAX CbsPfpkskList's data [k+1, n_in+1, l, k+1, N] u64 → the port's."""
    return CbsPfpkskList(data=from_numpy_u64(data, resolve_device(device)), decomp=decomp)


def wopbs_key(server_key, pfpksk_data, pfks_decomp: DecompParams, cbs_decomp: DecompParams,
              device="cuda") -> WopbsKey:
    """A JAX WopbsKey → the port's: its server key already carried across (a
    port shortint ServerKey), its PFPKSK list from the arrays."""
    return WopbsKey(server_key=server_key, pfpksk=cbs_pfpksk(pfpksk_data, pfks_decomp, device),
                    cbs_decomp=cbs_decomp)


def combined_wopbs_key(inner: WopbsKey, pbs_server_key, ksk_data, ks_decomp: DecompParams,
                       device="cuda") -> CombinedWopbsKey:
    """A JAX CombinedWopbsKey → the port's: the inner WopbsKey and the
    compute server key (with its casting KSK) already carried across, the
    compute → WoP-PBS casting key from its data [kN, l, n_w+1] u64."""
    return CombinedWopbsKey(wopbs_key=inner, pbs_server_key=pbs_server_key,
                            ksk_pbs_to_wopbs=keyswitch_key(ksk_data, ks_decomp, device))


def casting_key(ksk_data, decomp: DecompParams, dest_params, cast_rshift: int,
                dest_server_key=None, src_server_key=None, device="cuda") -> KeySwitchingKey:
    """A JAX shortint KeySwitchingKey → the port's: its KSK data [n_1, l,
    n_2+1] u64 and metadata, over port server keys for the shift LUTs."""
    return KeySwitchingKey(ksk=keyswitch_key(ksk_data, decomp, device), dest_params=dest_params,
                           cast_rshift=cast_rshift, dest_server_key=dest_server_key,
                           src_server_key=src_server_key)


def shift_key(wopbs, pksk_data, pksk_decomp: DecompParams, cbs_server_key,
              refresh_server_key, cbs_decomp: DecompParams, device="cuda"):
    """A JAX ShiftKey → the port's: its combined WoP-PBS key and its two
    casting server keys already carried across (port keys), its packing
    keyswitching key from the data [kN, l, k_w+1, N_w] u64."""
    from .integer.shift_key import ShiftKey
    return ShiftKey(wopbs=wopbs, pksk=LwePackingKeyswitchKey(
        data=from_numpy_u64(pksk_data, resolve_device(device)), decomp=pksk_decomp),
        cbs_server_key=cbs_server_key, refresh_server_key=refresh_server_key,
        cbs_decomp=cbs_decomp)


def hlapi_keys(client_key, server_key) -> tuple:
    """(hlapi ClientKey, hlapi ServerKey) around a port shortint client key
    and shortint server key (the JAX hlapi keys hold the same two)."""
    from . import hlapi
    from .integer.server_key import ServerKey as IntegerServerKey
    return hlapi.ClientKey(client_key), hlapi.ServerKey(IntegerServerKey(key=server_key))


def gadget_ciphertext(data, encoding: Encoding, device="cuda") -> gadget_engine.Ciphertext:
    """A JAX gadget Ciphertext's words [..., n+1] u64 and its encoding → the
    port's."""
    return gadget_engine.Ciphertext(
        lwe=LweCiphertext(data=from_numpy_u64(data, resolve_device(device))), encoding=encoding)


def gadget_keys(lwe_bits, glwe_bits, bsk_dif, primes, ksk, pksk, rlk, params,
                device="cuda") -> tuple:
    """A JAX gadget key pair's arrays (`tfhe_tpu.gadget.gen_keys`): the
    secret keys' bits, the NttLweBootstrapKey.data [n, P, J, R, N] (DIF-order
    residues over `primes`), the KSK, packing KSK and relinearization key
    data (u64) → the port's (ClientKey, ServerKey) for `params` (either PBS
    order: the keys serve both)."""
    dev = resolve_device(device)
    ck = gadget_engine.ClientKey(lwe_sk=lwe_secret_key(lwe_bits, dev),
                                 glwe_sk=glwe_secret_key(glwe_bits, dev), params=params)
    sk = gadget_engine.ServerKey(
        bsk=bootstrap_key_from_dif(bsk_dif, primes, params.pbs_decomp, dev),
        ksk=keyswitch_key(ksk, params.ks_decomp, dev),
        pksk=LwePackingKeyswitchKey(data=from_numpy_u64(pksk, dev), decomp=params.ks_decomp),
        rlk=GlweRelinearizationKey(data=from_numpy_u64(rlk, dev), decomp=params.pbs_decomp),
        params=params)
    return ck, sk
