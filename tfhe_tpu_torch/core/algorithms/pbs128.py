"""Programmable bootstrapping and keyswitching at a 2^128 ciphertext modulus.

Counterpart of `tfhe_tpu/core/algorithms/pbs128.py` (reference
fft_impl/fft128, `programmable_bootstrap_f128_lwe_ciphertext`).  Torus
elements are two-limb `[..., 2]` int64 tensors (`core/u128.py`):

    Lwe128   data [..., n+1, 2]
    Glwe128  data [..., k+1, N, 2]
    NttBootstrapKey128  spectra [n, P, l*(k+1), k+1, N] int32, the port's
             spectral order (residues are modulus-agnostic; P comes from
             `external_product_num_primes128`)
    KeyswitchKey128     data [n_in, l, n_out+1, 2]

The kernels: every step of `blind_rotate128` is one launch of K8
(`core/poly/external_product.py` `external_product128`, the GGSW shared by
the batch); `keyswitch128` is one decomposition pass and one K2′ launch
(`keyswitch.contract`) on the key split into four 32-bit words, whose
per-word sums are exact in int64 and carried into the two limbs here.

Masks are drawn from threefry keys, bit for bit those of the JAX package
under the same key tree; noise comes from a torch generator.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import threefry, u128
from ..decomposition import signed_decompose128
from ..entities import GlweSecretKey, LweSecretKey
from ..numeric import shr
from ..params import DecompParams
from ..poly import monomial_mul128, ntt
from ..poly.external_product import external_product128
from .keyswitch import contract, limb_layout, tensor_core_form


@dataclass(frozen=True)
class Lwe128:
    data: torch.Tensor          # [..., n+1, 2]

    @property
    def lwe_dimension(self) -> int:
        return self.data.shape[-2] - 1


@dataclass(frozen=True)
class Glwe128:
    data: torch.Tensor          # [..., k+1, N, 2]

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[-2]


@dataclass(frozen=True)
class NttBootstrapKey128:
    spectra: torch.Tensor       # [n, P, l*(k+1), k+1, N] int32
    decomp: DecompParams

    @property
    def input_lwe_dimension(self) -> int:
        return self.spectra.shape[0]

    @property
    def polynomial_size(self) -> int:
        return self.spectra.shape[-1]


@dataclass(frozen=True)
class KeyswitchKey128:
    data: torch.Tensor          # [n_in, l, n_out+1, 2]
    decomp: DecompParams

    @functools.cached_property
    def words(self) -> torch.Tensor:
        """[n_in*l, 4*(n_out+1)] int64: 32-bit word q of entry m (word 0 the
        lowest) at column q*(n_out+1) + m."""
        n_in, levels, m, _ = self.data.shape
        hi, lo = self.data[..., 0], self.data[..., 1]
        m32 = (1 << 32) - 1
        w = torch.cat([lo & m32, shr(lo, 32), hi & m32, shr(hi, 32)], dim=-1)
        return w.reshape(n_in * levels, 4 * m).contiguous()

    @functools.cached_property
    def limbs(self):
        """The word key's bytes for K2′ on the card (`keyswitch.limb_layout`)
        where the shape takes the tensor-core form; None elsewhere."""
        if self.data.device.type != "cuda" or not tensor_core_form(self.decomp.base_log):
            return None
        return limb_layout(self.words)


def external_product_num_primes128(n: int, glwe_size: int, decomp: DecompParams) -> int:
    """The CRT width at 2^128 (tfhe_tpu pbs128.py:84): N * J * B/2 * 2^128,
    against PRIMES_31."""
    j = decomp.level * glwe_size
    log_bound = np.log2(n) + np.log2(j) + (decomp.base_log - 1) + 128
    return ntt.required_num_primes(log_bound, n)


# ---------------------------------------------------------------------------
# encryption / decryption
# ---------------------------------------------------------------------------


def _masked_sum(mask: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^128 for a binary key: mask [..., n, 2], bits [n]."""
    return u128.sum128(torch.where((bits != 0).unsqueeze(-1), mask, torch.zeros_like(mask)),
                       dim=-1)


def encrypt_lwe128(key: torch.Tensor, gen: torch.Generator, sk: LweSecretKey,
                   plaintexts128: torch.Tensor, noise_std: float) -> Lwe128:
    """Plaintexts [..., 2] → Lwe128 [..., n+1, 2]; the mask that of
    tfhe_tpu encrypt_lwe128(key, ...) (split(key)[0]), the noise from gen."""
    lead = tuple(plaintexts128.shape[:-1])
    mask = u128.uniform128(threefry.split(key)[..., 0, :], lead + (sk.lwe_dimension,))
    noise = u128.gaussian_noise128(gen, lead, noise_std)
    body = u128.add128(u128.add128(_masked_sum(mask, sk.bits), plaintexts128), noise)
    return Lwe128(data=torch.cat([mask, body.unsqueeze(-2)], dim=-2))


def decrypt_lwe128(ct: Lwe128, sk: LweSecretKey) -> torch.Tensor:
    """The phase b - <a, s> [..., 2]."""
    return u128.sub128(ct.data[..., -1, :], _masked_sum(ct.data[..., :-1, :], sk.bits))


def _glwe_mask_dot_key128(mask128: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """sum_i mask_i(X) s_i(X) mod (X^N + 1, 2^128): mask [..., k, N, 2]."""
    n = mask128.shape[-2]
    prod = ntt.negacyclic_polymul128(mask128, bits.to(torch.int64),
                                     log_bound=128 + np.log2(n) + 1)
    return u128.sum128(prod, dim=-2)


def encrypt_glwe128(key: torch.Tensor, gen: torch.Generator, sk: GlweSecretKey,
                    plaintext_polys128: torch.Tensor, noise_std: float) -> Glwe128:
    """Plaintext polynomials [..., N, 2] → Glwe128 [..., k+1, N, 2] (keys
    [..., 2] a ciphertext or one for all); the mask that of tfhe_tpu
    encrypt_glwe128."""
    k, n = sk.glwe_dimension, sk.polynomial_size
    lead = tuple(plaintext_polys128.shape[:-2])
    keys = threefry.split(key)[..., 0, :]
    shape = (k, n) if keys.dim() > 1 else lead + (k, n)
    mask = u128.uniform128(keys, shape)
    noise = u128.gaussian_noise128(gen, lead + (n,), noise_std)
    body = u128.add128(u128.add128(_glwe_mask_dot_key128(mask, sk.bits), plaintext_polys128),
                       noise)
    return Glwe128(data=torch.cat([mask, body.unsqueeze(-3)], dim=-3))


def decrypt_glwe128(ct: Glwe128, sk: GlweSecretKey) -> torch.Tensor:
    return u128.sub128(ct.data[..., -1, :, :], _glwe_mask_dot_key128(ct.data[..., :-1, :, :],
                                                                     sk.bits))


def trivial_glwe128(plaintext_polys128: torch.Tensor, glwe_dimension: int) -> Glwe128:
    pts = plaintext_polys128
    mask = u128.zeros128(tuple(pts.shape[:-2]) + (glwe_dimension, pts.shape[-2]), pts.device)
    return Glwe128(data=torch.cat([mask, pts.unsqueeze(-3)], dim=-3))


# ---------------------------------------------------------------------------
# GGSW / bootstrap key
# ---------------------------------------------------------------------------

# GGSWs a bootstrap key is encrypted in, and transformed in, at a time: each
# chunk's [c, l, k+1, k+1, N, 2] words and its [c, l, k+1, k+1, P, N] int64
# spectra stay a few hundred MB at 2_2's shapes.
BSK_CHUNK = 64
NTT_CHUNK = 32


def _ggsw_plaintexts128(msg: torch.Tensor, bits: torch.Tensor,
                        decomp: DecompParams) -> torch.Tensor:
    """[..., l, k+1, N, 2]: row (l, r < k) -m g_l s_r, row (l, k) m g_l at
    coefficient 0, g_l = 2^(128 - B(l+1)), all in the high limb."""
    k, n = bits.shape
    if decomp.base_log * decomp.level > 64:
        raise ValueError("gadget factors must stay in the high limb (base_log*level <= 64)")
    m = msg.to(torch.int64)
    hi = torch.zeros(tuple(m.shape) + (decomp.level, k + 1, n), dtype=torch.int64,
                     device=bits.device)
    for l in range(decomp.level):
        sh = 64 - decomp.base_log * (l + 1)
        hi[..., l, :k, :] = (-(m[..., None, None] * bits)) << sh
        hi[..., l, k, 0] = m << sh
    return u128.make128(hi, torch.zeros_like(hi))


def encrypt_constant_ggsw128(key: torch.Tensor, gen: torch.Generator, sk: GlweSecretKey,
                             msg: torch.Tensor, decomp: DecompParams,
                             noise_std: float) -> torch.Tensor:
    """GGSWs of small integers msg [...] under threefry keys [..., 2] →
    standard data [..., l, k+1, k+1, N, 2] (tfhe_tpu pbs128.py:136: row
    (l, r) encrypted under split(key, l*(k+1))[l*(k+1) + r])."""
    k, n, levels = sk.glwe_dimension, sk.polynomial_size, decomp.level
    keys = threefry.split(key, levels * (k + 1))                      # [..., l(k+1), 2]
    pts = _ggsw_plaintexts128(msg, sk.bits, decomp)                   # [..., l, k+1, N, 2]
    lead = tuple(pts.shape[:-4])
    rows = encrypt_glwe128(keys, gen, sk, pts.reshape(lead + (levels * (k + 1), n, 2)),
                           noise_std).data
    return rows.reshape(lead + (levels, k + 1, k + 1, n, 2))


def generate_bootstrap_key128(key: torch.Tensor, gen: torch.Generator, lwe_sk: LweSecretKey,
                              glwe_sk: GlweSecretKey, decomp: DecompParams,
                              noise_std: float) -> torch.Tensor:
    """[n, l, k+1, k+1, N, 2]: a GGSW of each input key bit under
    split(key, n)[i] (tfhe_tpu pbs128.py:178), on the keys' device, in
    chunks of BSK_CHUNK GGSWs."""
    n_in = lwe_sk.lwe_dimension
    keys = threefry.split(key, n_in)
    parts = [encrypt_constant_ggsw128(keys[i:i + BSK_CHUNK], gen, glwe_sk,
                                      lwe_sk.bits[i:i + BSK_CHUNK], decomp, noise_std)
             for i in range(0, n_in, BSK_CHUNK)]
    return torch.cat(parts)


def bootstrap_key128_to_ntt(data128: torch.Tensor, decomp: DecompParams) -> NttBootstrapKey128:
    """Standard 128-bit GGSWs [n, l, k+1, k+1, N, 2] → the port's spectra
    [n, P, l*(k+1), k+1, N] int32 (tfhe_tpu pbs128.py:195, whose DIF order
    is the port's order), in chunks of NTT_CHUNK GGSWs."""
    n_in, levels, glwe_size, _, n, _ = data128.shape
    P = external_product_num_primes128(n, glwe_size, decomp)
    plan = ntt.get_plan(n, P)
    spectra = torch.empty((n_in, P, levels * glwe_size, glwe_size, n), dtype=torch.int32,
                          device=data128.device)
    for i in range(0, n_in, NTT_CHUNK):
        hat = ntt.ntt_forward128(plan, data128[i:i + NTT_CHUNK])    # [c, l, row, comp, P, N]
        spectra[i:i + NTT_CHUNK] = hat.permute(0, 4, 1, 2, 3, 5).reshape(
            -1, P, levels * glwe_size, glwe_size, n).to(torch.int32)
    return NttBootstrapKey128(spectra=spectra, decomp=decomp)


# ---------------------------------------------------------------------------
# the PBS
# ---------------------------------------------------------------------------


def modulus_switch128(x128: torch.Tensor, polynomial_size: int) -> torch.Tensor:
    """128-bit torus → Z_2N: the 64-bit switch of the high limb (tfhe_tpu
    pbs128.py:216)."""
    from ..poly.rotation import modulus_switch
    return modulus_switch(x128[..., 0], polynomial_size)


def blind_rotate128(lut: Glwe128, lwe: Lwe128, bsk: NttBootstrapKey128) -> Glwe128:
    """tfhe_tpu pbs128.py:264: the LUT pre-rotated by -b, then per mask
    element j acc += GGSW(s_j) [x] (X^a_j acc - acc), one K8 launch a step
    with the step's GGSW shared by the batch.  lut [k+1, N, 2] or [...,
    k+1, N, 2]; lwe [..., n+1, 2] → [..., k+1, N, 2]."""
    n = bsk.polynomial_size
    batch = tuple(lwe.data.shape[:-2])
    switched = modulus_switch128(lwe.data.reshape(-1, lwe.data.shape[-2], 2), n)
    lut_b = lut.data.expand(batch + tuple(lut.data.shape[-3:])).reshape(
        (-1,) + tuple(lut.data.shape[-3:]))
    acc = monomial_mul128(lut_b, (2 * n - switched[:, -1]).unsqueeze(-1)).contiguous()
    exps = torch.remainder(switched[:, :-1], 2 * n)
    for j in range(bsk.input_lwe_dimension):
        acc = external_product128(acc, bsk.spectra[j], bsk.decomp, exps[:, j])
    return Glwe128(data=acc.reshape(batch + tuple(acc.shape[-3:])))


def sample_extract128(glwe: Glwe128, index: int = 0) -> Lwe128:
    """Coefficient `index` as an Lwe128 under the flattened GLWE key."""
    n = glwe.polynomial_size
    j = torch.arange(n, device=glwe.data.device)
    src = torch.remainder(index - j, n)
    rows = glwe.data[..., :-1, :, :][..., src, :]                   # [..., k, N, 2]
    rows = u128.where128((j > index).expand(rows.shape[:-1]), u128.neg128(rows), rows)
    flat = rows.reshape(tuple(rows.shape[:-3]) + (-1, 2))
    body = glwe.data[..., -1, index, :]
    return Lwe128(data=torch.cat([flat, body.unsqueeze(-2)], dim=-2))


def programmable_bootstrap128(lwe: Lwe128, lut: Glwe128, bsk: NttBootstrapKey128) -> Lwe128:
    return sample_extract128(blind_rotate128(lut, lwe, bsk), 0)


# ---------------------------------------------------------------------------
# the 128-bit keyswitch
# ---------------------------------------------------------------------------


def _gadget_plaintexts128(bits: torch.Tensor, decomp: DecompParams) -> torch.Tensor:
    """[n_in, l, 2]: s_in[i] * 2^(128 - B(l+1))."""
    b = bits.to(torch.int64)
    hi, lo = [], []
    for l in range(decomp.level):
        sh = 128 - decomp.base_log * (l + 1)
        if sh >= 64:
            hi.append(b << (sh - 64))
            lo.append(torch.zeros_like(b))
        else:
            hi.append(shr(b, 64 - sh))
            lo.append(b << sh)
    return u128.make128(torch.stack(hi, dim=-1), torch.stack(lo, dim=-1))


def generate_keyswitch_key128(key: torch.Tensor, gen: torch.Generator, in_sk: LweSecretKey,
                              out_sk: LweSecretKey, decomp: DecompParams,
                              noise_std: float) -> KeyswitchKey128:
    """KSK[i, l] = Lwe128_out(s_in[i] * 2^(128 - B(l+1))) (tfhe_tpu
    pbs128.py:299), its mask that of the JAX function under the same key."""
    ct = encrypt_lwe128(key, gen, out_sk, _gadget_plaintexts128(in_sk.bits, decomp), noise_std)
    return KeyswitchKey128(data=ct.data, decomp=decomp)


def _high_digits_source(mask128: torch.Tensor, decomp: DecompParams) -> torch.Tensor:
    """The 64-bit word whose 64-bit decomposition is `signed_decompose128`'s
    of mask128: hi, plus lo's top bit at base_log * level = 64 (there the
    64-bit form rounds nothing)."""
    hi = mask128[..., 0]
    if decomp.base_log * decomp.level == 64:
        return hi + shr(mask128[..., 1], 63)
    return hi


def keyswitch128(ct: Lwe128, ksk: KeyswitchKey128) -> Lwe128:
    """(0, b) - sum_{i,l} d_{i,l} KSK[i, l] mod 2^128 (tfhe_tpu
    pbs128.py:323), as one contraction over the key's four 32-bit words
    (`keyswitch.contract`: one decomposition pass and one K2′ launch on the
    card).  Each word's sum is at most K * 2^(B-1) * (2^32 - 1) in
    magnitude, below 2^63 at every named shape, so it is exact in int64;
    the four are carried into the two limbs here."""
    n_in, levels, m, _ = ksk.data.shape
    batch = tuple(ct.data.shape[:-2])
    src = _high_digits_source(ct.data[..., :-1, :].reshape(-1, n_in, 2), ksk.decomp)
    zero = torch.zeros(src.shape[0], dtype=torch.int64, device=src.device)
    s = contract(src, ksk.words, ksk.decomp, zero, ksk.limbs).reshape(-1, 4, m)
    s0, s1, s2, s3 = s.unbind(dim=1)
    total = u128.add128(u128.make128(s0 >> 63, s0), u128.make128(s1 >> 32, s1 << 32))
    total = u128.add128(total, u128.make128(s2 + (s3 << 32), torch.zeros_like(s2)))
    body = u128.add128(total[:, -1], ct.data[..., -1, :].reshape(-1, 2))
    out = torch.cat([total[:, :-1], body.unsqueeze(-2)], dim=-2)
    return Lwe128(data=out.reshape(batch + (m, 2)))


def keyswitch128_plain(ct: Lwe128, ksk: KeyswitchKey128) -> Lwe128:
    """The JAX function's formula in two limbs (each digit times each
    128-bit key word, summed with carries): what `keyswitch128`'s word form
    is held against."""
    mask, body = ct.data[..., :-1, :], ct.data[..., -1, :]
    digits = signed_decompose128(mask, ksk.decomp)                 # [..., n_in, L]
    terms = u128.mul_small_signed_by_128(digits[..., None], ksk.data)   # [..., n_in, L, m, 2]
    acc = u128.sum128(u128.sum128(terms, dim=-2), dim=-2)
    out = u128.neg128(acc)
    out_body = u128.add128(out[..., -1, :], body)
    return Lwe128(data=torch.cat([out[..., :-1, :], out_body.unsqueeze(-2)], dim=-2))


__all__ = ["Lwe128", "Glwe128", "NttBootstrapKey128", "KeyswitchKey128",
           "external_product_num_primes128", "encrypt_lwe128", "decrypt_lwe128",
           "encrypt_glwe128", "decrypt_glwe128", "trivial_glwe128", "encrypt_constant_ggsw128",
           "generate_bootstrap_key128", "bootstrap_key128_to_ntt", "modulus_switch128",
           "monomial_mul128", "blind_rotate128", "sample_extract128",
           "programmable_bootstrap128", "generate_keyswitch_key128", "keyswitch128",
           "keyswitch128_plain"]
