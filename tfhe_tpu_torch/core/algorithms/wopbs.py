"""WoP-PBS (programmable bootstrapping without padding): bit extraction,
circuit bootstrapping, vertical packing.

Counterpart of `tfhe_tpu/core/algorithms/wopbs.py` (reference
fft_impl/fft64/crypto/wop_pbs/mod.rs: extract_bits :66,
homomorphic_shift_boolean :370, circuit_bootstrap_boolean :243,
vertical_packing :785; algorithms/lwe_private_functional_packing_keyswitch.rs).
Batched over leading axes; GGSW lists are ordered MSB first.  The kernels:
the PBS of `extract_bits` and of the circuit bootstrap is K1 (or the route
the key records), their keyswitches the pass and K2′; the private
functional keyswitch is `keyswitch.contract` (the pass and K2′, its digits
in as many byte limbs as the pfks base_log needs); every CMux and every step of
vertical packing's GGSW-driven rotation is one K7 launch over a GGSW per
row.  GGSWs enter K7 as the port's spectra (`ggsw_to_ntt`), not the JAX
package's DIF order and Shoup twins.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import torch

from .. import threefry
from ..decomposition import signed_decompose
from ..entities import (GgswCiphertext, GlweCiphertext, GlweSecretKey, LweCiphertext,
                        LweKeyswitchKey, LweSecretKey, NttBootstrapKey)
from ..numeric import LOG_Q, as_i64
from ..params import DecompParams
from ..poly import monomial_mul
from ..poly.external_product import external_product
from .bootstrap import external_product_num_primes, programmable_bootstrap, sample_extract
from .encryption import encrypt_glwe_from_key, ggsw_spectra, trivial_glwe
from .keyswitch import contract, keyswitch_lwe, limb_layout, tensor_core_form


# ---------------------------------------------------------------------------
# the private functional packing keyswitch (PFPKS)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CbsPfpkskList:
    """One PFPKSK per output GGSW row r: packs LWE(m) into GLWE(m * v_r(X)),
    v_r = -s_r for r < k, v_k = 1 (reference
    LwePrivateFunctionalPackingKeyswitchKeyList for the circuit bootstrap).

    data [k+1, n_in+1, l, k+1, N] int64: per row key, per input position
    (the mask's, then the body's), per level, a GLWE encryption of
    s_in[i] * v_r(X) * q/B^(l+1) (i < n_in) or v_r(X) * q/B^(l+1)."""

    data: torch.Tensor
    decomp: DecompParams

    @functools.cached_property
    def limbs(self) -> Optional[list]:
        """Each row key's words as bytes for K2′ (`keyswitch.limb_layout`),
        built once on the card where the decomposition takes the
        tensor-core form; None elsewhere."""
        glwe_size, m, levels, _, n = self.data.shape
        if self.data.device.type != "cuda" or not tensor_core_form(self.decomp.base_log):
            return None
        return [limb_layout(self.data[r].reshape(m * levels, glwe_size * n))
                for r in range(glwe_size)]


def generate_cbs_pfpksk(key: torch.Tensor, gen: torch.Generator, big_sk: LweSecretKey,
                        glwe_sk: GlweSecretKey, decomp: DecompParams,
                        noise_std: float) -> CbsPfpkskList:
    """The PFPKSK list, row r's masks those of tfhe_tpu generate_cbs_pfpksk
    under fork(key, r) (threefry), the noise from gen."""
    k, n = glwe_sk.glwe_dimension, glwe_sk.polynomial_size
    dev = glwe_sk.bits.device
    coeff = torch.cat([big_sk.bits.to(torch.int64),
                       torch.ones(1, dtype=torch.int64, device=dev)])      # [n_in+1]
    g = torch.tensor([as_i64(1 << (LOG_Q - decomp.base_log * (l + 1)))
                      for l in range(decomp.level)], dtype=torch.int64, device=dev)
    rows = []
    for r in range(k + 1):
        if r < k:
            v = -glwe_sk.bits[r].to(torch.int64)
        else:
            v = torch.zeros(n, dtype=torch.int64, device=dev)
            v[0] = 1
        pts = coeff[:, None, None] * v[None, None, :] * g[None, :, None]   # [n_in+1, l, N]
        rows.append(encrypt_glwe_from_key(threefry.fork(key, r), gen, glwe_sk, pts,
                                          noise_std).data)
    return CbsPfpkskList(data=torch.stack(rows), decomp=decomp)


def private_functional_keyswitch(ct: LweCiphertext, pfpksk: CbsPfpkskList,
                                 row: int) -> GlweCiphertext:
    """LWE(m) [..., n_in+1] → GLWE(m * v_row(X)) [..., k+1, N] (tfhe_tpu
    wopbs.py:83; reference
    private_functional_keyswitch_lwe_ciphertext_into_glwe_ciphertext):
    sum_l d_l(b) K[n_in, l] - sum_{i,l} d_l(a_i) K[i, l].  K2′'s contraction
    gives -sum over every position, mask and body alike; twice the body's
    term (l rows of the key) turns its sign."""
    key = pfpksk.data[row]                                 # [n_in+1, l, k+1, N]
    m, levels, glwe_size, n = key.shape
    x = ct.data.reshape(-1, m)
    flat = key.reshape(m * levels, glwe_size * n)
    zero = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    limbs = pfpksk.limbs[row] if pfpksk.limbs is not None else None
    out = contract(x, flat, pfpksk.decomp, zero, limbs)
    body_digits = signed_decompose(x[:, -1], pfpksk.decomp)              # [B, l]
    out += 2 * (body_digits.unsqueeze(-1) * flat[(m - 1) * levels:]).sum(dim=1)
    return GlweCiphertext(data=out.reshape(tuple(ct.data.shape[:-1]) + (glwe_size, n)))


# ---------------------------------------------------------------------------
# bit extraction (reference extract_bits, wop_pbs/mod.rs:66-231)
# ---------------------------------------------------------------------------


def _sign_lut(alpha: int, k: int, n: int, device) -> GlweCiphertext:
    """The trivial accumulator with every coefficient -alpha."""
    return trivial_glwe(torch.full((n,), as_i64(-alpha), dtype=torch.int64, device=device), k)


def _add_to_body(data: torch.Tensor, value: int) -> torch.Tensor:
    out = data.clone()
    out[..., -1] += as_i64(value)
    return out


def extract_bits(lwe_in: LweCiphertext, ksk: LweKeyswitchKey, bsk: NttBootstrapKey,
                 delta_log: int, num_bits: int) -> LweCiphertext:
    """The `num_bits` plaintext bits from bit `delta_log` up (tfhe_tpu
    wopbs.py:107) → [..., num_bits, n_small+1], MSB first, each at scale
    2^63 under the small key: per bit a keyswitch of the value shifted to
    the top, and for all but the last a sign PBS that clears the bit."""
    n = bsk.polynomial_size
    k = bsk.spectra.shape[-2] - 1
    state = lwe_in.data
    outs = []
    for bit_idx in range(num_bits):
        shift = LOG_Q - delta_log - bit_idx - 1
        ks = keyswitch_lwe(LweCiphertext(data=state * as_i64(1 << shift)), ksk)
        outs.append(ks.data)
        if bit_idx == num_bits - 1:
            break
        alpha = 1 << (delta_log - 1 + bit_idx)
        pbs = programmable_bootstrap(LweCiphertext(data=_add_to_body(ks.data, 1 << 62)),
                                     _sign_lut(alpha, k, n, state.device), bsk)
        state = state - _add_to_body(pbs.data, alpha)
    return LweCiphertext(data=torch.stack(outs[::-1], dim=-2))


# ---------------------------------------------------------------------------
# the circuit bootstrap (reference circuit_bootstrap_boolean, wop_pbs/mod.rs:243)
# ---------------------------------------------------------------------------


def homomorphic_shift_boolean(bsk: NttBootstrapKey, lwe_in: LweCiphertext, level: int,
                              cbs_base_log: int, delta_log: int) -> LweCiphertext:
    """LWE(bit * 2^delta_log) → LWE(bit * q / B^level) by one sign PBS
    (tfhe_tpu wopbs.py:145)."""
    n = bsk.polynomial_size
    k = bsk.spectra.shape[-2] - 1
    data = _add_to_body(lwe_in.data * as_i64(1 << (LOG_Q - delta_log - 1)), 1 << 62)
    alpha = 1 << (LOG_Q - 1 - cbs_base_log * level)
    out = programmable_bootstrap(LweCiphertext(data=data),
                                 _sign_lut(alpha, k, n, data.device), bsk)
    return LweCiphertext(data=_add_to_body(out.data, alpha))


def circuit_bootstrap_boolean(bsk: NttBootstrapKey, lwe_in: LweCiphertext,
                              pfpksk: CbsPfpkskList, cbs_decomp: DecompParams,
                              delta_log: int) -> GgswCiphertext:
    """LWE(bit * 2^delta_log) → GGSW(bit) [..., l_cbs, k+1, k+1, N]: per
    level one PBS, per row one PFPKS (tfhe_tpu wopbs.py:161)."""
    levels = []
    for lvl in range(1, cbs_decomp.level + 1):
        shifted = homomorphic_shift_boolean(bsk, lwe_in, lvl, cbs_decomp.base_log, delta_log)
        levels.append(torch.stack([private_functional_keyswitch(shifted, pfpksk, r).data
                                   for r in range(pfpksk.data.shape[0])], dim=-3))
    return GgswCiphertext(data=torch.stack(levels, dim=-4), decomp=cbs_decomp)


def ggsw_to_ntt(ggsw: GgswCiphertext) -> torch.Tensor:
    """GGSWs [..., l, k+1, k+1, N] → the port's spectra [..., P, l*(k+1),
    k+1, N] int32 over the external product's primes (tfhe_tpu
    wopbs.py:176, which returns the JAX DIF order and Shoup twins)."""
    *lead, levels, glwe_size, _, n = ggsw.data.shape
    P = external_product_num_primes(n, glwe_size, ggsw.decomp)
    flat = ggsw.data.reshape((-1, levels, glwe_size, glwe_size, n))
    return ggsw_spectra(flat, P).reshape(tuple(lead) + (P, levels * glwe_size, glwe_size, n))


# ---------------------------------------------------------------------------
# vertical packing (reference vertical_packing, wop_pbs/mod.rs:785)
# ---------------------------------------------------------------------------


def cmux_ntt(ct0: GlweCiphertext, ct1: GlweCiphertext, spectra: torch.Tensor,
             decomp: DecompParams) -> GlweCiphertext:
    """ct0 + GGSW [x] (ct1 - ct0) with the GGSW's spectra [..., P, J, R, N]
    (tfhe_tpu wopbs.py:190): one K7 launch."""
    return GlweCiphertext(data=external_product(ct0.data, spectra, decomp, ct1=ct1.data))


def _monomial_div_static(polys: torch.Tensor, degree: int) -> torch.Tensor:
    """X^-degree * polys (negacyclic) for a clear degree (tfhe_tpu
    wopbs.py:197)."""
    return monomial_mul(polys, torch.tensor(-degree, device=polys.device))


def vertical_packing(lut_polys: torch.Tensor, ggsws: List[torch.Tensor], decomp: DecompParams,
                     glwe_dimension: int) -> LweCiphertext:
    """A LUT of 2^t polynomials [2^t, N] evaluated over the bits whose GGSWs'
    spectra are `ggsws` (MSB first; tfhe_tpu wopbs.py:207): a CMux tree over
    the t most significant GGSWs, then a rotation driven by the rest, then
    coefficient 0 extracted.  A tree CMux is K7 with ct1 explicit; a
    rotation step acc + GGSW [x] (X^-m acc - acc) is K7 with the rotated
    operand, e = -m for every row."""
    nb = len(ggsws)
    num_lut = lut_polys.shape[0]
    log_lut = num_lut.bit_length() - 1
    if num_lut != 1 << log_lut:
        raise ValueError(f"a LUT of {num_lut} polynomials: a power of two is needed")
    cmux_count = min(log_lut, nb)
    layers = [trivial_glwe(lut_polys[i], glwe_dimension) for i in range(num_lut)]
    for d in range(cmux_count):
        # the tree takes the MSB GGSWs, the deepest layer the last of them first
        g = ggsws[cmux_count - 1 - d]
        layers = [cmux_ntt(layers[i], layers[i + 1], g, decomp)
                  for i in range(0, len(layers), 2)]
    acc = layers[0]
    monomial = 1
    for g_idx in reversed(range(cmux_count, nb)):
        spectra = ggsws[g_idx]
        acc = GlweCiphertext(data=external_product(
            acc.data, spectra, decomp,
            exps=torch.full(tuple(spectra.shape[:-4]), -monomial, dtype=torch.int64,
                            device=spectra.device)))
        monomial <<= 1
    return sample_extract(acc, 0)


__all__ = ["CbsPfpkskList", "generate_cbs_pfpksk", "private_functional_keyswitch",
           "extract_bits", "homomorphic_shift_boolean", "circuit_bootstrap_boolean",
           "ggsw_to_ntt", "cmux_ntt", "vertical_packing"]
