"""Programmable bootstrapping: modulus switch, blind rotation, sample
extraction, the PBS entry point (classic keys), and the external product
and CMux outside a rotation.

Counterpart of `tfhe_tpu/core/algorithms/bootstrap.py`.  The PBS's blind
rotation is one of the JAX package's kernel routes, chosen as it chooses
them (`config.py`): the fused delta form (K1), the per-step delta form (K4)
or the per-step paired form (K5), never the rotate-subtract form of the JAX
XLA `blind_rotate`, which differs in low bits (hazard C4 in ROADMAP.md).
`blind_rotate_only` is that rotate-subtract form (the JAX function runs
it), on K7 one step a launch, as are `external_product_accumulate` and
`cmux` (`core/poly/external_product.py`); it is also the PBS of a lifted
32-bit key (route "rotate"), whose torus the JAX package serves on XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import config
from ..entities import GlweCiphertext, LweCiphertext, NttBootstrapKey
from ..params import DecompParams
from ..poly.ntt import required_num_primes
from ..poly.external_product import external_product
from ..poly.rotation import (_switch_and_prerotate, blind_rotate_fused, blind_rotate_steps,
                             modulus_switch)

__all__ = ["external_product_num_primes", "modulus_switch", "sample_extract",
           "programmable_bootstrap", "external_product_accumulate", "cmux",
           "blind_rotate_only"]


def external_product_num_primes(n: int, glwe_size: int, decomp: DecompParams,
                                log_q: int = 64) -> int:
    """CRT width for the external-product MAC: per output coefficient the
    integer convolution is bounded by N * J * B/2 * 2^log_q."""
    j = decomp.level * glwe_size
    log_bound = np.log2(n) + np.log2(j) + (decomp.base_log - 1) + log_q
    return required_num_primes(log_bound, n)


def sample_extract(glwe: GlweCiphertext, index: int = 0) -> LweCiphertext:
    """Coefficient `index` as an LWE ciphertext under the flattened GLWE key:
    a_{i*N + j} = mask_i[index - j] for j <= index, -mask_i[N + index - j]
    for j > index; body = body_poly[index]."""
    n = glwe.polynomial_size
    j = torch.arange(n, device=glwe.data.device)
    src = torch.remainder(index - j, n)
    rows = glwe.mask[..., :, src]                            # [..., k, N]
    rows = torch.where(j > index, -rows, rows)
    flat = rows.reshape(tuple(rows.shape[:-2]) + (-1,))
    body = glwe.body[..., index]
    return LweCiphertext(data=torch.cat([flat, body.unsqueeze(-1)], dim=-1))


def programmable_bootstrap(lwe: LweCiphertext, lut: GlweCiphertext,
                           bsk: NttBootstrapKey) -> LweCiphertext:
    """Mod-switch → blind rotate → sample-extract coefficient 0.  The
    rotation routes as tfhe_tpu bootstrap.py:148-165 does: a key converted
    for the fused route runs K1 while `use_fused_rotation()` is on; a
    lifted 32-bit key ("rotate") runs the rotate-subtract form, one K7
    launch a step (`blind_rotate_only`), as the JAX package runs that torus
    on its XLA `blind_rotate`; every other key, or a fused key with the
    switch off, runs one step per launch (`blind_rotate_steps`: K4, or K5
    for a paired key)."""
    if bsk.route == "rotate":
        return sample_extract(blind_rotate_only(lwe, lut, bsk), 0)
    if bsk.route == "fused" and config.use_fused_rotation():
        rotated = blind_rotate_fused(lut.data, lwe.data, bsk)
    else:
        rotated = blind_rotate_steps(lut.data, lwe.data, bsk)
    return sample_extract(GlweCiphertext(data=rotated), 0)


def external_product_accumulate(acc_data: torch.Tensor, operand_data: torch.Tensor,
                                spectra: torch.Tensor, decomp: DecompParams) -> torch.Tensor:
    """acc + GGSW [x] operand (tfhe_tpu bootstrap.py:50): acc_data and
    operand_data [..., k+1, N] int64, the GGSW's spectra [..., P, J, R, N]
    int32 (`encryption.ggsw_spectra`).  K7 with ct1 = acc + operand, whose
    difference with acc is the operand exactly."""
    return external_product(acc_data, spectra, decomp, ct1=acc_data + operand_data)


def cmux(ct0: GlweCiphertext, ct1: GlweCiphertext, spectra: torch.Tensor,
         decomp: DecompParams) -> GlweCiphertext:
    """ct0 + GGSW(b) [x] (ct1 - ct0): ct1 where b = 1 (tfhe_tpu
    bootstrap.py:80; reference fft64/crypto/ggsw.rs:766), one K7 launch."""
    return GlweCiphertext(data=external_product(ct0.data, spectra, decomp, ct1=ct1.data))


def blind_rotate_only(lwe: LweCiphertext, lut: GlweCiphertext,
                      bsk: NttBootstrapKey) -> GlweCiphertext:
    """The PBS without its sample extraction (tfhe_tpu bootstrap.py:170,
    which runs the XLA `blind_rotate`): mod-switch, LUT pre-rotation, then
    per mask element j acc += GGSW(s_j) [x] (X^a_j * acc - acc), one K7
    launch a step (rotated operand, the key's GGSW shared by the batch).
    lut [k+1, N] or [..., k+1, N]; lwe [..., n+1] → [..., k+1, N]."""
    spectra = bsk.spectra[:, 1] if bsk.paired else bsk.spectra     # GGSW(s_j)
    batch, exps, acc = _switch_and_prerotate(lut.data, lwe.data, bsk.polynomial_size)
    for j in range(spectra.shape[0]):
        acc = external_product(acc, spectra[j], bsk.decomp, exps=exps[:, j])
    return GlweCiphertext(data=acc.reshape(batch + tuple(acc.shape[-2:])))
