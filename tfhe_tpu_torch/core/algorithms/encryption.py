"""Key generation, encryption and decryption for LWE, GLWE and GGSW, and the
bootstrap key's conversion into the port's spectra.

Counterpart of `tfhe_tpu/core/algorithms/encryption.py`.  Randomness comes
from explicit `torch.Generator`s (`core/rng.py`); every function runs on the
device of its inputs.  The `*_from_key` twins (and
`generate_packing_keyswitch_key`) take a threefry key instead
(`core/threefry.py`): their masks follow the JAX package's key tree index
for index, so the seeded forms (`seeded.py`) replay them, while their noise
still comes from a torch generator.

Every drawing function takes `log_q` (64, or 32 for the lifted 32-bit
torus, `core/numeric.py`): at 32 the masks and noise are drawn as 32-bit
words and lifted, so the words it returns are the JAX package's at 32 bits
times 2^32.  Plaintexts come in lifted already; the gadget constants
q/B^(l+1) are the same lifted words at both widths.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import config
from .. import rng, threefry
from ..entities import (GlweCiphertext, GlweSecretKey, LweBootstrapKey,
                        LweCiphertext, LweKeyswitchKey, LwePackingKeyswitchKey,
                        LweSecretKey, NttBootstrapKey)
from ..numeric import LOG_Q, as_i64, check_log_q
from ..params import DecompParams
from ..poly import ntt
from .keyswitch import keyswitch_key

# ---------------------------------------------------------------------------
# secret keys
# ---------------------------------------------------------------------------


def generate_lwe_secret_key(gen: torch.Generator, lwe_dimension: int) -> LweSecretKey:
    return LweSecretKey(bits=rng.binary_key(gen, (lwe_dimension,)))


def generate_glwe_secret_key(gen: torch.Generator, glwe_dimension: int,
                             polynomial_size: int) -> GlweSecretKey:
    return GlweSecretKey(bits=rng.binary_key(gen, (glwe_dimension, polynomial_size)))


# ---------------------------------------------------------------------------
# LWE
# ---------------------------------------------------------------------------


def _mask_dot_key(mask: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^64 for binary s: a masked wrapping sum."""
    return torch.where(bits != 0, mask, torch.zeros_like(mask)).sum(dim=-1)


def encrypt_lwe_deterministic_mask(mask: torch.Tensor, sk: LweSecretKey,
                                   plaintexts: torch.Tensor,
                                   noise: torch.Tensor) -> torch.Tensor:
    """LWE data [..., n+1] from a given mask [..., n] and noise [...]."""
    body = _mask_dot_key(mask, sk.bits) + plaintexts + noise
    return torch.cat([mask, body.unsqueeze(-1)], dim=-1)


def encrypt_lwe(gen: torch.Generator, sk: LweSecretKey, plaintexts: torch.Tensor,
                noise_std: float, log_q: int = LOG_Q) -> LweCiphertext:
    """Torus plaintexts [...] → LweCiphertext [..., n+1]."""
    shape = tuple(plaintexts.shape)
    mask = rng.uniform_torus(gen, shape + (sk.lwe_dimension,), log_q=log_q)
    noise = rng.gaussian_noise(gen, shape, noise_std, log_q=log_q)
    return LweCiphertext(data=encrypt_lwe_deterministic_mask(
        mask, sk, plaintexts, noise))


def encrypt_lwe_from_key(key: torch.Tensor, gen: torch.Generator, sk: LweSecretKey,
                         plaintexts: torch.Tensor, noise_std: float,
                         log_q: int = LOG_Q) -> LweCiphertext:
    """`encrypt_lwe` with the mask of tfhe_tpu encrypt_lwe(key, ...): the
    words of split(key)[0] over plaintexts.shape + (n,)."""
    mask = threefry.uniform_torus(threefry.split(key)[..., 0, :],
                                  tuple(plaintexts.shape) + (sk.lwe_dimension,), log_q=log_q)
    noise = rng.gaussian_noise(gen, tuple(plaintexts.shape), noise_std, log_q=log_q)
    return LweCiphertext(data=encrypt_lwe_deterministic_mask(mask, sk, plaintexts, noise))


def decrypt_lwe(ct: LweCiphertext, sk: LweSecretKey) -> torch.Tensor:
    """Phase b - <a, s> (message + noise), int64 torus."""
    return ct.body - _mask_dot_key(ct.mask, sk.bits)


def trivial_lwe(plaintexts: torch.Tensor, lwe_dimension: int) -> LweCiphertext:
    """Noiseless LWE [..., n+1] with a zero mask and the plaintexts as body."""
    mask = torch.zeros(tuple(plaintexts.shape) + (lwe_dimension,), dtype=torch.int64,
                       device=plaintexts.device)
    return LweCiphertext(data=torch.cat([mask, plaintexts.unsqueeze(-1)], dim=-1))


# ---------------------------------------------------------------------------
# GLWE
# ---------------------------------------------------------------------------


def _glwe_mask_dot_key(mask: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """sum_i a_i * s_i over Z_q[X]/(X^N+1) for binary key polys, exact via
    CRT-NTT.  mask [..., k, N], bits [k, N] → [..., N]."""
    n, k = mask.shape[-1], bits.shape[-2]
    log_bound = LOG_Q + np.log2(n) + np.log2(max(k, 1))
    plan = ntt.get_plan(n, ntt.required_num_primes(log_bound, n))
    p = plan.tables(mask.device)["p"]
    m_hat = ntt.ntt_forward(plan, ntt.reduce(plan, mask))     # [..., k, P, N]
    s_hat = ntt.ntt_forward(plan, ntt.reduce(plan, bits))     # [k, P, N]
    acc = (m_hat * s_hat % p).sum(dim=-3) % p
    return ntt.garner_to_torus(plan, ntt.ntt_inverse(plan, acc))


def encrypt_glwe_deterministic_mask(mask: torch.Tensor, sk: GlweSecretKey,
                                    plaintext_polys: torch.Tensor,
                                    noise: torch.Tensor) -> torch.Tensor:
    """GLWE data [..., k+1, N] from a given mask [..., k, N] and noise."""
    body = _glwe_mask_dot_key(mask, sk.bits) + plaintext_polys + noise
    return torch.cat([mask, body.unsqueeze(-2)], dim=-2)


def encrypt_glwe(gen: torch.Generator, sk: GlweSecretKey,
                 plaintext_polys: torch.Tensor, noise_std: float,
                 log_q: int = LOG_Q) -> GlweCiphertext:
    """plaintext_polys [..., N] → GlweCiphertext [..., k+1, N]."""
    k, n = sk.glwe_dimension, sk.polynomial_size
    lead = tuple(plaintext_polys.shape[:-1])
    mask = rng.uniform_torus(gen, lead + (k, n), log_q=log_q)
    noise = rng.gaussian_noise(gen, lead + (n,), noise_std, log_q=log_q)
    return GlweCiphertext(data=encrypt_glwe_deterministic_mask(
        mask, sk, plaintext_polys, noise))


def encrypt_glwe_from_key(key: torch.Tensor, gen: torch.Generator, sk: GlweSecretKey,
                          plaintext_polys: torch.Tensor, noise_std: float) -> GlweCiphertext:
    """`encrypt_glwe` with the mask of tfhe_tpu encrypt_glwe(key, ...): the
    words of split(key)[0] over plaintext_polys.shape[:-1] + (k, N)."""
    k, n = sk.glwe_dimension, sk.polynomial_size
    lead = tuple(plaintext_polys.shape[:-1])
    mask = threefry.uniform_torus(threefry.split(key)[..., 0, :], lead + (k, n))
    noise = rng.gaussian_noise(gen, lead + (n,), noise_std)
    return GlweCiphertext(data=encrypt_glwe_deterministic_mask(
        mask, sk, plaintext_polys, noise))


def decrypt_glwe(ct: GlweCiphertext, sk: GlweSecretKey) -> torch.Tensor:
    """Phase polynomials body - sum_i a_i * s_i, int64 [..., N]."""
    return ct.body - _glwe_mask_dot_key(ct.mask, sk.bits)


def trivial_glwe(plaintext_polys: torch.Tensor, glwe_dimension: int) -> GlweCiphertext:
    lead = tuple(plaintext_polys.shape[:-1])
    mask = torch.zeros(lead + (glwe_dimension, plaintext_polys.shape[-1]),
                       dtype=torch.int64, device=plaintext_polys.device)
    return GlweCiphertext(data=torch.cat([mask, plaintext_polys.unsqueeze(-2)], dim=-2))


# ---------------------------------------------------------------------------
# GGSW and bootstrap key
# ---------------------------------------------------------------------------


def ggsw_plaintexts(msg: torch.Tensor, sk: GlweSecretKey,
                    decomp: DecompParams) -> torch.Tensor:
    """Plaintext rows of GGSW(msg) for a batch of small integers msg [...]:
    [..., l, k+1, N].  Row (l, r<k) holds -m*g_l*s_r, the last row the
    constant m*g_l, with g_l = q/B^(l+1) (tfhe_tpu encrypt_constant_ggsw)."""
    k, n = sk.glwe_dimension, sk.polynomial_size
    levels = decomp.level
    g = torch.tensor([as_i64(1 << (LOG_Q - decomp.base_log * (l + 1)))
                      for l in range(levels)], dtype=torch.int64, device=msg.device)
    lvl = msg.unsqueeze(-1) * g                                  # [..., l]
    pts = torch.zeros(tuple(msg.shape) + (levels, k + 1, n), dtype=torch.int64,
                      device=msg.device)
    pts[..., :k, :] = -(lvl[..., None, None] * sk.bits)
    pts[..., k, 0] = lvl
    return pts


def encrypt_constant_ggsw(gen: torch.Generator, sk: GlweSecretKey,
                          msg: torch.Tensor, decomp: DecompParams,
                          noise_std: float, log_q: int = LOG_Q) -> torch.Tensor:
    """GGSW encryptions of a batch of small integers msg [...]: data
    [..., l, k+1, k+1, N], every row a GLWE encryption of its plaintext
    row (tfhe_tpu encrypt_constant_ggsw, batched)."""
    return encrypt_glwe(gen, sk, ggsw_plaintexts(msg, sk, decomp), noise_std, log_q).data


def ggsw_masks_from_key(keys: torch.Tensor, levels: int, glwe_size: int, n_poly: int,
                        out: torch.Tensor | None = None, log_q: int = LOG_Q) -> torch.Tensor:
    """The GLWE masks of tfhe_tpu encrypt_constant_ggsw(key, ...) under each
    key of keys [..., 2]: row r of the GGSW takes split(key, l*(k+1))[r], its
    mask split(that)[0] over (k, N) → [..., l, k+1, k, N] (into `out`, a view
    of that shape, if given)."""
    k = glwe_size - 1
    lead = tuple(keys.shape[:-1])
    mask_keys = threefry.split(threefry.split(keys, levels * glwe_size))[..., 0, :]
    if out is not None:
        out = out.view(lead + (levels * glwe_size, k, n_poly))
    masks = threefry.uniform_torus(mask_keys, (k, n_poly), out=out, log_q=log_q)
    return masks.view(lead + (levels, glwe_size, k, n_poly))


def encrypt_constant_ggsw_from_key(keys: torch.Tensor, gen: torch.Generator,
                                   sk: GlweSecretKey, msg: torch.Tensor,
                                   decomp: DecompParams, noise_std: float,
                                   log_q: int = LOG_Q) -> torch.Tensor:
    """GGSWs of msg [...] each under its key of keys [..., 2], masks as
    tfhe_tpu encrypt_constant_ggsw draws them (`ggsw_masks_from_key`), noise from
    gen: data [..., l, k+1, k+1, N]."""
    k, n = sk.glwe_dimension, sk.polynomial_size
    masks = ggsw_masks_from_key(keys, decomp.level, k + 1, n, log_q=log_q)
    pts = ggsw_plaintexts(msg, sk, decomp)
    noise = rng.gaussian_noise(gen, tuple(pts.shape), noise_std, log_q=log_q)
    return encrypt_glwe_deterministic_mask(masks, sk, pts, noise)


def generate_bootstrap_key(gen: torch.Generator, lwe_sk: LweSecretKey,
                           glwe_sk: GlweSecretKey, decomp: DecompParams,
                           noise_std: float, log_q: int = LOG_Q) -> LweBootstrapKey:
    """One GGSW(s_i) of the GLWE key per input LWE key bit, all encrypted in
    one batched call: data [n, l, k+1, k+1, N]."""
    return LweBootstrapKey(data=encrypt_constant_ggsw(gen, glwe_sk, lwe_sk.bits,
                                                      decomp, noise_std, log_q),
                           decomp=decomp)


def generate_bootstrap_key_from_key(key: torch.Tensor, gen: torch.Generator,
                                    lwe_sk: LweSecretKey, glwe_sk: GlweSecretKey,
                                    decomp: DecompParams, noise_std: float,
                                    log_q: int = LOG_Q) -> LweBootstrapKey:
    """`generate_bootstrap_key` with the masks of tfhe_tpu
    generate_bootstrap_key(key, ...): input bit i's GGSW under
    split(key, n)[i]."""
    keys = threefry.split(key, lwe_sk.lwe_dimension)
    return LweBootstrapKey(data=encrypt_constant_ggsw_from_key(
        keys, gen, glwe_sk, lwe_sk.bits, decomp, noise_std, log_q), decomp=decomp)


def ggsw_spectra(data: torch.Tensor, num_primes: int) -> torch.Tensor:
    """Standard GGSWs [m, l, k+1, k+1, N] → the port's spectra
    [m, P, l*(k+1), k+1, N] int32.  Coefficients enter as signed
    representatives, in chunks of GGSWs to bound memory."""
    n_in, levels, glwe_size, _, n = data.shape
    plan = ntt.get_plan(n, num_primes)
    spectra = torch.empty((n_in, num_primes, levels * glwe_size, glwe_size, n),
                          dtype=torch.int32, device=data.device)
    chunk = max(1, (1 << 22) // (levels * glwe_size * glwe_size * n * num_primes))
    for start in range(0, n_in, chunk):
        part = data[start:start + chunk]
        hat = ntt.ntt_forward(plan, ntt.reduce(plan, part))    # [c, l, row, comp, P, N]
        hat = hat.permute(0, 4, 1, 2, 3, 5).reshape(
            part.shape[0], num_primes, levels * glwe_size, glwe_size, n)
        spectra[start:start + chunk] = hat.to(torch.int32)
    return spectra


def key_route(n: int) -> str:
    """The route a classic key of polynomial size n converted now is
    recorded for, from the switches (tfhe_tpu encryption.py:209-231: MXU
    off gives the paired "dif" key, lanes below N = 16384 the
    "fourstep-lanes" key, else "fourstep")."""
    if not config.use_mxu_ntt():
        return "paired"
    return "steps" if config.use_mxu_lanes() and n < 16384 else "fused"


def bootstrap_key_to_ntt(bsk: LweBootstrapKey, num_primes: int,
                         log_q: int = LOG_Q) -> NttBootstrapKey:
    """Standard BSK → the port's spectra [n, P, l*(k+1), k+1, N] int32
    (counterpart of tfhe_tpu bootstrap_key_to_ntt), recording the route the
    switches choose now; the paired route gets the paired form.  A lifted
    32-bit key (log_q = 32) takes the "rotate" route whatever the switches:
    the JAX package runs that torus on its XLA rotate-subtract rotation,
    which the delta forms differ from in low bits (ROADMAP C4)."""
    n = bsk.data.shape[-1]
    route = "rotate" if check_log_q(log_q) == 32 else key_route(n)
    key = NttBootstrapKey(spectra=ggsw_spectra(bsk.data, num_primes), decomp=bsk.decomp,
                          primes=ntt.get_plan(n, num_primes).primes)
    if route == "paired":
        return bootstrap_key_to_ntt_paired(key)
    return dataclasses.replace(key, route=route)


def trivial_ggsw_one_ntt(n: int, glwe_size: int, decomp: DecompParams,
                         num_primes: int) -> torch.Tensor:
    """Residues of the *trivial* GGSW of 1 (the gadget matrix): row (l, r)
    holds the constant polynomial q/B^(l+1) at component r, whose spectrum
    is that constant in every slot, in any spectral order.  [P, l*(k+1),
    k+1, N] int64 (tfhe_tpu encryption.py:235)."""
    plan = ntt.get_plan(n, num_primes)
    out = torch.zeros((num_primes, decomp.level * glwe_size, glwe_size, n),
                      dtype=torch.int64)
    for l in range(decomp.level):
        gs = as_i64(1 << (LOG_Q - decomp.base_log * (l + 1)))  # signed representative
        for r in range(glwe_size):
            for pi, p in enumerate(plan.primes):
                out[pi, l * glwe_size + r, r, :] = gs % p
    return out


def bootstrap_key_to_ntt_paired(key: NttBootstrapKey) -> NttBootstrapKey:
    """A classic key → its paired form: spectra [n, 2, P, J, R, N] of
    pair0 = GGSW_trivial(1) - GGSW(s_i) = GGSW(1 - s_i) and pair1 = GGSW(s_i)
    (tfhe_tpu encryption.py:254).  A paired step computes
    acc <- (pair0 + X^a pair1) [x] acc, the multi-bit step with g = 1."""
    if key.paired:
        return key
    n_in, P, J, R, n = key.spectra.shape
    p = torch.tensor(ntt.get_plan(n, P).primes, dtype=torch.int64,
                     device=key.spectra.device).reshape(P, 1, 1, 1)
    g1 = trivial_ggsw_one_ntt(n, R, key.decomp, P).to(key.spectra.device)
    pair1 = key.spectra.to(torch.int64)
    pair0 = (g1 + p - pair1) % p
    spectra = torch.stack([pair0, pair1], dim=1).to(torch.int32)
    return dataclasses.replace(key, spectra=spectra, route="paired")


# ---------------------------------------------------------------------------
# keyswitch key
# ---------------------------------------------------------------------------


def _gadget_plaintexts(bits: torch.Tensor, decomp: DecompParams) -> torch.Tensor:
    """bits [n] → [n, l]: bits[i] * q/B^(l+1)."""
    g = torch.tensor([as_i64(1 << (LOG_Q - decomp.base_log * (l + 1)))
                      for l in range(decomp.level)], dtype=torch.int64, device=bits.device)
    return bits.unsqueeze(-1) * g


def generate_keyswitch_key(gen: torch.Generator, in_sk: LweSecretKey,
                           out_sk: LweSecretKey, decomp: DecompParams,
                           noise_std: float, log_q: int = LOG_Q) -> LweKeyswitchKey:
    """KSK[i, l] = LWE_out(s_in[i] * q/B^(l+1)), data [n_in, l, n_out+1]."""
    pts = _gadget_plaintexts(in_sk.bits, decomp)
    return keyswitch_key(encrypt_lwe(gen, out_sk, pts, noise_std, log_q).data, decomp)


def generate_keyswitch_key_from_key(key: torch.Tensor, gen: torch.Generator,
                                    in_sk: LweSecretKey, out_sk: LweSecretKey,
                                    decomp: DecompParams, noise_std: float,
                                    log_q: int = LOG_Q) -> LweKeyswitchKey:
    """`generate_keyswitch_key` with the mask of tfhe_tpu
    generate_keyswitch_key(key, ...): one encrypt_lwe over [n_in, l]."""
    pts = _gadget_plaintexts(in_sk.bits, decomp)
    return keyswitch_key(encrypt_lwe_from_key(key, gen, out_sk, pts, noise_std, log_q).data,
                         decomp)


def generate_packing_keyswitch_key(key: torch.Tensor, gen: torch.Generator,
                                   in_sk: LweSecretKey, out_sk: GlweSecretKey,
                                   decomp: DecompParams,
                                   noise_std: float) -> LwePackingKeyswitchKey:
    """PKSK[i, l] = GLWE_out(s_in[i] * q/B^(l+1) as a constant polynomial),
    data [n_in, l, k+1, N], masks as tfhe_tpu
    generate_packing_keyswitch_key(key, ...) draws them (one encrypt_glwe
    over the [n_in, l, N] plaintexts), noise from gen."""
    pts = torch.zeros((in_sk.lwe_dimension, decomp.level, out_sk.polynomial_size),
                      dtype=torch.int64, device=in_sk.bits.device)
    pts[..., 0] = _gadget_plaintexts(in_sk.bits, decomp)
    return LwePackingKeyswitchKey(
        data=encrypt_glwe_from_key(key, gen, out_sk, pts, noise_std).data, decomp=decomp)
