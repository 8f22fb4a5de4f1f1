"""The whole blind rotation, classic (delta form) and multi-bit, with the
rotation itself as the CUDA kernels K1 and K3.

Counterpart of `tfhe_tpu/core/poly/pallas_ntt.py:1537 blind_rotate_fused`:
the modulus switch, the LUT pre-rotation and the multi-bit variant
exponents are torch glue here, as they are XLA glue there.

  mode="delta" (classic keys): `rotate_accumulator` (K1) runs every step

    acc += (X^e_j - 1) * sum_{l,r} decomp_l(acc_r) * GGSW(s_j)[l, r]

  mode="multibit" (keys of g-bit groups): `rotate_accumulator_multi_bit`
  (K3) runs every step

    acc = sum_{v < 2^g} X^{c_v} * sum_{l,r} decomp_l(acc_r) * GGSW_{j,v}[l, r]

Both kernels are in `csrc/rotation.cu` (replacing `_make_rotation_kernel_mxu`,
:1073; the source's header says what bounds them on the card and what
their design does about that), with `blind_rotate_plain` and
`blind_rotate_multi_bit_plain` beside them.  All compute the exact product
mod 2^64, so all are bit-identical to the JAX function.  The JAX wrapper's
batch bucketing (`_padded_flat_batch`) only caps TPU compiles and has no
counterpart: the kernels take any batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import cuda_lib
from ..decomposition import signed_decompose
from ..entities import NttBootstrapKey, NttMultiBitBootstrapKey
from ..numeric import LOG_Q, shr
from . import monomial_mul, ntt

# Kernel launches of `rotate_accumulator` (K1) and of
# `rotate_accumulator_multi_bit` (K3), the CUDA branches only.
launches = 0
multi_bit_launches = 0

_MAXP = 8
_MAXR = 4              # K3 keeps one 64-bit sum per output component in registers
_SMEM_LIMIT = 232448   # dynamic shared memory one block may use on sm_90
_TABLES: dict = {}     # (N, P, device) → (tab, consts) for csrc/rotation.cu


def modulus_switch(x: torch.Tensor, polynomial_size: int) -> torch.Tensor:
    """Torus → Z_{2N} rounding, values in [0, 2N] (tfhe_tpu
    bootstrap.py:41 modulus_switch; reference fast_pbs_modulus_switch)."""
    log_2n = polynomial_size.bit_length()
    shift = LOG_Q - log_2n - 1
    return shr(shr(x, shift) + 1, 1)


def _lut_full(lut_data: torch.Tensor, batch: tuple, flat_b: int) -> torch.Tensor:
    """Accumulator rows [flat_b, R, N] from a shared [R, N] LUT or per-element
    [..., R, N] LUTs broadcast against the LWE batch (pallas_ntt.py:43)."""
    if lut_data.ndim == 2:
        return lut_data.expand((flat_b,) + tuple(lut_data.shape))
    full = lut_data.expand(tuple(batch) + tuple(lut_data.shape[-2:]))
    return full.reshape((flat_b,) + tuple(lut_data.shape[-2:]))


def _digit_spectra(acc: torch.Tensor, decomp, plan: ntt.NttPlan) -> torch.Tensor:
    """Spectra [B, P, J, N] of the balanced digits of acc [B, R, N]; digit
    (l, r) is row j = l*R + r."""
    B, R, n = acc.shape
    digits = signed_decompose(acc, decomp)                       # [B, R, N, L]
    digits = digits.permute(0, 3, 1, 2).reshape(B, decomp.level * R, n)
    return ntt.ntt_forward(plan, ntt.reduce(plan, digits)).transpose(1, 2)


def blind_rotate_plain(acc: torch.Tensor, exps: torch.Tensor,
                       key: NttBootstrapKey) -> torch.Tensor:
    """K1's plain version.  acc [B, R, N] int64 (pre-rotated LUT), exps
    [B, n] integers in [0, 2N), key spectra [n, P, J, R, N] → rotated acc."""
    n_steps, P, J, R, n = key.spectra.shape
    plan = ntt.get_plan(n, P)
    tab = plan.tables(acc.device)
    p = tab["p"]                                                 # [P, 1]
    # (X^e - 1) at slot k is psi^(e * (2 brv(k) + 1) mod 2N) - 1
    phase_tab = (tab["psi_pow"] - 1) % p                         # [P, 2N]
    exps = exps.to(torch.int64)
    for j in range(n_steps):
        d_hat = _digit_spectra(acc, key.decomp, plan)            # [B, P, J, N]
        spec = key.spectra[j].to(torch.int64)                    # [P, J, R, N]
        prod = d_hat.unsqueeze(-2) * spec % p.unsqueeze(-1).unsqueeze(-1)
        mac = prod.sum(dim=2) % p.unsqueeze(-1)                  # [B, P, R, N]
        m = exps[:, j, None] * tab["slot_odd"] % (2 * n)        # [B, N]
        phase = phase_tab[:, m].permute(1, 0, 2)                 # [B, P, N]
        mac = mac * phase.unsqueeze(-2) % p.unsqueeze(-1)
        delta = ntt.garner_to_torus(plan, ntt.ntt_inverse(plan, mac.transpose(1, 2)))
        acc = acc + delta                                        # [B, R, N]
    return acc


def variant_exponents(exps: torch.Tensor, grouping: int, polynomial_size: int
                      ) -> torch.Tensor:
    """Per-group monomial exponents of the multi-bit step: exps [B, n] in
    [0, 2N) → c [B, n/g, 2^g - 1], c[..., v-1] = sum of the group's
    exponents i with bit (g-1-i) of v set, mod 2N (pallas_ntt.py:1598-1603;
    the MSB of v selects the group's first element)."""
    g = grouping
    sel = torch.tensor([[(v >> (g - 1 - i)) & 1 for i in range(g)]
                        for v in range(1, 1 << g)], dtype=torch.int64,
                       device=exps.device)                       # [V-1, g]
    grp = exps.to(torch.int64).reshape(exps.shape[0], -1, 1, g)   # [B, n/g, 1, g]
    return (grp * sel).sum(dim=-1) % (2 * polynomial_size)


def blind_rotate_multi_bit_plain(acc: torch.Tensor, exps: torch.Tensor,
                                 key: NttMultiBitBootstrapKey) -> torch.Tensor:
    """K3's plain version.  acc [B, R, N] int64 (pre-rotated LUT), exps
    [B, n/g, 2^g - 1] variant exponents (`variant_exponents`), key spectra
    [n/g, 2^g, P, J, R, N] → the rotated acc (each step replaces it)."""
    n_steps, V, P, J, R, n = key.spectra.shape
    plan = ntt.get_plan(n, P)
    tab = plan.tables(acc.device)
    p = tab["p"]                                                 # [P, 1]
    exps = exps.to(torch.int64)
    for j in range(n_steps):
        d_hat = _digit_spectra(acc, key.decomp, plan)
        total = None                                             # [B, P, R, N]
        for v in range(V):
            d = d_hat                                            # [B, P, J, N]
            if v:
                m = exps[:, j, v - 1, None] * tab["slot_odd"] % (2 * n)   # [B, N]
                phase = tab["psi_pow"][:, m].permute(1, 0, 2)    # [B, P, N] = X^{c_v}
                d = d_hat * phase.unsqueeze(2) % p.unsqueeze(-1)
            spec = key.spectra[j, v].to(torch.int64)             # [P, J, R, N]
            prod = d.unsqueeze(-2) * spec % p.unsqueeze(-1).unsqueeze(-1)
            mac = prod.sum(dim=2) % p.unsqueeze(-1)
            total = mac if total is None else (total + mac) % p.unsqueeze(-1)
        acc = ntt.garner_to_torus(plan, ntt.ntt_inverse(plan, total.transpose(1, 2)))
    return acc


def _shoup_u32(vals: np.ndarray, p: np.ndarray) -> np.ndarray:
    return ((vals.astype(object) << 32) // p.astype(object)).astype(np.uint64)


def _kernel_tables(plan: ntt.NttPlan, device) -> tuple:
    """(tab, consts) for csrc/rotation.cu, cached per plan and device:
    tab u32 [psi_rev, twin, psi_inv_rev, twin] [P, N] then
    [phase, twin, pw, twin] [P, 2N] with phase[m] = (psi^m - 1)/N mod p
    (K1's) and pw[m] = psi^m (K3's); consts the u64 layout of the kernel's
    C_* enum."""
    dkey = (plan.n, plan.num_primes, str(torch.device(device)))
    if dkey not in _TABLES:
        P, n = plan.num_primes, plan.n
        assert P <= _MAXP
        p = plan.p64                                             # [P, 1]
        n_inv = np.array(plan.n_inv, dtype=np.int64).reshape(-1, 1)
        phase = (plan.psi_pow - 1) % p * n_inv % p
        parts = []
        for vals in (plan.psi_rev, plan.psi_inv_rev, phase, plan.psi_pow):
            parts += [vals.astype(np.uint64), _shoup_u32(vals, p)]
        tab = np.concatenate([a.reshape(-1) for a in parts]).astype(np.uint32)
        cs = np.zeros(193, dtype=np.uint64)
        for i, pi in enumerate(plan.primes):
            cs[0 + i] = pi
            cs[8 + i] = (1 << 64) // pi
            cs[16 + i] = plan.garner_inv[i]
            cs[24 + i] = (plan.garner_inv[i] << 32) // pi
            for j, w in enumerate(plan.garner_weights[i]):
                cs[32 + 8 * i + j] = w
                cs[96 + 8 * i + j] = (w << 32) // pi
            cs[160 + i] = plan.half_digits[i]
            cs[168 + i] = plan.prefix_mod[i]
            cs[177 + i] = plan.n_inv[i]
            cs[185 + i] = (plan.n_inv[i] << 32) // pi
        cs[176] = plan.M_mod
        _TABLES[dkey] = (torch.from_numpy(tab.view(np.int32).copy()).to(device),
                         torch.from_numpy(cs.view(np.int64).copy()).to(device))
    return _TABLES[dkey]


def _launch_args(acc: torch.Tensor, exps: torch.Tensor, spectra: torch.Tensor,
                 exps_shape: tuple, decomp, primes: tuple, order: str) -> tuple:
    """Checks shared by the kernel wrappers; → (plan, tab, consts, out,
    exps as int32, spectra), all contiguous on acc's device."""
    P, J, R, n = spectra.shape[-4:]
    B = acc.shape[0]
    L, base_log = decomp.level, decomp.base_log
    if order != "ct-bitrev":
        raise ValueError(f"the kernel reads ct-bitrev spectra, not {order!r}")
    if acc.shape != (B, R, n) or tuple(exps.shape) != exps_shape or J != L * R:
        raise ValueError(f"shapes acc {tuple(acc.shape)}, exps {tuple(exps.shape)}, "
                         f"key {tuple(spectra.shape)} disagree")
    if acc.dtype != torch.int64 or spectra.dtype != torch.int32:
        raise TypeError("acc must be int64 and the key spectra int32")
    if spectra.device != acc.device or exps.device != acc.device:
        raise ValueError("all operands must be on one device")
    if P > _MAXP or J > 15 or base_log > 24:
        raise ValueError(f"the kernel takes P <= {_MAXP}, J <= 15, base_log <= 24")
    smem = 8 * R * n + 4 * J * n + 4 * P * R * n
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a ciphertext's working set ({smem} B) exceeds one "
                         f"block's shared memory ({_SMEM_LIMIT} B)")
    plan = ntt.get_plan(n, P)
    if tuple(primes) != plan.primes:
        raise ValueError("key primes differ from primes_for(N)[:P]")
    tab, cs = _kernel_tables(plan, acc.device)
    return (plan, tab, cs, acc.contiguous().clone(), exps.to(torch.int32).contiguous(),
            spectra.contiguous())


def rotate_accumulator(acc: torch.Tensor, exps: torch.Tensor,
                       key: NttBootstrapKey) -> torch.Tensor:
    """K1's wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (or an error: there is no fallback).  Returns a new
    rotated accumulator [B, R, N] int64."""
    if acc.device.type == "cpu":
        return blind_rotate_plain(acc, exps, key)
    if acc.device.type != "cuda":
        raise ValueError(f"no blind-rotation kernel for device {acc.device}")
    global launches
    n_steps, P, J, R, n = key.spectra.shape
    plan, tab, cs, out, e32, spectra = _launch_args(
        acc, exps, key.spectra, (acc.shape[0], n_steps), key.decomp, key.primes,
        key.order)
    lib = cuda_lib.library()
    code = lib.tfhe_blind_rotate(out.data_ptr(), e32.data_ptr(), spectra.data_ptr(),
                                 tab.data_ptr(), cs.data_ptr(), out.shape[0], n_steps,
                                 n, plan.log_n, P, R, key.decomp.level,
                                 key.decomp.base_log, cuda_lib.stream_of(out))
    launches += 1
    cuda_lib.check(code, "tfhe_blind_rotate")
    return out


def rotate_accumulator_multi_bit(acc: torch.Tensor, exps: torch.Tensor,
                                 key: NttMultiBitBootstrapKey) -> torch.Tensor:
    """K3's wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (or an error: there is no fallback).  exps [B, n/g, 2^g-1]
    from `variant_exponents`.  Returns a new rotated accumulator [B, R, N]."""
    if acc.device.type == "cpu":
        return blind_rotate_multi_bit_plain(acc, exps, key)
    if acc.device.type != "cuda":
        raise ValueError(f"no multi-bit blind-rotation kernel for device {acc.device}")
    global multi_bit_launches
    n_steps, V, P, J, R, n = key.spectra.shape
    g = key.grouping_factor
    if V != 1 << g or not 1 <= g <= 4:
        raise ValueError(f"the kernel takes groupings 1..4 with 2^g variants, not "
                         f"g={g} with {V}")
    if R > _MAXR:
        raise ValueError(f"the multi-bit kernel takes k+1 <= {_MAXR}, not {R}")
    plan, tab, cs, out, e32, spectra = _launch_args(
        acc, exps, key.spectra, (acc.shape[0], n_steps, V - 1), key.decomp,
        key.primes, key.order)
    lib = cuda_lib.library()
    code = lib.tfhe_blind_rotate_multi_bit(
        out.data_ptr(), e32.data_ptr(), spectra.data_ptr(), tab.data_ptr(),
        cs.data_ptr(), out.shape[0], n_steps, n, plan.log_n, P, R, key.decomp.level,
        key.decomp.base_log, g, cuda_lib.stream_of(out))
    multi_bit_launches += 1
    cuda_lib.check(code, "tfhe_blind_rotate_multi_bit")
    return out


def _switch_and_prerotate(lut_data: torch.Tensor, lwe_data: torch.Tensor, n: int):
    """Modulus switch and LUT pre-rotation shared by both rotations →
    (batch shape, mask exponents [B, n_in] in [0, 2N), acc [B, R, N])."""
    batch = tuple(lwe_data.shape[:-1])
    flat = lwe_data.reshape(-1, lwe_data.shape[-1])
    switched = modulus_switch(flat, n)                           # [B, n+1] in [0, 2N]
    exps = switched[:, :-1] & (2 * n - 1)
    acc = monomial_mul(_lut_full(lut_data, batch, flat.shape[0]),
                       (2 * n - switched[:, -1]).unsqueeze(-1))
    return batch, exps, acc


def blind_rotate_fused(lut_data: torch.Tensor, lwe_data: torch.Tensor,
                       key: NttBootstrapKey) -> torch.Tensor:
    """Full blind rotation, classic key (mode="delta").  lut_data: shared
    [R, N] or per-element [..., R, N] LUT(s); lwe_data [..., n+1].  Returns
    the rotated accumulator [..., R, N] int64."""
    batch, exps, acc = _switch_and_prerotate(lut_data, lwe_data, key.polynomial_size)
    out = rotate_accumulator(acc, exps, key)
    return out.reshape(batch + tuple(out.shape[-2:]))


def blind_rotate_fused_multi_bit(lut_data: torch.Tensor, lwe_data: torch.Tensor,
                                 key: NttMultiBitBootstrapKey) -> torch.Tensor:
    """Full blind rotation, multi-bit key (mode="multibit", grouping =
    key.grouping_factor); arguments and result as `blind_rotate_fused`."""
    n = key.polynomial_size
    batch, exps, acc = _switch_and_prerotate(lut_data, lwe_data, n)
    out = rotate_accumulator_multi_bit(
        acc, variant_exponents(exps, key.grouping_factor, n), key)
    return out.reshape(batch + tuple(out.shape[-2:]))
