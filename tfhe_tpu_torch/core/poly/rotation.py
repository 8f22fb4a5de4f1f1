"""The whole blind rotation (delta form), with the rotation itself as the
CUDA kernel K1.

Counterpart of `tfhe_tpu/core/poly/pallas_ntt.py:1537 blind_rotate_fused`
with mode="delta": the modulus switch and the LUT pre-rotation are torch
glue here, as they are XLA glue there; `rotate_accumulator` runs every step

    acc += (X^e_j - 1) * sum_{l,r} decomp_l(acc_r) * GGSW(s_j)[l, r]

in `csrc/rotation.cu` (replacing `_make_rotation_kernel_mxu`, :1073; the
kernel's header says what bounds it on the card and what its design does
about that), with `blind_rotate_plain` beside it.  Both compute the exact
product mod 2^64, so both are bit-identical to the JAX function.  The JAX
wrapper's batch bucketing (`_padded_flat_batch`) only caps TPU compiles and
has no counterpart: the kernel takes any batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import cuda_lib
from ..decomposition import signed_decompose
from ..entities import NttBootstrapKey
from ..numeric import LOG_Q, shr
from . import monomial_mul, ntt

# Kernel launches of `rotate_accumulator` (the CUDA branch only).
launches = 0

_MAXP = 8
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


def blind_rotate_plain(acc: torch.Tensor, exps: torch.Tensor,
                       key: NttBootstrapKey) -> torch.Tensor:
    """K1's plain version.  acc [B, R, N] int64 (pre-rotated LUT), exps
    [B, n] integers in [0, 2N), key spectra [n, P, J, R, N] → rotated acc."""
    n_steps, P, J, R, n = key.spectra.shape
    plan = ntt.get_plan(n, P)
    tab = plan.tables(acc.device)
    p = tab["p"]                                                 # [P, 1]
    B, L = acc.shape[0], key.decomp.level
    # (X^e - 1) at slot k is psi^(e * (2 brv(k) + 1) mod 2N) - 1
    phase_tab = (tab["psi_pow"] - 1) % p                         # [P, 2N]
    exps = exps.to(torch.int64)
    for j in range(n_steps):
        digits = signed_decompose(acc, key.decomp)               # [B, R, N, L]
        digits = digits.permute(0, 3, 1, 2).reshape(B, L * R, n)  # row l*R + r
        d_hat = ntt.ntt_forward(plan, ntt.reduce(plan, digits))  # [B, J, P, N]
        spec = key.spectra[j].to(torch.int64)                    # [P, J, R, N]
        prod = d_hat.transpose(1, 2).unsqueeze(-2) * spec % p.unsqueeze(-1).unsqueeze(-1)
        mac = prod.sum(dim=2) % p.unsqueeze(-1)                  # [B, P, R, N]
        m = exps[:, j, None] * tab["slot_odd"] % (2 * n)        # [B, N]
        phase = phase_tab[:, m].permute(1, 0, 2)                 # [B, P, N]
        mac = mac * phase.unsqueeze(-2) % p.unsqueeze(-1)
        delta = ntt.garner_to_torus(plan, ntt.ntt_inverse(plan, mac.transpose(1, 2)))
        acc = acc + delta                                        # [B, R, N]
    return acc


def _shoup_u32(vals: np.ndarray, p: np.ndarray) -> np.ndarray:
    return ((vals.astype(object) << 32) // p.astype(object)).astype(np.uint64)


def _kernel_tables(plan: ntt.NttPlan, device) -> tuple:
    """(tab, consts) for csrc/rotation.cu, cached per plan and device:
    tab u32 [psi_rev, twin, psi_inv_rev, twin] [P, N] then
    [phase, twin] [P, 2N] with phase[m] = (psi^m - 1)/N mod p; consts the
    u64 layout of the kernel's C_* enum."""
    dkey = (plan.n, plan.num_primes, str(torch.device(device)))
    if dkey not in _TABLES:
        P, n = plan.num_primes, plan.n
        assert P <= _MAXP
        p = plan.p64                                             # [P, 1]
        n_inv = np.array(plan.n_inv, dtype=np.int64).reshape(-1, 1)
        phase = (plan.psi_pow - 1) % p * n_inv % p
        parts = []
        for vals in (plan.psi_rev, plan.psi_inv_rev, phase):
            parts += [vals.astype(np.uint64), _shoup_u32(vals, p)]
        tab = np.concatenate([a.reshape(-1) for a in parts]).astype(np.uint32)
        cs = np.zeros(177, dtype=np.uint64)
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
        cs[176] = plan.M_mod
        _TABLES[dkey] = (torch.from_numpy(tab.view(np.int32).copy()).to(device),
                         torch.from_numpy(cs.view(np.int64).copy()).to(device))
    return _TABLES[dkey]


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
    B = acc.shape[0]
    L, base_log = key.decomp.level, key.decomp.base_log
    if key.order != "ct-bitrev":
        raise ValueError(f"the kernel reads ct-bitrev spectra, not {key.order!r}")
    if acc.shape != (B, R, n) or exps.shape != (B, n_steps) or J != L * R:
        raise ValueError(f"shapes acc {tuple(acc.shape)}, exps {tuple(exps.shape)}, "
                         f"key {tuple(key.spectra.shape)} disagree")
    if acc.dtype != torch.int64 or key.spectra.dtype != torch.int32:
        raise TypeError("acc must be int64 and the key spectra int32")
    if key.spectra.device != acc.device or exps.device != acc.device:
        raise ValueError("all operands must be on one device")
    if P > _MAXP or J > 15 or base_log > 24:
        raise ValueError(f"the kernel takes P <= {_MAXP}, J <= 15, base_log <= 24")
    smem = 8 * R * n + 4 * J * n + 4 * P * R * n
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a ciphertext's working set ({smem} B) exceeds one "
                         f"block's shared memory ({_SMEM_LIMIT} B)")
    plan = ntt.get_plan(n, P)
    if tuple(key.primes) != plan.primes:
        raise ValueError("key primes differ from primes_for(N)[:P]")
    tab, cs = _kernel_tables(plan, acc.device)
    out = acc.contiguous().clone()
    e32 = exps.to(torch.int32).contiguous()
    spectra = key.spectra.contiguous()
    lib = cuda_lib.library()
    code = lib.tfhe_blind_rotate(out.data_ptr(), e32.data_ptr(), spectra.data_ptr(),
                                 tab.data_ptr(), cs.data_ptr(), B, n_steps, n,
                                 n.bit_length() - 1, P, R, L, base_log,
                                 cuda_lib.stream_of(out))
    launches += 1
    cuda_lib.check(code, "tfhe_blind_rotate")
    return out


def blind_rotate_fused(lut_data: torch.Tensor, lwe_data: torch.Tensor,
                       key: NttBootstrapKey) -> torch.Tensor:
    """Full blind rotation.  lut_data: shared [R, N] or per-element
    [..., R, N] LUT(s); lwe_data [..., n+1].  Returns the rotated
    accumulator [..., R, N] int64."""
    n = key.polynomial_size
    batch = tuple(lwe_data.shape[:-1])
    flat = lwe_data.reshape(-1, lwe_data.shape[-1])
    switched = modulus_switch(flat, n)                           # [B, n+1] in [0, 2N]
    exps = switched[:, :-1] & (2 * n - 1)
    acc = monomial_mul(_lut_full(lut_data, batch, flat.shape[0]),
                       (2 * n - switched[:, -1]).unsqueeze(-1))
    out = rotate_accumulator(acc, exps, key)
    return out.reshape(batch + tuple(out.shape[-2:]))
