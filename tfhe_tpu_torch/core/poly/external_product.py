"""K7: the external product outside a blind rotation, with a GGSW per row.

    out = ct0 + GGSW [x] op,   op = ct1 - ct0               (explicit operand)
                            or op = X^e * ct0 - ct0          (rotated operand)

Counterpart of the XLA `external_product_accumulate`
(`tfhe_tpu/core/algorithms/bootstrap.py:50-77`) as the JAX package's `cmux`,
`cmux_ntt` (`wopbs.py:190`: the WoP-PBS's CMux tree and its GGSW-driven
rotation) and `blind_rotate` (`blind_rotate_only`) run it: the operand is
decomposed as a torus difference, so every result is bit-identical to the
JAX function's.  The GGSW comes as the port's spectra [P, J, R, N] int32
(`encryption.ggsw_spectra`), one shared by the batch or one per row
[..., P, J, R, N].  The kernel is `csrc/external_product.cu`
(`tfhe_external_product`); `external_product_plain` beside it is the plain
version, from rotation.py's `_digit_spectra` and `_mac`.  The wrapper takes
the plain version for CPU tensors and launches K7 (or raises: there is no
fallback) for CUDA tensors.
"""
from __future__ import annotations

import torch

from ... import cuda_lib
from . import monomial_mul, monomial_mul128, ntt
from .rotation import _digit_spectra, _kernel_tables, _mac

# K7's and K8's launches, counted by each wrapper's CUDA branch only.
launches = 0
launches128 = 0


def _batch(ct0, ct1, exps, spectra) -> tuple:
    """The broadcast batch shape of the operands' leading axes."""
    shapes = [ct0.shape[:-2], spectra.shape[:-4]]
    if ct1 is not None:
        shapes.append(ct1.shape[:-2])
    if exps is not None:
        shapes.append(exps.shape)
    return tuple(torch.broadcast_shapes(*shapes))


def _check(ct0, spectra, decomp, ct1, exps) -> tuple:
    """(batch, P, J, R, N) after the checks every caller's operands pass."""
    if (ct1 is None) == (exps is None):
        raise ValueError("give the explicit operand ct1 or the rotation exponents exps, "
                         "not both and not neither")
    P, J, R, n = spectra.shape[-4:]
    if tuple(ct0.shape[-2:]) != (R, n) or J != decomp.level * R:
        raise ValueError(f"shapes ct0 {tuple(ct0.shape)} and GGSW spectra "
                         f"{tuple(spectra.shape)} disagree with L = {decomp.level}")
    if ct1 is not None and tuple(ct1.shape[-2:]) != (R, n):
        raise ValueError(f"ct1 {tuple(ct1.shape)} is not [..., {R}, {n}]")
    return _batch(ct0, ct1, exps, spectra), P, J, R, n


def external_product_plain(ct0: torch.Tensor, spectra: torch.Tensor, decomp,
                           ct1: torch.Tensor | None = None,
                           exps: torch.Tensor | None = None) -> torch.Tensor:
    """K7's plain version on any device: ct0 [..., R, N] int64, spectra
    [..., P, J, R, N] (residues mod primes_for(N)[:P], ct-bitrev order),
    and ct1 [..., R, N] or exps [...] integers (X^e, any sign) → [batch, R,
    N] int64, the batch the leading axes broadcast to."""
    if exps is not None:
        exps = torch.as_tensor(exps, device=ct0.device).to(torch.int64)
    batch, P, J, R, n = _check(ct0, spectra, decomp, ct1, exps)
    c0 = ct0.expand(batch + (R, n)).reshape(-1, R, n)
    if ct1 is not None:
        op = ct1.expand(batch + (R, n)).reshape(-1, R, n) - c0
    else:
        op = monomial_mul(c0, exps.expand(batch).reshape(-1, 1)) - c0
    plan = ntt.get_plan(n, P)
    p = plan.tables(ct0.device)["p"]
    spec = spectra.expand(batch + (P, J, R, n)).reshape(-1, P, J, R, n) \
        if spectra.dim() > 4 else spectra
    mac = _mac(_digit_spectra(op, decomp, plan), spec, p)          # [B, P, R, N]
    out = c0 + ntt.garner_to_torus(plan, ntt.ntt_inverse(plan, mac.transpose(1, 2)))
    return out.reshape(batch + (R, n))


def _rows(t: torch.Tensor, batch: tuple, tail: tuple) -> tuple:
    """(rows [B, *tail] or one row [*tail], row stride in elements): a tensor
    with one row is read for every row of the batch (stride 0), any other is
    broadcast to the batch; each row contiguous."""
    if t.shape[:t.dim() - len(tail)].numel() == 1:
        return t.reshape(tail).contiguous(), 0
    rows = t.expand(batch + tail).reshape((-1,) + tail)
    if not rows[0].is_contiguous():
        rows = rows.contiguous()
    return rows, rows.stride(0)


def external_product(ct0: torch.Tensor, spectra: torch.Tensor, decomp,
                     ct1: torch.Tensor | None = None,
                     exps: torch.Tensor | None = None) -> torch.Tensor:
    """K7's wrapper: ct0 + GGSW [x] (ct1 - ct0), or with exps, ct0 + GGSW
    [x] (X^e * ct0 - ct0); arguments and result as
    `external_product_plain`'s.  The plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (or an error: there is no fallback).  A GGSW or
    a ct0 without a batch of its own is read once for every row."""
    if ct0.device.type == "cpu":
        return external_product_plain(ct0, spectra, decomp, ct1, exps)
    if ct0.device.type != "cuda":
        raise ValueError(f"no external-product kernel for device {ct0.device}")
    if exps is not None:
        exps = torch.as_tensor(exps, device=ct0.device).to(torch.int64)
    batch, P, J, R, n = _check(ct0, spectra, decomp, ct1, exps)
    if ct0.dtype != torch.int64 or (ct1 is not None and ct1.dtype != torch.int64):
        raise TypeError("ct0 and ct1 must be int64 torus tensors")
    if spectra.dtype != torch.int32:
        raise TypeError("the GGSW spectra must be int32")
    if not 1 <= decomp.base_log <= 30 or decomp.base_log * decomp.level > 64:
        raise ValueError(f"K7 takes base_log 1..30 with base_log * level <= 64, not "
                         f"{decomp.base_log} x {decomp.level}")
    if any(t is not None and t.device != ct0.device for t in (spectra, ct1)):
        raise ValueError("all operands must be on one device")
    B = max(1, torch.Size(batch).numel())
    c0, s0 = _rows(ct0, batch, (R, n))
    key, sk = _rows(spectra, batch, (P, J, R, n))
    c1 = s1 = e32 = None
    se = 0
    if ct1 is not None:
        c1, s1 = _rows(ct1, batch, (R, n))
    else:
        e32 = torch.remainder(exps, 2 * n).to(torch.int32).expand(batch).reshape(-1)
        if e32.numel() == 1:
            e32, se = e32.reshape(1).contiguous(), 0
        else:
            se = e32.stride(0)
    plan = ntt.get_plan(n, P)
    tab, consts = _kernel_tables(plan, ct0.device)
    res = torch.empty((B, P, R, n), dtype=torch.int32, device=ct0.device)
    out = torch.empty((B, R, n), dtype=torch.int64, device=ct0.device)
    global launches
    code = cuda_lib.library().tfhe_external_product(
        c0.data_ptr(), s0, None if c1 is None else c1.data_ptr(), s1 or 0,
        None if e32 is None else e32.data_ptr(), se, key.data_ptr(), sk, tab.data_ptr(),
        consts.data_ptr(), res.data_ptr(), out.data_ptr(), B, n, plan.log_n, P, R,
        decomp.level, decomp.base_log, cuda_lib.stream_of(ct0))
    launches += 1
    cuda_lib.check(code, "tfhe_external_product")
    return out.reshape(batch + (R, n))


# ---------------------------------------------------------------------------
# K8: K7's rotated form on the 2^128 torus
# ---------------------------------------------------------------------------


def _check128(acc, spectra, decomp, exps) -> tuple:
    """(batch, P, J, R, N) after the checks K8's operands pass on any
    device: acc [..., R, N, 2], spectra [..., P, J, R, N], P <= 7 and
    base_log * level <= 64 (every digit in the high limb)."""
    P, J, R, n = spectra.shape[-4:]
    if acc.dim() < 3 or tuple(acc.shape[-3:]) != (R, n, 2) or J != decomp.level * R:
        raise ValueError(f"shapes acc {tuple(acc.shape)} and GGSW spectra "
                         f"{tuple(spectra.shape)} disagree with L = {decomp.level}")
    if not 1 <= P <= 7:
        raise ValueError(f"K8 lifts over at most the 7 primes of PRIMES_31, not {P}")
    if not 1 <= decomp.base_log <= 30 or decomp.base_log * decomp.level > 64:
        raise ValueError(f"K8 takes base_log 1..30 with base_log * level <= 64, not "
                         f"{decomp.base_log} x {decomp.level}")
    batch = tuple(torch.broadcast_shapes(acc.shape[:-3], spectra.shape[:-4], exps.shape))
    return batch, P, J, R, n


def external_product128_plain(acc: torch.Tensor, spectra: torch.Tensor, decomp,
                              exps: torch.Tensor) -> torch.Tensor:
    """K8's plain version on any device (tfhe_tpu pbs128.py:244
    external_product_accumulate128 on the operand X^e acc - acc): acc
    [..., R, N, 2] int64 limbs (hi, lo), spectra [..., P, J, R, N], exps
    [...] integers → acc + GGSW [x] (X^e acc - acc) mod 2^128, [batch, R,
    N, 2]."""
    from .. import u128
    from ..decomposition import signed_decompose128
    exps = torch.as_tensor(exps, device=acc.device).to(torch.int64)
    batch, P, J, R, n = _check128(acc, spectra, decomp, exps)
    a = acc.expand(batch + (R, n, 2)).reshape(-1, R, n, 2)
    rotated = monomial_mul128(a, exps.expand(batch).reshape(-1, 1))
    op = u128.sub128(rotated, a)
    digits = signed_decompose128(op, decomp)                         # [B, R, N, L]
    digits = digits.permute(0, 3, 1, 2).reshape(-1, J, n)
    plan = ntt.get_plan(n, P)
    p = plan.tables(acc.device)["p"]
    d_hat = ntt.ntt_forward(plan, ntt.reduce(plan, digits)).transpose(1, 2)   # [B, P, J, N]
    spec = spectra.expand(batch + (P, J, R, n)).reshape(-1, P, J, R, n) \
        if spectra.dim() > 4 else spectra
    mac = _mac(d_hat, spec, p)                                       # [B, P, R, N]
    delta = ntt.garner_to_torus128(plan, ntt.ntt_inverse(plan, mac.transpose(1, 2)))
    return u128.add128(a, delta).reshape(batch + (R, n, 2))


def external_product128(acc: torch.Tensor, spectra: torch.Tensor, decomp,
                        exps: torch.Tensor) -> torch.Tensor:
    """K8's wrapper: acc + GGSW [x] (X^e acc - acc) mod 2^128, arguments
    and result as `external_product128_plain`'s.  The plain version for CPU
    tensors, the CUDA kernel for CUDA tensors, an error on any other device
    (there is no fallback).  A GGSW or an acc without a batch of its own is
    read once for every row."""
    if acc.device.type == "cpu":
        return external_product128_plain(acc, spectra, decomp, exps)
    if acc.device.type != "cuda":
        raise ValueError(f"no external-product kernel for device {acc.device}")
    exps = torch.as_tensor(exps, device=acc.device).to(torch.int64)
    batch, P, J, R, n = _check128(acc, spectra, decomp, exps)
    if acc.dtype != torch.int64 or spectra.dtype != torch.int32:
        raise TypeError("acc must be int64 limbs and the GGSW spectra int32")
    if spectra.device != acc.device:
        raise ValueError("all operands must be on one device")
    B = max(1, torch.Size(batch).numel())
    a, sa = _rows(acc, batch, (R, n, 2))
    key, sk = _rows(spectra, batch, (P, J, R, n))
    e32 = torch.remainder(exps, 2 * n).to(torch.int32).expand(batch).reshape(-1)
    if e32.numel() == 1:
        e32, se = e32.reshape(1).contiguous(), 0
    else:
        se = e32.stride(0)
    plan = ntt.get_plan(n, P)
    tab, consts = _kernel_tables(plan, acc.device)
    res = torch.empty((B, P, R, n), dtype=torch.int32, device=acc.device)
    out = torch.empty((B, R, n, 2), dtype=torch.int64, device=acc.device)
    global launches128
    code = cuda_lib.library().tfhe_external_product128(
        a.data_ptr(), sa, e32.data_ptr(), se, key.data_ptr(), sk, tab.data_ptr(),
        consts.data_ptr(), res.data_ptr(), out.data_ptr(), B, n, plan.log_n, P, R,
        decomp.level, decomp.base_log, cuda_lib.stream_of(acc))
    launches128 += 1
    cuda_lib.check(code, "tfhe_external_product128")
    return out.reshape(batch + (R, n, 2))



__all__ = ["external_product", "external_product_plain", "external_product128",
           "external_product128_plain"]
