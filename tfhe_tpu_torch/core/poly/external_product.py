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
(`tfhe_external_product`, and `tfhe_external_product128` for K8 on the
2^128 torus, one template): K1's delta body (csrc/ntt_passes.cuh) run once,
one block a row with the primes in series or a thread block cluster of C
blocks a row with the primes spread over it, as `_ep_layout` picks from the
shape.  `external_product_plain` beside it is the plain version, from
rotation.py's `_digit_spectra` and `_mac`.  The wrapper takes the plain
version for CPU tensors and launches K7 (or raises: there is no fallback)
for CUDA tensors.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ... import cuda_lib
from . import monomial_mul, monomial_mul128, ntt
from .rotation import (_MAXP, _SMEM_LIMIT, _check_shape, _delta_tables, _digit_spectra,
                       _host_consts, _mac, _pack, _pass_schedule)

# K7's and K8's launches, counted by each wrapper's CUDA branch only.
launches = 0
launches128 = 0


_EP_FILL = 264          # blocks that fill the H100 twice over (132 SMs, two blocks a SM)
_EP_MAXCL = 8           # blocks of a cluster, the portable limit
_EP_CONSTS: dict = {}   # (N, P) → the constants K7/K8 take, in host memory


@dataclass(frozen=True)
class EpLayout:
    """How K7/K8 run a batch: a cluster of `cluster` blocks owns a row (1:
    one block, the primes in series), block c of it the primes c, c +
    cluster, ...; each block runs the delta body's passes (`head`, `tail`,
    `log_w`, `rt`: rotation.py `_pass_schedule`) and holds the J digit
    spectra and the R products of its primes and, with `stage`, the
    operand's R N source words (read from device memory by its first prime
    only), `smem` bytes.  The grid is the batch times `cluster` blocks."""
    cluster: int
    stage: bool
    head: tuple
    tail: tuple
    log_w: int
    rt: int
    smem: int

    @property
    def head_code(self) -> int:
        return _pack(self.head)

    @property
    def tail_code(self) -> int:
        return _pack(self.tail)


def _ep_smem(n: int, R: int, J: int, P: int, cluster: int, stage: bool) -> int:
    return 4 * (J + R * (P // cluster)) * n + (8 * R * n if stage else 0)


def _ep_forms(n: int, R: int, J: int, P: int) -> list:
    """Every (cluster, stage) K7/K8 take at this shape: a cluster dividing
    P (at most 8), staged where its blocks run several primes, shared
    memory within one block's."""
    return [(c, st) for c in range(1, min(P, _EP_MAXCL) + 1) if P % c == 0
            for st in ((False, True) if P // c > 1 else (False,))
            if _ep_smem(n, R, J, P, c, st) <= _SMEM_LIMIT]


@functools.lru_cache(maxsize=None)
def _ep_layout(batch: int, n: int, R: int, J: int, P: int, form: tuple | None = None
               ) -> EpLayout:
    """K7/K8's layout for `batch` rows of R polynomials of N = n slots, J =
    L*R digit rows and P primes.  The rule, from the shape alone, over the
    forms (`_ep_forms`) that leave two blocks a SM their shared memory
    (else over all): where no cluster's grid fills the card (`_EP_FILL`
    blocks), the largest cluster; else, of the clusters that do, the
    smallest with a staged form (the operand read once a block), else the
    smallest.  On the H100 (PERF.md, phase 4p) that was the fastest form at
    the vertical packing, the MVB and the CMux tree, and at K8 staged
    clusters of 2 beat one block a row.  `form` = (cluster, stage) forces
    one.  Raises where no form takes the shape."""
    log_n = _check_shape(n, R, J, P)
    forms = _ep_forms(n, R, J, P)
    if form is None:
        if not forms:
            raise ValueError(f"no cluster of K7/K8 blocks holds N = {n}, J = {J}, R = {R}, "
                             f"P = {P} in {_SMEM_LIMIT} B of shared memory a block")
        two = [f for f in forms if _ep_smem(n, R, J, P, *f) <= _SMEM_LIMIT // 2] or forms
        filled = sorted({c for c, _ in two if batch * c >= _EP_FILL})
        staged = [c for c in filled if (c, True) in two]
        if not filled:
            cluster = max(c for c, _ in two)
            form = (cluster, (cluster, True) in two)
        else:
            form = (staged[0], True) if staged else (filled[0], False)
    elif tuple(form) not in forms:
        raise ValueError(f"K7/K8 take a cluster dividing P = {P} (at most {_EP_MAXCL}), "
                         f"staged only where a block runs several primes, whose blocks fit "
                         f"shared memory; not {form}")
    cluster, stage = form
    sched = _pass_schedule(log_n, R)
    return EpLayout(cluster=cluster, stage=stage, head=sched["head"], tail=sched["tail"],
                    log_w=sched["log_w"], rt=sched["rt"],
                    smem=_ep_smem(n, R, J, P, cluster, stage))


def _ep_consts(plan: ntt.NttPlan) -> np.ndarray:
    """The constants K7/K8 take in host memory (u64), cached per plan:
    `rotation._host_consts`, then (hi, lo) of each prefix prod_{j<k} p_j
    mod 2^128 for 8 primes (zeros past the plan's), then of M mod 2^128
    (K8's lift, `Wide128` in csrc/ntt_passes.cuh)."""
    key = (plan.n, plan.num_primes)
    if key not in _EP_CONSTS:
        vals = [0] * (2 * _MAXP + 2)
        for i, v in enumerate(plan.prefix_mod128 + [plan.M_mod128]):
            at = 2 * i if i < plan.num_primes else 2 * _MAXP
            vals[at:at + 2] = [v >> 64, v & ((1 << 64) - 1)]
        _EP_CONSTS[key] = np.concatenate([_host_consts(plan), np.array(vals, dtype=np.uint64)])
    return _EP_CONSTS[key]


def _ep_launch_args(lay: EpLayout) -> tuple:
    """The layout's arguments of tfhe_external_product(128)."""
    return (lay.cluster, int(lay.stage), lay.rt, lay.head_code, lay.tail_code, lay.log_w,
            lay.smem)


def _lead(*shapes) -> tuple:
    """The shape the leading axes broadcast to (equal or empty shapes, the
    callers' case, without torch.broadcast_shapes)."""
    full = [tuple(sh) for sh in shapes if len(sh)]
    if all(sh == full[0] for sh in full[1:]):
        return full[0] if full else ()
    return tuple(torch.broadcast_shapes(*shapes))


def _batch(ct0, ct1, exps, spectra) -> tuple:
    """The broadcast batch shape of the operands' leading axes."""
    return _lead(ct0.shape[:-2], spectra.shape[:-4],
                 *([] if ct1 is None else [ct1.shape[:-2]]),
                 *([] if exps is None else [exps.shape]))


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
    lead = tuple(t.shape[:t.dim() - len(tail)])
    if math.prod(lead) == 1:
        return (t if t.is_contiguous() else t.contiguous()), 0
    if lead == batch and t.is_contiguous():
        return t, math.prod(tail)
    rows = t.expand(batch + tail).reshape((-1,) + tail)
    if not rows[0].is_contiguous():
        rows = rows.contiguous()
    return rows, rows.stride(0)


def _exps(exps, device) -> torch.Tensor:
    """The rotation exponents as an int64 tensor on the device (no copy
    where they are one already)."""
    if isinstance(exps, torch.Tensor) and exps.dtype == torch.int64 and exps.device == device:
        return exps
    return torch.as_tensor(exps, device=device).to(torch.int64)


def _exp_rows(exps: torch.Tensor, batch: tuple) -> tuple:
    """(exponents, element stride): one read for every row (stride 0), a
    column of a wider table read through its stride, or broadcast to the
    batch.  The kernels reduce them mod 2N themselves."""
    if exps.numel() == 1:
        return exps, 0
    if exps.dim() == 1 and tuple(exps.shape) == batch:
        return exps, exps.stride(0)
    rows = exps.expand(batch).reshape(-1)
    return rows, rows.stride(0)


def external_product(ct0: torch.Tensor, spectra: torch.Tensor, decomp,
                     ct1: torch.Tensor | None = None,
                     exps: torch.Tensor | None = None, *,
                     _form: tuple | None = None) -> torch.Tensor:
    """K7's wrapper: ct0 + GGSW [x] (ct1 - ct0), or with exps, ct0 + GGSW
    [x] (X^e * ct0 - ct0); arguments and result as
    `external_product_plain`'s.  The plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (or an error: there is no fallback), in
    `_ep_layout`'s form (`_form` = (cluster, stage) forces one; it never
    changes the result).  A GGSW or a ct0 without a batch of its own is
    read once for every row."""
    if ct0.device.type == "cpu":
        return external_product_plain(ct0, spectra, decomp, ct1, exps)
    if ct0.device.type != "cuda":
        raise ValueError(f"no external-product kernel for device {ct0.device}")
    if exps is not None:
        exps = _exps(exps, ct0.device)
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
    B = max(1, math.prod(batch))
    c0, s0 = _rows(ct0, batch, (R, n))
    key, sk = _rows(spectra, batch, (P, J, R, n))
    c1 = s1 = e64 = None
    se = 0
    if ct1 is not None:
        c1, s1 = _rows(ct1, batch, (R, n))
    else:
        e64, se = _exp_rows(exps, batch)
    lay = _ep_layout(B, n, R, J, P, _form)
    plan = ntt.get_plan(n, P)
    tab, cs = _delta_tables(plan, ct0.device, variants=True), _ep_consts(plan)
    out = torch.empty((B, R, n), dtype=torch.int64, device=ct0.device)
    global launches
    code = cuda_lib.library().tfhe_external_product(
        c0.data_ptr(), s0, None if c1 is None else c1.data_ptr(), s1 or 0,
        None if e64 is None else e64.data_ptr(), se, key.data_ptr(), sk, tab.data_ptr(),
        cs.ctypes.data, out.data_ptr(), B, plan.log_n, P, R, decomp.level, decomp.base_log,
        *_ep_launch_args(lay), cuda_lib.stream_of(ct0))
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
    return _lead(acc.shape[:-3], spectra.shape[:-4], exps.shape), P, J, R, n


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
                        exps: torch.Tensor, *, _form: tuple | None = None) -> torch.Tensor:
    """K8's wrapper: acc + GGSW [x] (X^e acc - acc) mod 2^128, arguments
    and result as `external_product128_plain`'s.  The plain version for CPU
    tensors, the CUDA kernel for CUDA tensors, an error on any other device
    (there is no fallback), in `_ep_layout`'s form (`_form` as K7's).  A
    GGSW or an acc without a batch of its own is read once for every row."""
    if acc.device.type == "cpu":
        return external_product128_plain(acc, spectra, decomp, exps)
    if acc.device.type != "cuda":
        raise ValueError(f"no external-product kernel for device {acc.device}")
    exps = _exps(exps, acc.device)
    batch, P, J, R, n = _check128(acc, spectra, decomp, exps)
    if acc.dtype != torch.int64 or spectra.dtype != torch.int32:
        raise TypeError("acc must be int64 limbs and the GGSW spectra int32")
    if spectra.device != acc.device:
        raise ValueError("all operands must be on one device")
    B = max(1, math.prod(batch))
    a, sa = _rows(acc, batch, (R, n, 2))
    key, sk = _rows(spectra, batch, (P, J, R, n))
    e64, se = _exp_rows(exps, batch)
    lay = _ep_layout(B, n, R, J, P, _form)
    plan = ntt.get_plan(n, P)
    tab, cs = _delta_tables(plan, acc.device, variants=True), _ep_consts(plan)
    out = torch.empty((B, R, n, 2), dtype=torch.int64, device=acc.device)
    global launches128
    code = cuda_lib.library().tfhe_external_product128(
        a.data_ptr(), sa, e64.data_ptr(), se, key.data_ptr(), sk, tab.data_ptr(),
        cs.ctypes.data, out.data_ptr(), B, plan.log_n, P, R, decomp.level, decomp.base_log,
        *_ep_launch_args(lay), cuda_lib.stream_of(acc))
    launches128 += 1
    cuda_lib.check(code, "tfhe_external_product128")
    return out.reshape(batch + (R, n, 2))



__all__ = ["external_product", "external_product_plain", "external_product128",
           "external_product128_plain"]
