"""The blind rotation, classic (delta form), paired and multi-bit, on two
routes: the whole rotation in one kernel launch (K1, K3) or one launch per
step (K4, K5); where a ciphertext's working set exceeds one block's shared
memory, both routes run K6 instead: the cluster step (one launch a step, a
cluster of blocks per ciphertext) where a cluster holds the step, else its
passes form over device memory.

Counterpart of `tfhe_tpu/core/poly/pallas_ntt.py`: `blind_rotate_fused`
(:1537, the fused route) and `blind_rotate_pallas` (:1742) /
`multi_bit_blind_rotate_pallas` (:1853) (the per-step route).  The modulus
switch, the LUT pre-rotation and the multi-bit variant exponents are torch
glue here, as they are XLA glue there.  Every step is one of

  delta (classic keys), K1's loop body and K4:
    acc += (X^e_j - 1) * sum_{l,r} decomp_l(acc_r) * GGSW(s_j)[l, r]

  variants (multi-bit keys of g-bit groups, and paired classic keys as
  g = 1 over [GGSW(1 - s_j), GGSW(s_j)]), K3's loop body and K5:
    acc = sum_{v < 2^g} X^{c_v} * sum_{l,r} decomp_l(acc_r) * GGSW_{j,v}[l, r]

All the kernels are in `csrc/rotation.cu` (a delta body for K1/K4, a
variant body for K3/K5, and K6, whose cluster step and whose passes form
both run the delta body's region pipeline; the source's header says what
each replaces and what bounds it on the card), with
`blind_rotate_step_plain` as the one plain step formula beside them.  All
compute the exact product mod 2^64, so all are bit-identical to the JAX
functions.  The wrappers choose K1/K3/K4/K5 or K6 from the shape alone,
before any launch (`_rotation_route`, `_shape_plan`).  K1 and K4 run a
register-resident NTT in passes of up to 8 coefficients a thread, with the
digits fused into the first forward pass, the MAC between the last forward
and the first inverse pass, and Garner in the last inverse pass; their pass
schedule and MAC split come from `_delta_layout`, their twiddle and phase
tables (values beside their Shoup twins) from `_delta_tables`.  K3 and K5
run in clusters of C blocks that share each key word among C ciphertexts;
their grid, cluster, slot ranges, padding and shared memory come from
`_variant_launch_plan`.  K6's form comes from `_k6_layout` (the rule over
the shape, `_cluster_rule`): the cluster step's cluster size, prime groups
and passes from `_cluster_layout`; the passes form's passes, region size
and batch tiles from `_staged_layout` and `_staged_tiles`.  The JAX wrappers' batch bucketing
(`_padded_flat_batch`) only caps TPU compiles and has no counterpart: the
kernels take any batch.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ... import cuda_lib
from ..decomposition import signed_decompose
from ..entities import NttBootstrapKey, NttMultiBitBootstrapKey
from ..numeric import LOG_Q, shr
from . import monomial_mul, ntt

# Kernel launches, the CUDA branches only: `rotate_accumulator` (K1),
# `rotate_accumulator_multi_bit` (K3) and `blind_rotate_step` (K4 in delta
# mode, K5 in variants mode) where a ciphertext's working set fits one
# block; where it does not, K6: the cluster step (one launch a step; delta
# and variant steps counted apart) or the passes form's kernels (2 per head
# pass + 1 a step; delta steps only).
launches = 0
multi_bit_launches = 0
step_launches = 0
step_variant_launches = 0
cluster_launches = 0
cluster_variant_launches = 0
staged_launches = 0

_MAXP = 8
_MAXR = 4              # K3/K5 are instantiated for k+1 = 1..4 outputs
_SMEM_LIMIT = 232448   # dynamic shared memory one block may use on sm_90
_CLUSTERS = (1, 2, 4, 8)   # cluster sizes K3/K5 are instantiated for
_CLUSTER = 2           # K3/K5's default cluster size (chip_smoke.py's sweep)
_DELTA_THREADS = 256   # threads of a K1/K4 block (DELTA_THREADS in csrc/rotation.cu)
_STAGED_WARPS = 8      # regions (warps) of a K6 passes-form region block, at most
_STAGED_SCRATCH = 2 << 30   # bytes of K6 passes-form scratch a call holds at once
_CLUSTER_SIZES = (2, 4, 8, 16)   # blocks a ciphertext in K6's cluster step
_CLUSTER_MAXP = 4      # primes the cluster step's lift holds in registers
_PER_STEP_MAX_N = 8192  # the per-step routes' largest N (pallas_ntt.py:1809)
_TABLES: dict = {}     # (N, P, device) → (tab, consts) for the variant body
_DELTA_TABLES: dict = {}   # (N, P, device, variants) → tab for the delta body and K6
_CONSTS: dict = {}     # (N, P) → the constants buffer in host memory
_ACTIVE: dict = {}     # (kernel, cluster, ..., smem, device) → clusters the device holds


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


def _mac(d_hat: torch.Tensor, spec: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """sum_j d_hat[:, :, j] * spec[:, j, r] mod p: [B, P, J, N] x [P, J, R, N]
    → [B, P, R, N]."""
    prod = d_hat.unsqueeze(-2) * spec.to(torch.int64) % p.unsqueeze(-1).unsqueeze(-1)
    return prod.sum(dim=2) % p.unsqueeze(-1)


def blind_rotate_step_plain(acc: torch.Tensor, exps_j: torch.Tensor,
                            key_slice: torch.Tensor, mode: str, decomp) -> torch.Tensor:
    """The plain version of K4 and K5, and the one step formula of every
    plain rotation here.  Updates acc [B, R, N] int64 in place and returns
    it.  mode="delta": exps_j [B] in [0, 2N), key_slice [P, J, R, N] (one
    GGSW(s_j)); mode="variants": exps_j [B, 2^g - 1] (c_v for v >= 1),
    key_slice [2^g, P, J, R, N]."""
    P, J, R, n = key_slice.shape[-4:]
    plan = ntt.get_plan(n, P)
    tab = plan.tables(acc.device)
    p = tab["p"]                                                 # [P, 1]
    e = exps_j.to(torch.int64)
    d_hat = _digit_spectra(acc, decomp, plan)                    # [B, P, J, N]
    if mode == "delta":
        # (X^e - 1) at slot k is psi^(e * (2 brv(k) + 1) mod 2N) - 1
        m = e[:, None] * tab["slot_odd"] % (2 * n)               # [B, N]
        phase = ((tab["psi_pow"] - 1) % p)[:, m].permute(1, 0, 2)   # [B, P, N]
        mac = _mac(d_hat, key_slice, p) * phase.unsqueeze(-2) % p.unsqueeze(-1)
        acc += ntt.garner_to_torus(plan, ntt.ntt_inverse(plan, mac.transpose(1, 2)))
    elif mode == "variants":
        total = _mac(d_hat, key_slice[0], p)                     # [B, P, R, N]
        for v in range(1, key_slice.shape[0]):
            m = e[:, v - 1, None] * tab["slot_odd"] % (2 * n)    # [B, N]
            phase = tab["psi_pow"][:, m].permute(1, 0, 2)        # [B, P, N] = X^{c_v}
            d = d_hat * phase.unsqueeze(2) % p.unsqueeze(-1)
            total = (total + _mac(d, key_slice[v], p)) % p.unsqueeze(-1)
        acc.copy_(ntt.garner_to_torus(plan, ntt.ntt_inverse(plan, total.transpose(1, 2))))
    else:
        raise ValueError(f"mode is 'delta' or 'variants', not {mode!r}")
    return acc


def _step_mode(key, exps: torch.Tensor) -> tuple:
    """(mode, exps with a variant axis) for a rotation's steps: a paired key
    runs the variants step with g = 1 and c_1 = e_j."""
    if isinstance(key, NttMultiBitBootstrapKey):
        return "variants", exps
    return ("variants", exps.unsqueeze(-1)) if key.paired else ("delta", exps)


def blind_rotate_plain(acc: torch.Tensor, exps: torch.Tensor, key) -> torch.Tensor:
    """K1's plain version, and for a paired key the plain version of the
    paired per-step route.  acc [B, R, N] int64 (pre-rotated LUT), exps
    [B, n] integers in [0, 2N), key spectra [n, P, J, R, N] (or [n, 2, P,
    J, R, N] paired) → the rotated acc (a new tensor).  A multi-bit key
    takes exps [B, n/g, 2^g - 1] (`blind_rotate_multi_bit_plain`)."""
    mode, exps = _step_mode(key, exps)
    out = acc.clone()
    for j in range(key.spectra.shape[0]):
        blind_rotate_step_plain(out, exps[:, j], key.spectra[j], mode, key.decomp)
    return out


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
    return blind_rotate_plain(acc, exps, key)


def _shoup_u32(vals: np.ndarray, p: np.ndarray) -> np.ndarray:
    return ((vals.astype(object) << 32) // p.astype(object)).astype(np.uint64)


def _kernel_tables(plan: ntt.NttPlan, device) -> tuple:
    """(tab, consts) for the variant body (K3/K5), cached per plan and
    device: tab its u32 tables [psi_rev, twin, psi_inv_rev, twin] [P, N],
    then [P, 2N] rows it does not read (zeros that keep its offsets until it
    takes the delta body's NTT), then [pw, twin] [P, 2N] with pw[m] = psi^m;
    consts `_host_consts` on the device.  The delta body (K1/K4, K6, K7/K8)
    takes its tables from `_delta_tables` and its constants from
    `_host_consts` in host memory."""
    dkey = (plan.n, plan.num_primes, str(torch.device(device)))
    if dkey not in _TABLES:
        P, n = plan.num_primes, plan.n
        assert P <= _MAXP
        p = plan.p64                                             # [P, 1]
        parts = []
        for vals in (plan.psi_rev, plan.psi_inv_rev):
            parts += [vals.astype(np.uint64), _shoup_u32(vals, p)]
        parts += [np.zeros(2 * 2 * P * n, dtype=np.uint64)]
        parts += [plan.psi_pow.astype(np.uint64), _shoup_u32(plan.psi_pow, p)]
        tab = np.concatenate([a.reshape(-1) for a in parts]).astype(np.uint32)
        consts = _host_consts(plan)
        _TABLES[dkey] = (torch.from_numpy(tab.view(np.int32).copy()).to(device),
                         torch.from_numpy(consts.view(np.int64)).to(device))
    return _TABLES[dkey]


def _host_consts(plan: ntt.NttPlan) -> np.ndarray:
    """The constants buffer (u64, the kernel's C_* layout) in host memory,
    cached per plan: the delta kernel takes it by value."""
    dkey = (plan.n, plan.num_primes)
    if dkey not in _CONSTS:
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
        _CONSTS[dkey] = cs
    return _CONSTS[dkey]


def _swizzle(pos):
    """Where the delta body keeps coefficient or slot `pos` of a polynomial
    in shared memory: bits 2-4 (the 4-word group within a 32-word row)
    XORed with bits 5-7 (the row within 256 words).  A 4-slot group stays
    whole, and each pass's warp access falls in 32 banks."""
    return pos ^ (((pos >> 5) & 7) << 2)


def _pack(radices: tuple) -> int:
    """A pass list as the kernel reads it: the count in bits 0-3, then one
    radix log per 4 bits, the first pass lowest."""
    code = len(radices)
    for i, r in enumerate(radices):
        code |= r << (4 + 4 * i)
    return code


@dataclass(frozen=True)
class DeltaLayout:
    """How the delta body (K1/K4) transforms one ciphertext.  The forward
    transform's stages run top down (t = N/2 first) in passes; a pass of
    radix log r holds 2^r coefficients of one polynomial in a thread's
    registers for r stages.  `head` passes (radix logs, top pass first)
    span the whole polynomial and end in a block barrier; the first reads
    the accumulator and decomposes it.  `tail` passes work in regions of
    2^log_w coefficients, one warp per region, with warp barriers only.
    The MAC runs the last two stages (t = 2, 1) on groups of 4 slots for
    every digit polynomial, the R/`chunks` outputs of one chunk per thread
    (`rt`), and the inverse's first two; the inverse mirrors the rest, and
    its top pass on the last prime adds the Garner lift into acc.  Where
    every warp has a region of its own (N/2^log_w regions, at least
    threads/32), one warp runs a region's tails in every polynomial and its
    MAC, with warp barriers only.  `smem` bytes of shared memory, `threads`
    per block."""
    log_n: int
    head: tuple
    tail: tuple
    log_w: int
    rt: int
    chunks: int
    threads: int
    smem: int

    @property
    def head_code(self) -> int:
        return _pack(self.head)

    @property
    def tail_code(self) -> int:
        return _pack(self.tail)


def _split(stages: int, top_first: bool) -> tuple:
    """Radix logs of at most 3 covering `stages` stages, as few passes as
    can be, the remainder spread (head) or last (tail)."""
    if stages == 0:
        return ()
    count = -(-stages // 3)
    if top_first:
        return tuple([3] * (stages // 3) + ([stages % 3] if stages % 3 else []))
    return tuple(stages // count + (i < stages % count) for i in range(count))


def _check_shape(n: int, R: int, J: int, P: int) -> int:
    """log2 N, after the checks every rotation kernel makes: N a power of
    two >= 4, 1 <= P <= 8, J = L*R digit rows."""
    log_n = n.bit_length() - 1
    if n < 4 or n != 1 << log_n:
        raise ValueError(f"the rotation kernels take N a power of two >= 4, not {n}")
    if not 1 <= P <= _MAXP or R < 1 or J < 1 or J % R:
        raise ValueError(f"the rotation kernels take P <= {_MAXP} and J = L*R >= 1, "
                         f"not P={P}, R={R}, J={J}")
    return log_n


def _mac_chunks(R: int, slots: int, threads: int) -> int:
    """Outputs per MAC item come in R/chunks (at most 4): the fewest chunks
    that give each of `threads` threads a group of 4 of `slots` slots, else
    the most."""
    chunks = [c for c in range(1, R + 1) if R % c == 0 and R // c <= 4]
    full = [c for c in chunks if c * slots // 4 >= threads]
    return full[0] if full else chunks[-1]


def _pass_schedule(log_n: int, R: int) -> dict:
    """The delta body's passes for polynomials of 2^log_n slots and R
    outputs (K1/K4's `_delta_layout`, K7/K8's `external_product._ep_layout`):
    the head and tail radix logs, the region size and the MAC's chunks."""
    # head: the stages above a warp's region of at most 256 coefficients
    # (at least one stage, so that the first pass decomposes; none at N = 4,
    # where a pass of radix 1 decomposes and the MAC runs both stages)
    h = 0 if log_n == 2 else max(log_n - 8, 1)
    log_w = log_n - h
    c = _mac_chunks(R, 1 << log_n, _DELTA_THREADS)
    return dict(log_n=log_n, head=_split(h, False) or (0,), tail=_split(log_w - 2, True),
                log_w=log_w, rt=R // c, chunks=c, threads=_DELTA_THREADS)


def _delta_layout(n: int, R: int, J: int, P: int) -> DeltaLayout:
    """The delta body's layout for polynomials of N = n slots, R outputs,
    J = L*R digit rows and P primes; raises where the kernel does not take
    the shape (P > 8, the working set above one block's shared memory:
    that shape runs K6, `_staged_layout`)."""
    log_n = _check_shape(n, R, J, P)
    return DeltaLayout(smem=_block_smem(n, R, J, P), **_pass_schedule(log_n, R))


@dataclass(frozen=True)
class StagedLayout:
    """How K6's passes form runs one step of a ciphertext whose working set
    does not fit one block, where no cluster holds it (`_cluster_rule`).
    The digit spectra and the products stay in device memory (scratch
    [B, P, J, N] and [B, P, R, N] u32, swizzled as the delta body keeps a
    polynomial in shared memory).  The forward transform's `head`
    passes (radix logs, top pass first) run over device memory, one launch
    each, the first decomposing acc for every prime; one launch runs, a
    warp per region of 2^log_w slots, the forward `tail` passes, the MAC
    (R outputs in `chunks` of rt) and the inverse tail, with the region in
    shared memory (`warps` regions a block, `smem` bytes); the inverse head
    passes mirror the forward ones, and the last lifts with Garner over the
    primes into acc.  `launches` kernels a step."""
    log_n: int
    head: tuple
    tail: tuple
    log_w: int
    rt: int
    chunks: int
    warps: int
    smem: int

    @property
    def launches(self) -> int:
        return 2 * len(self.head) + 1

    @property
    def head_code(self) -> int:
        return _pack(self.head)

    @property
    def tail_code(self) -> int:
        return _pack(self.tail)


def _staged_layout(n: int, R: int, J: int, P: int) -> StagedLayout:
    """K6's passes form's layout for N = n slots, R outputs, J = L*R digit rows and P
    primes: the stages above a region of at most 256 slots (at least one)
    are head passes of radix 8 at most; a region holds 32 slots or more
    (N >= 64), so that the swizzle keeps its words together."""
    log_n = _check_shape(n, R, J, P)
    h = max(log_n - 8, 1)
    log_w = log_n - h
    if log_w < 5:
        raise ValueError(f"the staged kernel takes N >= 64, not {n}")
    per_warp = 4 * (J + R) << log_w
    if per_warp > _SMEM_LIMIT:
        raise ValueError(f"a region's {J + R} polynomials ({per_warp} B) exceed one "
                         f"block's shared memory ({_SMEM_LIMIT} B)")
    warps = _STAGED_WARPS
    while warps * per_warp > _SMEM_LIMIT:
        warps //= 2
    c = _mac_chunks(R, 1 << log_w, 32)
    return StagedLayout(log_n=log_n, head=_split(h, False), tail=_split(log_w - 2, True),
                        log_w=log_w, rt=R // c, chunks=c, warps=warps, smem=warps * per_warp)


def _staged_args(lay: StagedLayout) -> tuple:
    """The layout's arguments of tfhe_staged_rotate."""
    return lay.rt, lay.head_code, lay.tail_code, lay.log_w, lay.warps, lay.smem


def _staged_tiles(batch: int, n: int, R: int, J: int, P: int) -> list:
    """Row ranges [lo, hi) of the batch that K6's passes form runs at once: as many
    ciphertexts as keep its scratch (4 P (J + R) N bytes each) within
    `_STAGED_SCRATCH`, at least one."""
    rows = max(1, _STAGED_SCRATCH // (4 * P * (J + R) * n))
    return [(lo, min(batch, lo + rows)) for lo in range(0, batch, rows)]


@dataclass(frozen=True)
class ClusterLayout:
    """How K6's cluster step runs one step of a ciphertext: a cluster of
    `cluster` = C blocks, one launch a step, cluster b owning ciphertext b.
    Block q keeps the region [q*W, (q+1)*W), W = N/C = 2^log_w, of every
    polynomial of the transform.  The top log2 C forward stages run across
    the cluster (the exchange: each block reads its share of the
    accumulator's columns, splits the digits and writes each output into
    the owning block's shared memory), the bottom log2 C inverse stages the
    same way (the gather, with Garner into acc).  Inside a block, K1's
    passes on the region: `head` passes (radix logs, over the block) down
    to tail regions of 2^log_t slots, one warp per (prime, tail region) for
    the `tail` passes, the MAC and the inverse tails.  The primes run in
    groups of `group`: a block holds one group's J digit spectra and every
    prime's R products, `smem` = 4 (group J + P R) W bytes."""
    log_n: int
    cluster: int
    group: int
    head: tuple
    tail: tuple
    log_t: int
    smem: int

    launches = 1

    @property
    def log_w(self) -> int:
        return self.log_n - (self.cluster.bit_length() - 1)

    @property
    def head_code(self) -> int:
        return _pack(self.head)

    @property
    def tail_code(self) -> int:
        return _pack(self.tail)


def _cluster_smem(n: int, R: int, J: int, P: int, cluster: int, group: int) -> int:
    """A cluster-step block's shared memory: a group of primes' J digit
    spectra and every prime's R products of its region of N/C slots."""
    return 4 * (group * J + P * R) * n // cluster


def _cluster_layout(n: int, R: int, J: int, P: int, cluster: int, group: int
                    ) -> ClusterLayout:
    """The cluster step's layout for N = n slots, R outputs, J = L*R digit
    rows, P primes, in clusters of `cluster` blocks and prime groups of
    `group`; raises where the kernel does not take it."""
    log_n = _check_shape(n, R, J, P)
    if cluster not in _CLUSTER_SIZES:
        raise ValueError(f"the cluster step takes clusters of {_CLUSTER_SIZES} blocks, "
                         f"not {cluster!r}")
    if P > _CLUSTER_MAXP or R > _MAXR or group < 1 or P % group:
        raise ValueError(f"the cluster step takes P <= {_CLUSTER_MAXP}, R <= {_MAXR} and a "
                         f"prime group dividing P, not P={P}, R={R}, group={group}")
    log_w = log_n - (cluster.bit_length() - 1)
    if log_w < 5:
        raise ValueError(f"a block's region of N/C = {n // cluster} slots is below 32")
    smem = _cluster_smem(n, R, J, P, cluster, group)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a cluster-step block's {smem} B exceed one block's shared memory "
                         f"({_SMEM_LIMIT} B)")
    log_t = min(log_w, 8)
    return ClusterLayout(log_n=log_n, cluster=cluster, group=group,
                         head=_split(log_w - log_t, False), tail=_split(log_t - 2, True),
                         log_t=log_t, smem=smem)


def _cluster_rule(n: int, R: int, J: int, P: int):
    """(C, group) of the cluster step for a shape that takes K6, or None
    where no cluster holds it (K6's passes form runs).  From the sweeps on
    the H100 (`chip_smoke.py` phase 3d', PERF.md): every prime in one group
    (3 cluster barriers a step, the accumulator read once), at the smallest
    C of at most 8 whose blocks fit two to a SM; else at the smallest C
    that holds it; else the largest group that fits, at the smallest C."""
    if P > _CLUSTER_MAXP or R > _MAXR:
        return None
    fits = [(c, group) for group in range(P, 0, -1) if P % group == 0 for c in _CLUSTER_SIZES
            if n // c >= 32 and _cluster_smem(n, R, J, P, c, group) <= _SMEM_LIMIT]
    two = [(c, group) for c, group in fits if group == P and c <= 8
           and 2 * _cluster_smem(n, R, J, P, c, group) <= _SMEM_LIMIT]
    return (two or fits or [None])[0]


def _k6_layout(n: int, R: int, J: int, P: int, variants: int, form=None):
    """K6's layout for a shape: the cluster step's (`ClusterLayout`) where
    `_cluster_rule` gives a cluster, else the passes form's
    (`StagedLayout`, delta steps only).  `form` asks for one: "passes", or
    (C, group) for the cluster step."""
    if form == "passes":
        choice = None
    elif form is None:
        choice = _cluster_rule(n, R, J, P)
    else:
        choice = tuple(form)
    if choice is not None:
        return _cluster_layout(n, R, J, P, *choice)
    if variants:
        raise ValueError(f"no cluster holds a variant step of N={n}, R={R}, J={J}, P={P}, "
                         f"and K6's passes form takes delta steps only")
    return _staged_layout(n, R, J, P)


def _rotation_route(n: int, R: int, J: int, P: int, per_step: bool = False,
                    staged: bool = False) -> str:
    """Which kernel a rotation of this shape takes, from the shape alone:
    "block" (K1/K3, or K4/K5 per step: a ciphertext's working set 8RN + 4JN
    + 4PRN bytes in one block's shared memory) or "staged" (K6; `staged`
    asks for it at any N; its form, the cluster step or the passes, comes
    from the shape too, `_k6_layout`).  The per-step routes end at N = 8192,
    as the JAX package's do (pallas_ntt.py:1809)."""
    if per_step and n > _PER_STEP_MAX_N:
        raise NotImplementedError(
            f"N = {n} on the per-step route: \"factored phase tables (N >= "
            f"fourstep.MONO_SPLIT_MIN_N) are only supported by the whole-rotation fused "
            f"kernel (config.use_fused_rotation)\" (tfhe_tpu/core/poly/pallas_ntt.py:1809; "
            f"MONO_SPLIT_MIN_N = 16384)")
    if staged or _working_set(n, R, J, P) > _SMEM_LIMIT:
        return "staged"
    return "block"


def _delta_tables(plan: ntt.NttPlan, device, variants: bool = False) -> torch.Tensor:
    """The delta body's tables (and K6's), cached per plan and device: u32
    pairs (value, Shoup twin) of psi_rev [P][N], psi_inv_rev [P][N] and the
    phase [P][2N] = (psi^m - 1)/N (`variants`: psi^m / N, K6's variant
    steps).  The twiddles stay in the heap order of ntt.py (stage with m
    blocks at [m, 2m)), so a pass's 2^r - 1 twiddles at heap node q are q,
    2q..2q+1, 4q..4q+3: with their twins beside them, one 8-byte and one or
    two 16-byte loads.  One 8-byte gather gives a slot's phase and its
    twin."""
    dkey = (plan.n, plan.num_primes, str(torch.device(device)), variants)
    if dkey not in _DELTA_TABLES:
        p = plan.p64
        n_inv = np.array(plan.n_inv, dtype=np.int64).reshape(-1, 1)
        phase = (plan.psi_pow - (0 if variants else 1)) % p * n_inv % p
        parts = [np.stack([vals.astype(np.uint64), _shoup_u32(vals, p)], axis=-1).reshape(-1)
                 for vals in (plan.psi_rev, plan.psi_inv_rev, phase)]
        tab = np.concatenate(parts).astype(np.uint32)
        _DELTA_TABLES[dkey] = torch.from_numpy(tab.view(np.int32).copy()).to(device)
    return _DELTA_TABLES[dkey]


def _working_set(n: int, R: int, J: int, P: int) -> int:
    """A ciphertext's working set in the block kernels (K1, K3, K4, K5):
    the accumulator [R][N] u64, the J digit spectra and the R products of
    all P primes, in one block's shared memory."""
    return 8 * R * n + 4 * J * n + 4 * P * R * n


def _block_smem(n: int, R: int, J: int, P: int) -> int:
    """`_working_set`, raising where one block cannot hold it."""
    smem = _working_set(n, R, J, P)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a ciphertext's working set ({smem} B) exceeds one "
                         f"block's shared memory ({_SMEM_LIMIT} B)")
    return smem


@dataclass(frozen=True)
class VariantPlan:
    """How K3/K5 are launched: `grid` blocks in clusters of `cluster`;
    block b owns ciphertext b, and the blocks in `padding` (b >= batch) hold
    a zero accumulator and only do their share of the MAC; in the MAC the
    block of rank c computes the slots range(*slots[c]) for every
    ciphertext of its cluster; each block has `smem` bytes of dynamic
    shared memory."""
    cluster: int
    grid: int
    slots: tuple
    padding: range
    smem: int


def _cluster_size(cluster) -> int:
    """The cluster size asked for (None: the default), checked."""
    cluster = _CLUSTER if cluster is None else cluster
    if cluster not in _CLUSTERS:
        raise ValueError(f"K3/K5 take a cluster of {_CLUSTERS} blocks, not {cluster!r}")
    return cluster


def _variant_launch_plan(batch: int, n: int, R: int, J: int, P: int,
                         cluster) -> VariantPlan:
    """The launch plan of K3/K5 for `batch` ciphertexts of R polynomials of
    N = n slots, J digit rows and P primes, in clusters of `cluster` blocks
    (None: the default).  Raises where the kernel does not take it."""
    cluster = _cluster_size(cluster)
    if batch < 1:
        raise ValueError(f"the batch must hold a ciphertext, not {batch}")
    if n % cluster:
        raise ValueError(f"a cluster of {cluster} blocks does not divide the {n} slots")
    smem = _block_smem(n, R, J, P)
    grid = -(-batch // cluster) * cluster
    span = n // cluster
    return VariantPlan(cluster=cluster, grid=grid,
                       slots=tuple((c * span, (c + 1) * span) for c in range(cluster)),
                       padding=range(batch, grid), smem=smem)


def _active_clusters(plan: VariantPlan, R: int, device) -> int:
    """How many of the plan's clusters the device holds at once (blocks
    for a cluster of 1): 0 means they cannot be scheduled.  Cached."""
    dev = torch.device(device)
    dkey = ("K3", plan.cluster, R, plan.smem, str(dev))
    if dkey not in _ACTIVE:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            code = cuda_lib.library().tfhe_variant_active_clusters(
                plan.cluster, R, plan.smem, ctypes.byref(out))
        cuda_lib.check(code, "tfhe_variant_active_clusters")
        _ACTIVE[dkey] = out.value
    return _ACTIVE[dkey]


def _cluster_step_active(lay: ClusterLayout, variants: bool, device) -> int:
    """How many of the cluster step's clusters the device holds at once: 0
    means they cannot be scheduled.  Cached."""
    dev = torch.device(device)
    dkey = ("K6", lay.cluster, variants, lay.smem, str(dev))
    if dkey not in _ACTIVE:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            code = cuda_lib.library().tfhe_cluster_step_active(
                lay.cluster, int(variants), lay.smem, ctypes.byref(out))
        cuda_lib.check(code, "tfhe_cluster_step_active")
        _ACTIVE[dkey] = out.value
    return _ACTIVE[dkey]


def _delta_active_blocks(lay: DeltaLayout, device) -> int:
    """How many K1/K4 blocks of this layout the device holds at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        code = cuda_lib.library().tfhe_delta_active_blocks(lay.rt, lay.smem, ctypes.byref(out))
    cuda_lib.check(code, "tfhe_delta_active_blocks")
    return out.value


def _schedulable(plan: VariantPlan, R: int, device) -> VariantPlan:
    """The plan, after checking that the device can hold its clusters (it
    raises where it cannot: there is no smaller cluster to fall back to)."""
    if _active_clusters(plan, R, device) < 1:
        raise RuntimeError(f"clusters of {plan.cluster} blocks with {plan.smem} B of shared "
                           f"memory each cannot be scheduled on {torch.device(device)}")
    return plan


def _shape_plan(n: int, R: int, L: int, base_log: int, P: int, variants: int,
                per_step: bool = False, staged: bool = False) -> tuple:
    """What a kernel wrapper does with a rotation of this shape, from the
    shape alone (no launch): → (route, layout), route "block" or "staged"
    (`_rotation_route`), layout `_delta_layout`'s for a block delta step,
    None for a block variant step (K3/K5: `_variant_launch_plan` adds the
    batch), `_k6_layout`'s for K6.  `variants`
    GGSWs a step, 0 for the delta step.  Raises where no kernel takes the
    shape."""
    J = L * R
    if base_log > 24 or base_log < 1:
        raise ValueError(f"the rotation kernels take base_log 1..24, not {base_log}")
    _check_shape(n, R, J, P)
    if variants:
        g = variants.bit_length() - 1
        if variants != 1 << g or not 1 <= g <= 4:
            raise ValueError(f"the kernel takes groupings 1..4 with 2^g variants, "
                             f"not {variants} variants")
    route = _rotation_route(n, R, J, P, per_step, staged)
    if route == "staged":
        return route, _k6_layout(n, R, J, P, variants)
    if not variants:
        return route, _delta_layout(n, R, J, P)
    if R > _MAXR:
        raise ValueError(f"the variants kernel takes k+1 <= {_MAXR}, not {R}")
    return route, None


def _kernel_setup(acc: torch.Tensor, key_shape: tuple, decomp, variants: int,
                  per_step: bool = False, staged: bool = False) -> tuple:
    """Checks shared by the kernel wrappers on acc [B, R, N] and a key of
    shape [..., P, J, R, N] with `variants` GGSWs per step (0 for the delta
    step); → (plan, tab, consts, layout): for K6 (a `ClusterLayout` or a
    `StagedLayout`) and for a block delta key the delta body's tables
    (`_delta_tables`, with the variant phase for K6's variant steps), the
    constants in host memory (`_host_consts`) and the layout; for a block
    variant key the variant body's tables and constants (`_kernel_tables`)
    and None."""
    P, J, R, n = key_shape[-4:]
    B = acc.shape[0]
    L, base_log = decomp.level, decomp.base_log
    if tuple(acc.shape) != (B, R, n) or J != L * R:
        raise ValueError(f"shapes acc {tuple(acc.shape)} and key {tuple(key_shape)} "
                         f"disagree")
    if acc.dtype != torch.int64:
        raise TypeError("acc must be int64")
    route, lay = _shape_plan(n, R, L, base_log, P, variants, per_step, staged)
    plan = ntt.get_plan(n, P)
    if route == "staged" or not variants:
        return (plan, _delta_tables(plan, acc.device, bool(variants)), _host_consts(plan),
                lay)
    return (plan,) + _kernel_tables(plan, acc.device) + (None,)


def _delta_args(lay: DeltaLayout) -> tuple:
    """The layout's arguments of tfhe_blind_rotate and tfhe_blind_rotate_step."""
    return lay.rt, lay.head_code, lay.tail_code, lay.log_w, lay.smem


def _check_key(key) -> None:
    if key.order != "ct-bitrev":
        raise ValueError(f"the kernels read ct-bitrev spectra, not {key.order!r}")
    P, n = key.spectra.shape[-4], key.spectra.shape[-1]
    if tuple(key.primes) != ntt.get_plan(n, P).primes:
        raise ValueError("key primes differ from primes_for(N)[:P]")


def _launch_args(acc: torch.Tensor, exps: torch.Tensor, key, exps_shape: tuple,
                 variants: int, staged: bool) -> tuple:
    """Checks of the whole-rotation wrappers; → (plan, tab, consts, layout,
    out, exps as int32, spectra), all contiguous on acc's device."""
    _check_key(key)
    if tuple(exps.shape) != exps_shape:
        raise ValueError(f"shapes acc {tuple(acc.shape)}, exps {tuple(exps.shape)}, "
                         f"key {tuple(key.spectra.shape)} disagree")
    if key.spectra.dtype != torch.int32:
        raise TypeError("the key spectra must be int32")
    if key.spectra.device != acc.device or exps.device != acc.device:
        raise ValueError("all operands must be on one device")
    plan, tab, cs, lay = _kernel_setup(acc, key.spectra.shape, key.decomp, variants,
                                       staged=staged)
    return (plan, tab, cs, lay, acc.contiguous().clone(), exps.to(torch.int32).contiguous(),
            key.spectra.contiguous())


def _staged_rotate(acc: torch.Tensor, exps: torch.Tensor, e_step: int,
                   spectra: torch.Tensor, decomp, grouping: int, n_steps: int, lay,
                   plan: ntt.NttPlan, tab: torch.Tensor, cs: np.ndarray) -> None:
    """K6 over acc [B, R, N] (contiguous, updated in place) for n_steps
    steps of `spectra` (delta: [steps, P, J, R, N], grouping 0; variants:
    [steps, 2^g, P, J, R, N]).  exps: int32, ciphertext b's exponents of
    step s e_step words after exps[b] (delta: e; variants:
    c_1..c_{2^g-1}), read through its batch stride.  A `ClusterLayout`
    runs the cluster step, one launch a step, each adding one to
    `cluster_launches` (delta) or `cluster_variant_launches` (variants),
    after checking that the device schedules its clusters; a
    `StagedLayout` runs the passes form (delta) in batch tiles
    (`_staged_tiles`), each launch adding one to `staged_launches`."""
    global staged_launches, cluster_launches, cluster_variant_launches
    B, R, n = acc.shape
    P, L = plan.num_primes, decomp.level
    lib = cuda_lib.library()
    if isinstance(lay, ClusterLayout):
        if _cluster_step_active(lay, bool(grouping), acc.device) < 1:
            raise RuntimeError(f"clusters of {lay.cluster} blocks with {lay.smem} B of shared "
                               f"memory each cannot be scheduled on {acc.device}")
        code = lib.tfhe_cluster_step(
            acc.data_ptr(), exps.data_ptr(), exps.stride(0), e_step, spectra.data_ptr(),
            tab.data_ptr(), cs.ctypes.data, B, n_steps, n, plan.log_n, P, R, L,
            decomp.base_log, grouping, lay.cluster, lay.group, lay.head_code, lay.tail_code,
            lay.log_t, lay.smem, cuda_lib.stream_of(acc))
        if grouping:
            cluster_variant_launches += n_steps
        else:
            cluster_launches += n_steps
        cuda_lib.check(code, "tfhe_cluster_step")
        return
    tiles = _staged_tiles(B, n, R, L * R, P)
    rows = tiles[0][1]
    spec = torch.empty((rows, P, L * R, n), dtype=torch.int32, device=acc.device)
    res = torch.empty((rows, P, R, n), dtype=torch.int32, device=acc.device)
    for lo, hi in tiles:
        code = lib.tfhe_staged_rotate(
            acc[lo].data_ptr(), exps[lo].data_ptr(), exps.stride(0), e_step,
            spectra.data_ptr(), tab.data_ptr(), cs.ctypes.data, spec.data_ptr(),
            res.data_ptr(), hi - lo, n_steps, n, plan.log_n, P, R, L, decomp.base_log,
            *_staged_args(lay), cuda_lib.stream_of(acc))
        staged_launches += n_steps * lay.launches
        cuda_lib.check(code, "tfhe_staged_rotate")


def rotate_accumulator(acc: torch.Tensor, exps: torch.Tensor,
                       key: NttBootstrapKey, *, _staged: bool = False) -> torch.Tensor:
    """K1's wrapper: the plain version for CPU tensors, a CUDA kernel for
    CUDA tensors (or an error: there is no fallback): K1 where a
    ciphertext's working set fits one block, else K6's host step loop
    (`_rotation_route`, from the shape).  Returns a new rotated accumulator
    [B, R, N] int64.  Takes delta keys only: a paired key runs on the
    per-step route (`rotate_steps`).  `_staged` runs K6 at any N; it does
    not change the result."""
    if key.paired:
        raise ValueError("K1 takes a delta key; a paired key runs rotate_steps")
    if acc.device.type == "cpu":
        return blind_rotate_plain(acc, exps, key)
    if acc.device.type != "cuda":
        raise ValueError(f"no blind-rotation kernel for device {acc.device}")
    global launches
    n_steps, P, J, R, n = key.spectra.shape
    plan, tab, cs, lay, out, e32, spectra = _launch_args(acc, exps, key,
                                                         (acc.shape[0], n_steps), 0, _staged)
    if isinstance(lay, (ClusterLayout, StagedLayout)):
        _staged_rotate(out, e32, 1, spectra, key.decomp, 0, n_steps, lay, plan, tab, cs)
        return out
    lib = cuda_lib.library()
    code = lib.tfhe_blind_rotate(out.data_ptr(), e32.data_ptr(), spectra.data_ptr(),
                                 tab.data_ptr(), cs.ctypes.data, out.shape[0], n_steps, n,
                                 plan.log_n, P, R, key.decomp.level, key.decomp.base_log,
                                 *_delta_args(lay), cuda_lib.stream_of(out))
    launches += 1
    cuda_lib.check(code, "tfhe_blind_rotate")
    return out


def rotate_accumulator_multi_bit(acc: torch.Tensor, exps: torch.Tensor,
                                 key: NttMultiBitBootstrapKey, *,
                                 _cluster: int | None = None,
                                 _staged: bool = False) -> torch.Tensor:
    """K3's wrapper: the plain version for CPU tensors, a CUDA kernel for
    CUDA tensors (or an error: there is no fallback): K3 where a
    ciphertext's working set fits one block, else K6's variant steps.  exps
    [B, n/g, 2^g-1] from `variant_exponents`.  Returns a new rotated
    accumulator [B, R, N].  `_cluster` sets K3's cluster size (default
    `_CLUSTER`), `_staged` runs K6 at any N; neither changes the result."""
    cluster = _cluster_size(_cluster)
    if acc.device.type == "cpu":
        return blind_rotate_multi_bit_plain(acc, exps, key)
    if acc.device.type != "cuda":
        raise ValueError(f"no multi-bit blind-rotation kernel for device {acc.device}")
    global multi_bit_launches
    n_steps, V, P, J, R, n = key.spectra.shape
    if V != 1 << key.grouping_factor:
        raise ValueError(f"grouping {key.grouping_factor} has {1 << key.grouping_factor} "
                         f"variants, the key {V}")
    plan, tab, cs, lay, out, e32, spectra = _launch_args(
        acc, exps, key, (acc.shape[0], n_steps, V - 1), V, _staged)
    if isinstance(lay, ClusterLayout):
        _staged_rotate(out, e32, V - 1, spectra, key.decomp, key.grouping_factor, n_steps,
                       lay, plan, tab, cs)
        return out
    launch = _schedulable(_variant_launch_plan(out.shape[0], n, R, J, P, cluster), R,
                          out.device)
    lib = cuda_lib.library()
    code = lib.tfhe_blind_rotate_multi_bit(
        out.data_ptr(), e32.data_ptr(), spectra.data_ptr(), tab.data_ptr(),
        cs.data_ptr(), out.shape[0], n_steps, n, plan.log_n, P, R, key.decomp.level,
        key.decomp.base_log, key.grouping_factor, launch.grid, launch.cluster, launch.smem,
        cuda_lib.stream_of(out))
    multi_bit_launches += 1
    cuda_lib.check(code, "tfhe_blind_rotate_multi_bit")
    return out


def blind_rotate_step(acc: torch.Tensor, exps_j: torch.Tensor, key_slice: torch.Tensor,
                      mode: str, decomp, *, _cluster: int | None = None,
                      _staged: bool = False) -> torch.Tensor:
    """One blind-rotation step over the batch, in place on acc [B, R, N]
    int64; returns acc.  Counterpart of `blind_rotate_step_pallas_mxu`
    (pallas_ntt.py:1018, B4), `blind_rotate_step_pallas_mxu_lanes` (:955,
    B5: B4 with the batch in TPU lanes) and `blind_rotate_step_pallas`
    (:494, B6: paired classic or multi-bit, DIF butterflies); the port takes
    exponents, not pre-gathered phases, and builds the phase in the kernel.

      mode="delta":    exps_j [B] in [0, 2N), key_slice [P, J, R, N]:
                       acc += (X^e - 1) * (GGSW(s_j) [x] acc)       (K4)
      mode="variants": exps_j [B, 2^g - 1] (c_v, v >= 1), key_slice
                       [2^g, P, J, R, N], g = 1..4 (g = 1 is a paired key):
                       acc = sum_v X^{c_v} * (GGSW_{j,v} [x] acc)   (K5)

    key_slice holds residues mod primes_for(N)[:P] in the ct-bitrev order.
    CPU tensors take `blind_rotate_step_plain`; CUDA tensors launch K4 or K5
    where a ciphertext's working set fits one block, else K6 for one step:
    one cluster-step launch, or the passes form (or raise: there is no
    fallback).  N above 8192 raises on every device,
    as the JAX per-step routes do.  On the card exps_j must be int32; a
    strided view (a column of the [B, n] table) is read in place, through
    its batch stride.  `_cluster` sets K5's cluster size (default
    `_CLUSTER`; K4 takes none), `_staged` runs K6 at any N; neither changes
    the result."""
    if mode == "delta" and _cluster is not None:
        raise ValueError("K4, the delta step, runs without a cluster")
    cluster = _cluster_size(_cluster)
    P, J, R, n = key_slice.shape[-4:]
    _rotation_route(n, R, J, P, per_step=True)
    if acc.device.type == "cpu":
        return blind_rotate_step_plain(acc, exps_j, key_slice, mode, decomp)
    if acc.device.type != "cuda":
        raise ValueError(f"no blind-rotation step kernel for device {acc.device}")
    global step_launches, step_variant_launches
    if mode not in ("delta", "variants"):
        raise ValueError(f"mode is 'delta' or 'variants', not {mode!r}")
    variants = key_slice.shape[0] if mode == "variants" else 0
    if key_slice.ndim != (5 if variants else 4):
        raise ValueError(f"a {mode} step takes a key slice of {5 if variants else 4} "
                         f"axes, not {tuple(key_slice.shape)}")
    plan, tab, cs, lay = _kernel_setup(acc, key_slice.shape, decomp, variants, True, _staged)
    B = acc.shape[0]
    e_shape = (B, variants - 1) if variants else (B,)
    if tuple(exps_j.shape) != e_shape or exps_j.dtype != torch.int32:
        raise ValueError(f"exps_j must be int32 {e_shape}, not {exps_j.dtype} "
                         f"{tuple(exps_j.shape)}")
    if key_slice.dtype != torch.int32:
        raise TypeError("the key slice must be int32")
    if key_slice.device != acc.device or exps_j.device != acc.device:
        raise ValueError("all operands must be on one device")
    if not acc.is_contiguous():
        raise ValueError("the step updates acc in place: it must be contiguous")
    if variants and exps_j.stride(1) != 1:
        exps_j = exps_j.contiguous()
    key_slice = key_slice.contiguous()
    if isinstance(lay, (ClusterLayout, StagedLayout)):
        _staged_rotate(acc, exps_j, 0, key_slice, decomp,
                       variants.bit_length() - 1 if variants else 0, 1, lay, plan, tab, cs)
        return acc
    lib = cuda_lib.library()
    shape = (B, n, plan.log_n, P, R, decomp.level, decomp.base_log)
    if variants:
        launch = _schedulable(_variant_launch_plan(B, n, R, J, P, cluster), R, acc.device)
        code = lib.tfhe_blind_rotate_step_variants(
            acc.data_ptr(), exps_j.data_ptr(), exps_j.stride(0), key_slice.data_ptr(),
            tab.data_ptr(), cs.data_ptr(), *shape, variants.bit_length() - 1, launch.grid,
            launch.cluster, launch.smem, cuda_lib.stream_of(acc))
        step_variant_launches += 1
        cuda_lib.check(code, "tfhe_blind_rotate_step_variants")
    else:
        code = lib.tfhe_blind_rotate_step(
            acc.data_ptr(), exps_j.data_ptr(), exps_j.stride(0), key_slice.data_ptr(),
            tab.data_ptr(), cs.ctypes.data, *shape, *_delta_args(lay), cuda_lib.stream_of(acc))
        step_launches += 1
        cuda_lib.check(code, "tfhe_blind_rotate_step")
    return acc


def rotate_steps(acc: torch.Tensor, exps: torch.Tensor, key) -> torch.Tensor:
    """The per-step rotation: acc [B, R, N] int64 rotated in place, one
    `blind_rotate_step` per step, and returned.  exps [B, n] in [0, 2N) for
    a classic key (delta: K4; paired: K5 with g = 1), [B, n/g, 2^g - 1]
    (`variant_exponents`) for a multi-bit key (K5).  The exponents are
    converted to int32 once; each step reads its column in place."""
    _check_key(key)
    mode, exps = _step_mode(key, exps)
    e32 = exps.to(torch.int32).contiguous()
    for j in range(key.spectra.shape[0]):
        blind_rotate_step(acc, e32[:, j], key.spectra[j], mode, key.decomp)
    return acc


def _switch_and_prerotate(lut_data: torch.Tensor, lwe_data: torch.Tensor, n: int):
    """Modulus switch and LUT pre-rotation shared by all rotations →
    (batch shape, mask exponents [B, n_in] in [0, 2N), acc [B, R, N], a new
    contiguous tensor)."""
    batch = tuple(lwe_data.shape[:-1])
    flat = lwe_data.reshape(-1, lwe_data.shape[-1])
    switched = modulus_switch(flat, n)                           # [B, n+1] in [0, 2N]
    exps = switched[:, :-1] & (2 * n - 1)
    acc = monomial_mul(_lut_full(lut_data, batch, flat.shape[0]),
                       (2 * n - switched[:, -1]).unsqueeze(-1))
    return batch, exps, acc.contiguous()


def blind_rotate_fused(lut_data: torch.Tensor, lwe_data: torch.Tensor,
                       key: NttBootstrapKey) -> torch.Tensor:
    """Full blind rotation, classic key (mode="delta"), in one K1 launch.
    lut_data: shared [R, N] or per-element [..., R, N] LUT(s); lwe_data
    [..., n+1].  Returns the rotated accumulator [..., R, N] int64."""
    batch, exps, acc = _switch_and_prerotate(lut_data, lwe_data, key.polynomial_size)
    out = rotate_accumulator(acc, exps, key)
    return out.reshape(batch + tuple(out.shape[-2:]))


def blind_rotate_fused_multi_bit(lut_data: torch.Tensor, lwe_data: torch.Tensor,
                                 key: NttMultiBitBootstrapKey) -> torch.Tensor:
    """Full blind rotation, multi-bit key (mode="multibit", grouping =
    key.grouping_factor), in one K3 launch; arguments and result as
    `blind_rotate_fused`."""
    n = key.polynomial_size
    batch, exps, acc = _switch_and_prerotate(lut_data, lwe_data, n)
    out = rotate_accumulator_multi_bit(
        acc, variant_exponents(exps, key.grouping_factor, n), key)
    return out.reshape(batch + tuple(out.shape[-2:]))


def blind_rotate_steps(lut_data: torch.Tensor, lwe_data: torch.Tensor,
                       key: NttBootstrapKey) -> torch.Tensor:
    """Full blind rotation, classic key, on the per-step route: one K4
    launch per step for a delta key, one K5 launch (g = 1) per step for a
    paired key (counterpart of `blind_rotate_pallas`, pallas_ntt.py:1742,
    with mxu=True, lanes=True or mxu=False).  Arguments and result as
    `blind_rotate_fused`; the accumulator is updated in place across
    steps."""
    batch, exps, acc = _switch_and_prerotate(lut_data, lwe_data, key.polynomial_size)
    out = rotate_steps(acc, exps, key)
    return out.reshape(batch + tuple(out.shape[-2:]))


def multi_bit_blind_rotate_steps(lut_data: torch.Tensor, lwe_data: torch.Tensor,
                                 key: NttMultiBitBootstrapKey) -> torch.Tensor:
    """Full blind rotation, multi-bit key, on the per-step route: one K5
    launch per step (counterpart of `multi_bit_blind_rotate_pallas`,
    pallas_ntt.py:1853, with any of its mxu and lanes settings)."""
    n = key.polynomial_size
    batch, exps, acc = _switch_and_prerotate(lut_data, lwe_data, n)
    out = rotate_steps(acc, variant_exponents(exps, key.grouping_factor, n), key)
    return out.reshape(batch + tuple(out.shape[-2:]))
