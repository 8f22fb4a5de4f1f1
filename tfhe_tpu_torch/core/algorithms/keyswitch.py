"""LWE keyswitching on the int8 tensor cores, and the packing keyswitch
into a GLWE.

Counterpart of `tfhe_tpu/core/algorithms/keyswitch.py:68 keyswitch_lwe`:
out = (0, b) - sum_{i,l} d_{i,l} * KSK[i, l].  The JAX package contracts on
int8 where base_log <= 8 (`_neg_digit_mac`, :41: s8 digits, the key in byte
limbs, the limb dots recombined with wrapping shifts) and in u64 elsewhere
(`_neg_digit_mac_chunked`, :24).  The port has one form for every base_log
up to 31 (`tensor_core_form`; all 240 named sets with a keyswitching key),
two kernels in `csrc/keyswitch.cu` (its header gives the design and what
bounds each): the decomposition pass (`decompose_digits`: each digit as
`digit_limbs(base_log)` signed bytes) and K2′ (`neg_digit_mac_tensor_core`:
the int8 tensor cores on the key's byte limbs, `LweKeyswitchKey.limbs`,
each digit limb against the key bytes it meets, K split where the depth
would pass the int32 sums).

Each wrapper takes its plain version for CPU tensors and launches its kernel
(or raises) for CUDA tensors: `decompose_digits_plain` (the torch
decomposition split into byte limbs) beside the pass,
`neg_digit_mac_plain` on the int64 key and the recombined digits beside
K2′.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ... import cuda_lib
from ..decomposition import signed_decompose
from ..entities import GlweCiphertext, LweCiphertext, LweKeyswitchKey, LwePackingKeyswitchKey
from ..numeric import LOG_Q
from ..params import DecompParams
from ..poly import monomial_mul

# Kernel launches, counted by each wrapper's CUDA branch only.
launches = 0             # K2′, the tensor-core contraction
decompose_launches = 0   # the decomposition pass

# K2′'s block tile (csrc/keyswitch.cu): batch rows, limb columns, K bytes a
# step, and the ring of stages at one digit limb
_TC_ROWS, _TC_COLS, _TC_DEPTH, _TC_STAGES = 128, 128, 64, 4
_MAX_SPLITS, _MIN_SPLIT_STEPS = 8, 8
_MAX_DIGIT_LIMBS = 4     # the kernels' instantiations (csrc/keyswitch.cu)


def digit_limbs(base_log: int) -> int:
    """The signed byte limbs a balanced digit of base_log bits takes on the
    card: the digit itself for b <= 8, else ceil((b + 1) / 8) (2 for b <=
    15, 3 for b <= 23, 4 for b <= 31), so the top limb fits s8."""
    return 1 if base_log <= 8 else (base_log + 8) // 8


def tensor_core_form(base_log: int, log_q: int = LOG_Q) -> bool:
    """Whether the card's keyswitch takes digits of base_log bits under a
    2^log_q torus: the kernels are instantiated up to 4 digit limbs."""
    return log_q == 64 and base_log >= 1 and digit_limbs(base_log) <= _MAX_DIGIT_LIMBS


def max_depth(base_log: int) -> int:
    """The deepest K whose slot sums K2′ keeps exact in int32: a slot sums
    at most 255 * sum_i max|e_i| a row of K, the digit's 2^(b-1) at one
    limb and 128 a limb above (65793 rows at b = 8; 32896, 21930 and 16448
    at 2, 3 and 4 limbs)."""
    limbs = digit_limbs(base_log)
    reach = 1 << (base_log - 1) if limbs == 1 else 128 * limbs
    return (2 ** 31 - 1) // (255 * reach)


def padded_depth(K: int) -> int:
    """K rounded up to 16 bytes, a row of digits or key bytes (every named
    set's K is a multiple of 16 already)."""
    return -(-K // 16) * 16


def limb_layout(key: torch.Tensor) -> torch.Tensor:
    """key [K, M] int64 → [M, 8, Kp] uint8: byte j of key[k, m] at [m, j, k],
    zeros for k >= K.  A reordering of the same bytes, legal on any device."""
    K, M = key.shape
    lay = key.contiguous().view(torch.uint8).view(K, M, 8).permute(1, 2, 0)
    return F.pad(lay, (0, padded_depth(K) - K)).contiguous()


def keyswitch_key(data: torch.Tensor, decomp: DecompParams) -> LweKeyswitchKey:
    """The key data [n_in, l, M] int64, with its limb layout where K2′ reads
    it: a key on the card of a set that takes the tensor-core form."""
    n_in, levels, M = data.shape
    limbs = None
    if data.device.type == "cuda" and tensor_core_form(decomp.base_log):
        limbs = limb_layout(data.reshape(n_in * levels, M))
    return LweKeyswitchKey(data=data, decomp=decomp, limbs=limbs)


def _cuda_only(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no keyswitch kernel for device {t.device}")


def split_limbs(digits: torch.Tensor, limbs: int) -> torch.Tensor:
    """Digits [..., K] int64 → their signed byte limbs [..., limbs, K] int8,
    d = sum_i e_i 2^(8i): each limb below the top is the low byte read
    signed, the rest (d - e) / 256 carries on."""
    out = []
    for _ in range(limbs - 1):
        e = ((digits & 0xFF) ^ 0x80) - 0x80
        out.append(e)
        digits = (digits - e) >> 8
    out.append(digits)
    return torch.stack(out, dim=-2).to(torch.int8)


def join_limbs(digits: torch.Tensor, K: int, limbs: int) -> torch.Tensor:
    """`decompose_digits`'s [B, limbs * Kp] int8 → the digits [B, K] int64."""
    B = digits.shape[0]
    parts = digits.reshape(B, limbs, -1)[:, :, :K].to(torch.int64)
    return sum(parts[:, i] << (8 * i) for i in range(limbs))


def decompose_digits_plain(mask: torch.Tensor, decomp: DecompParams) -> torch.Tensor:
    """mask [B, n_in] int64 → the balanced digits' signed byte limbs
    [B, D * Kp] int8, D = digit_limbs(b): limb i of digit k at column
    i * Kp + k, k = i*l + j level-major as `signed_decompose` orders them,
    zeros past K = n_in*l."""
    B, n_in = mask.shape
    K = n_in * decomp.level
    digits = split_limbs(signed_decompose(mask, decomp).reshape(B, K),
                         digit_limbs(decomp.base_log))
    return F.pad(digits, (0, padded_depth(K) - K)).reshape(B, -1)


def decompose_digits(mask: torch.Tensor, decomp: DecompParams) -> torch.Tensor:
    """The decomposition pass's wrapper: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (or an error: there is no fallback).
    The mask may be a ciphertext's, rows apart by its stride."""
    if mask.device.type == "cpu":
        return decompose_digits_plain(mask, decomp)
    _cuda_only(mask)
    if mask.dtype != torch.int64 or mask.dim() != 2:
        raise TypeError("the mask must be an int64 torus tensor [B, n_in]")
    if not tensor_core_form(decomp.base_log):
        raise ValueError(f"base_log {decomp.base_log}: the card's digits take 1..31 bits")
    if mask.stride(1) != 1:
        mask = mask.contiguous()
    global decompose_launches
    B, n_in = mask.shape
    limbs = digit_limbs(decomp.base_log)
    Kp = padded_depth(n_in * decomp.level)
    out = torch.empty((B, limbs * Kp), dtype=torch.int8, device=mask.device)
    code = cuda_lib.library().tfhe_keyswitch_decompose(
        mask.data_ptr(), mask.stride(0) if B > 1 else n_in, out.data_ptr(), B, n_in, Kp,
        decomp.base_log, decomp.level, limbs, cuda_lib.stream_of(mask))
    decompose_launches += 1
    cuda_lib.check(code, "tfhe_keyswitch_decompose")
    return out


def neg_digit_mac_plain(digits: torch.Tensor, key: torch.Tensor,
                        body: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """-sum_k digits[b, k] * key[k, m] mod 2^64, plus body[b] at the last
    column.  digits [B, K] integer, key [K, M] int64, body [B] int64 →
    [B, M] int64.  Chunked over K to bound the product buffer, like the
    JAX package's `_neg_digit_mac_chunked` (keyswitch.py:24)."""
    acc = torch.zeros((digits.shape[0], key.shape[1]), dtype=torch.int64,
                      device=key.device)
    d = digits.to(torch.int64)
    for start in range(0, key.shape[0], chunk):
        acc += (d[:, start:start + chunk, None] * key[start:start + chunk]).sum(dim=1)
    out = -acc
    out[:, -1] += body
    return out


def _tc_plan(B: int, M: int, Kp: int, sms: int, max_steps: int | None = None) -> tuple:
    """(K steps a split, splits) for K2′: the split of K that spreads the
    block tiles most evenly over `sms` SMs, with no split deeper than
    `max_steps` (the int32 limit, in steps of 64 bytes).  The cost of a
    split is the most tiles an SM runs times the K steps of each, plus the
    steps that fill the ring of stages; K is split past what the limit
    needs only where that gains 5% (the splits add into a zeroed output
    with atomics) and each such split keeps at least _MIN_SPLIT_STEPS
    steps."""
    tiles = math.ceil(B / _TC_ROWS) * math.ceil(8 * M / _TC_COLS)
    k_steps = math.ceil(Kp / _TC_DEPTH)
    least = 1 if max_steps is None else math.ceil(k_steps / max_steps)
    best_cost, best = None, None
    for s in range(least, max(least, _MAX_SPLITS) + 1):
        per = math.ceil(k_steps / s)
        if s > least and per < _MIN_SPLIT_STEPS:
            break
        used = math.ceil(k_steps / per)
        cost = math.ceil(tiles * used / sms) * (per + _TC_STAGES)
        if best is None or cost < 0.95 * best_cost:
            best_cost, best = cost, (per, used)
    return best


def neg_digit_mac_tensor_core(digits: torch.Tensor, key: torch.Tensor,
                              limbs: torch.Tensor | None, body: torch.Tensor,
                              base_log: int) -> torch.Tensor:
    """K2′'s wrapper: -sum_k d[b, k] * key[k, m] mod 2^64, plus body[b] at
    the last column, for digits d of magnitude at most 2^(base_log - 1)
    given as their D = digit_limbs(base_log) signed byte limbs: digits
    [B, D * Kp] int8 (`decompose_digits`), key [K, M] int64 (the plain
    version's operand), limbs [M, 8, Kp] uint8 (the kernel's,
    `limb_layout(key)`), body [B] int64 → [B, M] int64.  The plain version
    for CPU tensors, the CUDA kernel for CUDA tensors (or an error: there is
    no fallback).  K is split so that no split's int32 sums pass
    `max_depth(base_log)`."""
    D = digit_limbs(base_log)
    if key.device.type == "cpu":
        return neg_digit_mac_plain(join_limbs(digits, key.shape[0], D), key, body)
    _cuda_only(key)
    global launches
    (B, width), (K, M) = digits.shape, key.shape
    Kp = padded_depth(K)
    if limbs is None:
        raise ValueError("the keyswitching key has no limb layout on the card: make it with "
                         "keyswitch.keyswitch_key")
    if not tensor_core_form(base_log):
        raise ValueError(f"base_log {base_log}: the card's digits take 1..31 bits")
    if width != D * Kp or tuple(limbs.shape) != (M, 8, Kp) or body.shape != (B,):
        raise ValueError(f"shapes digits {tuple(digits.shape)}, key {tuple(key.shape)}, limbs "
                         f"{tuple(limbs.shape)}, body {tuple(body.shape)} disagree at "
                         f"{D} digit limbs")
    if (digits.dtype != torch.int8 or limbs.dtype != torch.uint8
            or body.dtype != torch.int64):
        raise TypeError("digits int8, limbs uint8 and body int64 expected")
    if not (digits.is_contiguous() and limbs.is_contiguous()):
        raise ValueError("digits and limbs must be contiguous")
    body = body.contiguous()
    for t in (digits, limbs, body):
        if t.device != key.device:
            raise ValueError("all operands must be on one device")
    steps, splits = _tc_plan(B, M, Kp,
                             torch.cuda.get_device_properties(key.device).multi_processor_count,
                             max_depth(base_log) // _TC_DEPTH)
    out = (torch.zeros if splits > 1 else torch.empty)((B, M), dtype=torch.int64,
                                                        device=key.device)
    code = cuda_lib.library().tfhe_keyswitch_tc(
        digits.data_ptr(), limbs.data_ptr(), body.data_ptr(), out.data_ptr(), B, M, Kp, D,
        steps, splits, cuda_lib.stream_of(key))
    launches += 1
    cuda_lib.check(code, "tfhe_keyswitch_tc")
    return out


def contract(x: torch.Tensor, key: torch.Tensor, decomp: DecompParams, body: torch.Tensor,
             limbs: torch.Tensor | None = None) -> torch.Tensor:
    """-sum_{i,l} d_l(x_i) * key[i*L + l] mod 2^64, plus body[b] at the last
    column: x [B, n] int64 torus words (rows may be strided), key [n*L, M]
    int64, body [B] → [B, M]: one decomposition pass and one K2′ launch on
    the card (with the key's `limbs`, built here if not given)."""
    if limbs is None and key.device.type == "cuda":
        limbs = limb_layout(key)
    return neg_digit_mac_tensor_core(decompose_digits(x, decomp), key, limbs, body,
                                     decomp.base_log)


def keyswitch_lwe(ct: LweCiphertext, ksk: LweKeyswitchKey) -> LweCiphertext:
    """LWE(n_in) → LWE(n_out): one decomposition pass and one K2′ launch on
    the card (`contract`)."""
    n_in, levels, M = ksk.data.shape
    batch = tuple(ct.data.shape[:-1])
    out = contract(ct.mask.reshape(-1, n_in), ksk.data.reshape(n_in * levels, M), ksk.decomp,
                   ct.body.reshape(-1), ksk.limbs)
    return LweCiphertext(data=out.reshape(batch + (M,)))


def packing_keyswitch_lwe_to_glwe(ct: LweCiphertext,
                                  pksk: LwePackingKeyswitchKey) -> GlweCiphertext:
    """Pack LWEs [..., n_in+1] into constant-coefficient GLWEs [..., k+1, N]
    (tfhe_tpu keyswitch.py:79; reference
    keyswitch_lwe_ciphertext_into_glwe_ciphertext): out = -sum d * PKSK,
    the body added at coefficient 0 of the body polynomial; the contraction
    is `contract`'s (the pass and K2′ on the card)."""
    n_in, levels, glwe_size, n = pksk.data.shape
    batch = tuple(ct.data.shape[:-1])
    zero = torch.zeros(ct.body.numel(), dtype=torch.int64, device=ct.data.device)
    out = contract(ct.mask.reshape(-1, n_in), pksk.data.reshape(n_in * levels, glwe_size * n),
                   pksk.decomp, zero).reshape(batch + (glwe_size, n))
    out[..., -1, 0] += ct.body
    return GlweCiphertext(data=out)


def _static_monomial_mul(polys: torch.Tensor, t) -> torch.Tensor:
    """X^t * polys for 0 <= t < N (tfhe_tpu keyswitch.py:107)."""
    return monomial_mul(polys, torch.as_tensor(t, device=polys.device))


def packing_keyswitch_lwe_list_to_glwe(cts: LweCiphertext,
                                       pksk: LwePackingKeyswitchKey) -> GlweCiphertext:
    """Pack m <= N LWEs [..., m, n_in+1] into one GLWE [..., k+1, N] with
    message i at coefficient i: sum_i X^i * KS(ct_i) (tfhe_tpu
    keyswitch.py:93)."""
    glwe = packing_keyswitch_lwe_to_glwe(cts, pksk).data        # [..., m, k+1, N]
    m = glwe.shape[-3]
    shifts = torch.arange(m, device=glwe.device).unsqueeze(-1)  # [m, 1]
    return GlweCiphertext(data=_static_monomial_mul(glwe, shifts).sum(dim=-3))
