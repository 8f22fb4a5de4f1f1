"""LWE keyswitching, in two forms chosen from the shape, and the packing
keyswitch into a GLWE.

Counterpart of `tfhe_tpu/core/algorithms/keyswitch.py:68 keyswitch_lwe`:
out = (0, b) - sum_{i,l} d_{i,l} * KSK[i, l].  The JAX package contracts on
int8 where base_log <= 8 (`_neg_digit_mac`, :41: s8 digits, the key in byte
limbs, the limb dots recombined with wrapping shifts) and in u64 elsewhere
(`_neg_digit_mac_chunked`, :24).  The port's kernels are in
`csrc/keyswitch.cu` (its header gives the design and what bounds each):

* the tensor-core form, where `tensor_core_form` holds (228 of the 240
  named sets with a keyswitching key): the decomposition pass
  (`decompose_digits`, int8 digits) and K2′ (`neg_digit_mac_tensor_core`,
  int8 tensor cores on the key's byte limbs, `LweKeyswitchKey.limbs`);
* the wide form otherwise (base_log > 8): the torch decomposition and K2
  (`neg_digit_mac`, 64-bit multiply-adds).

Each wrapper takes its plain version for CPU tensors and launches its kernel
(or raises) for CUDA tensors: `decompose_digits_plain` (the torch
decomposition as int8) beside the pass, `neg_digit_mac_plain` on the int64
key beside both contractions.
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
wide_launches = 0        # K2, the wide form

# K2′'s block tile (csrc/keyswitch.cu): batch rows, limb columns, K bytes a
# step, and its ring of stages
_TC_ROWS, _TC_COLS, _TC_DEPTH, _TC_STAGES = 128, 128, 64, 4
_MAX_SPLITS, _MIN_SPLIT_STEPS = 8, 8


def tensor_core_form(K: int, base_log: int, log_q: int = LOG_Q) -> bool:
    """Whether a keyswitch of depth K = n_in * levels takes the tensor-core
    form: the digits fit s8 and every limb sum, at most K * 2^(b-1) * 255
    in magnitude, fits int32."""
    return base_log <= 8 and log_q == 64 and K * (1 << (base_log - 1)) * 255 < 1 << 31


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
    if data.device.type == "cuda" and tensor_core_form(n_in * levels, decomp.base_log):
        limbs = limb_layout(data.reshape(n_in * levels, M))
    return LweKeyswitchKey(data=data, decomp=decomp, limbs=limbs)


def _cuda_only(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no keyswitch kernel for device {t.device}")


def decompose_digits_plain(mask: torch.Tensor, decomp: DecompParams) -> torch.Tensor:
    """mask [B, n_in] int64 → the balanced digits [B, Kp] int8, k = i*l + j
    level-major as `signed_decompose` orders them, zeros past K = n_in*l."""
    B, n_in = mask.shape
    K = n_in * decomp.level
    digits = signed_decompose(mask, decomp).reshape(B, K).to(torch.int8)
    return F.pad(digits, (0, padded_depth(K) - K))


def decompose_digits(mask: torch.Tensor, decomp: DecompParams) -> torch.Tensor:
    """The decomposition pass's wrapper: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (or an error: there is no fallback).
    The mask may be a ciphertext's, rows apart by its stride."""
    if mask.device.type == "cpu":
        return decompose_digits_plain(mask, decomp)
    _cuda_only(mask)
    if mask.dtype != torch.int64 or mask.dim() != 2:
        raise TypeError("the mask must be an int64 torus tensor [B, n_in]")
    if not 1 <= decomp.base_log <= 8:
        raise ValueError(f"base_log {decomp.base_log}: int8 digits need 1..8")
    if mask.stride(1) != 1:
        mask = mask.contiguous()
    global decompose_launches
    B, n_in = mask.shape
    Kp = padded_depth(n_in * decomp.level)
    out = torch.empty((B, Kp), dtype=torch.int8, device=mask.device)
    code = cuda_lib.library().tfhe_keyswitch_decompose(
        mask.data_ptr(), mask.stride(0) if B > 1 else n_in, out.data_ptr(), B, n_in, Kp,
        decomp.base_log, decomp.level, cuda_lib.stream_of(mask))
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


def _tc_plan(B: int, M: int, Kp: int, sms: int) -> tuple:
    """(K steps a split, splits) for K2′: the split of K that spreads the
    block tiles most evenly over `sms` SMs.  The cost of a split is the
    most tiles an SM runs times the K steps of each, plus the steps that
    fill the ring of stages; K is split only where that gains 5% (the
    splits add into a zeroed output with atomics) and each split keeps at
    least _MIN_SPLIT_STEPS steps."""
    tiles = math.ceil(B / _TC_ROWS) * math.ceil(8 * M / _TC_COLS)
    k_steps = math.ceil(Kp / _TC_DEPTH)
    best_cost, best = math.ceil(tiles / sms) * (k_steps + _TC_STAGES), (k_steps, 1)
    for s in range(2, _MAX_SPLITS + 1):
        per = math.ceil(k_steps / s)
        if per < _MIN_SPLIT_STEPS:
            break
        used = math.ceil(k_steps / per)
        cost = math.ceil(tiles * used / sms) * (per + _TC_STAGES)
        if cost < 0.95 * best_cost:
            best_cost, best = cost, (per, used)
    return best


def neg_digit_mac_tensor_core(digits: torch.Tensor, key: torch.Tensor,
                              limbs: torch.Tensor | None, body: torch.Tensor) -> torch.Tensor:
    """K2′'s wrapper: -sum_k digits[b, k] * key[k, m] mod 2^64, plus body[b]
    at the last column.  digits [B, Kp] int8 (`decompose_digits`), key
    [K, M] int64 (the plain version's operand), limbs [M, 8, Kp] uint8 (the
    kernel's, `limb_layout(key)`), body [B] int64 → [B, M] int64.  The
    plain version for CPU tensors, the CUDA kernel for CUDA tensors (or an
    error: there is no fallback).  The digits must lie in [-2^(b-1),
    2^(b-1)) with `tensor_core_form(K, b)`: the kernel sums in int32."""
    if key.device.type == "cpu":
        return neg_digit_mac_plain(digits[:, :key.shape[0]], key, body)
    _cuda_only(key)
    global launches
    (B, Kp), (K, M) = digits.shape, key.shape
    if limbs is None:
        raise ValueError("the keyswitching key has no limb layout on the card: make it with "
                         "keyswitch.keyswitch_key")
    if (Kp != padded_depth(K) or tuple(limbs.shape) != (M, 8, Kp) or body.shape != (B,)):
        raise ValueError(f"shapes digits {tuple(digits.shape)}, key {tuple(key.shape)}, limbs "
                         f"{tuple(limbs.shape)}, body {tuple(body.shape)} disagree")
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
                             torch.cuda.get_device_properties(key.device).multi_processor_count)
    out = (torch.zeros if splits > 1 else torch.empty)((B, M), dtype=torch.int64,
                                                        device=key.device)
    code = cuda_lib.library().tfhe_keyswitch_tc(
        digits.data_ptr(), limbs.data_ptr(), body.data_ptr(), out.data_ptr(), B, M, Kp, steps,
        splits, cuda_lib.stream_of(key))
    launches += 1
    cuda_lib.check(code, "tfhe_keyswitch_tc")
    return out


def neg_digit_mac(digits: torch.Tensor, key: torch.Tensor,
                  body: torch.Tensor) -> torch.Tensor:
    """K2's wrapper, the wide form: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (or an error: there is no fallback)."""
    if key.device.type == "cpu":
        return neg_digit_mac_plain(digits, key, body)
    _cuda_only(key)
    global wide_launches
    B, K = digits.shape
    M = key.shape[1]
    if key.shape[0] != K or body.shape != (B,):
        raise ValueError(f"shapes digits {tuple(digits.shape)}, key "
                         f"{tuple(key.shape)}, body {tuple(body.shape)} disagree")
    if key.dtype != torch.int64 or body.dtype != torch.int64:
        raise TypeError("key and body must be int64 torus tensors")
    d32 = digits.to(torch.int32).contiguous()
    key, body = key.contiguous(), body.contiguous()
    for t in (d32, body):
        if t.device != key.device:
            raise ValueError("all operands must be on one device")
    out = torch.empty((B, M), dtype=torch.int64, device=key.device)
    lib = cuda_lib.library()
    code = lib.tfhe_keyswitch_mac(d32.data_ptr(), key.data_ptr(), body.data_ptr(),
                                  out.data_ptr(), B, K, M, cuda_lib.stream_of(key))
    wide_launches += 1
    cuda_lib.check(code, "tfhe_keyswitch_mac")
    return out


def contract(x: torch.Tensor, key: torch.Tensor, decomp: DecompParams, body: torch.Tensor,
             limbs: torch.Tensor | None = None) -> torch.Tensor:
    """-sum_{i,l} d_l(x_i) * key[i*L + l] mod 2^64, plus body[b] at the last
    column: x [B, n] int64 torus words (rows may be strided), key [n*L, M]
    int64, body [B] → [B, M], in the form `tensor_core_form` gives the shape:
    one decomposition pass and one K2′ launch on the card (with the key's
    `limbs`, built here if not given), or the torch decomposition and one K2
    launch."""
    B, n = x.shape
    if tensor_core_form(n * decomp.level, decomp.base_log):
        if limbs is None and key.device.type == "cuda":
            limbs = limb_layout(key)
        return neg_digit_mac_tensor_core(decompose_digits(x, decomp), key, limbs, body)
    return neg_digit_mac(signed_decompose(x, decomp).reshape(B, -1), key, body)


def keyswitch_lwe(ct: LweCiphertext, ksk: LweKeyswitchKey) -> LweCiphertext:
    """LWE(n_in) → LWE(n_out), in the form `tensor_core_form` gives the key's
    shape (one decomposition pass and one K2′ launch on the card, or the
    torch decomposition and one K2 launch)."""
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
    is `contract`'s (K2′ or K2 on the card)."""
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
