"""Threefry-2x32 streams, bit for bit the JAX package's seeded randomness.

Counterpart of the threefry side of `tfhe_tpu/core/rng.py:26-51`
(`key_from_seed`, `fork`, `split`, `uniform_torus`, `binary_key`), which
draws through `jax.random` with `jax_threefry_partitionable` on (the
default of jax 0.9).  The specification is jax's own source
(`jax/_src/prng.py`: `threefry_seed`, `_threefry2x32_lowering`,
`_threefry_split_foldlike`, `_threefry_fold_in`,
`_threefry_random_bits_partitionable`; `jax/_src/random.py` `_bernoulli`):

  * a key is two 32-bit words (k0, k1); `key_from_seed(s)` is (0, s mod 2^32);
  * `fold_in(k, d)` is threefry2x32 under k of the counter pair (0, d);
  * `split(k, n)[i]` is threefry2x32 under k of (hi(i), lo(i)), the 64-bit
    index i split into words, so for i < 2^32 it equals `fold_in(k, i)`
    (under jax's older, non-partitionable split it would not);
  * random words of a shape: element e (row-major flat index) is
    out0 ^ out1 of the counter pair (hi(e), lo(e));
  * `uniform_torus(k, shape)` draws the words of (2,) + shape and joins
    (w[0] << 32) | w[1]; at log_q = 32 it is the words of shape
    (`jax.random.bits(k, shape, uint32)`), lifted by 2^32;
  * `binary_key(k, shape)` is `bernoulli(k, 0.5)`, whose uniform is float64
    from the 64-bit bits (out0 << 32) | out1: the bit is 1 where out0's top
    bit is 0.

Keys are int64 tensors [..., 2] holding the two words, so one call serves
a whole key tree: a draw under keys [..., 2] gives [..., *shape].  Words
are uint32 values held in int64 and masked after every add and shift
(torch has no unsigned 32-bit arithmetic).  Draws run on the key's device
in passes of at most `CHUNK` threefry evaluations, which bounds every
temporary to a few hundred MB.  Gaussian noise is not reproduced: it comes
from `torch.Generator`s (`core/rng.py`).
"""
from __future__ import annotations

import math

import torch

from .numeric import check_log_q

CHUNK = 1 << 22                 # threefry evaluations a pass
_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA            # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """The 20-round Threefry-2x32 hash of counter words (x0, x1) under key
    words (k0, k1): int64 tensors of uint32 values, broadcastable → (out0,
    out1), uint32 values in int64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            left = (x1 << r).bitwise_and_(_M32)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(left).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M32)
    return x0, x1


def key_from_seed(seed: int, device) -> torch.Tensor:
    """The key of a seed: (0, seed mod 2^32), int64 [2]."""
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """keys [..., 2] → the keys folded with `data` (jax.random.fold_in)."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    out0, out1 = threefry2x32(key[..., 0], key[..., 1], zero, zero + (data & _M32))
    return torch.stack([out0, out1], dim=-1)


def fork(key: torch.Tensor, *indices: int) -> torch.Tensor:
    """A substream: `fold_in` by each index in turn (tfhe_tpu rng.fork)."""
    for i in indices:
        key = fold_in(key, i)
    return key


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """keys [..., 2] → [..., n, 2] (jax.random.split)."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    out0, out1 = threefry2x32(key[..., 0, None], key[..., 1, None], idx >> 32, idx & _M32)
    return torch.stack([out0, out1], dim=-1)


def _draw(key: torch.Tensor, shape, torus: bool, out: torch.Tensor | None,
          rows: tuple | None, lifted: bool = False) -> torch.Tensor:
    """The draw of `uniform_torus` (torus; `lifted`: the 32-bit words of
    shape, each times 2^32) or `binary_key` under keys
    [..., 2] over `shape`, or only rows [r0, r1) of its leading axis, into
    `out` (strided views allowed where the key axes merge) or a new tensor,
    in passes of whole rows of the leading axis."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        raise ValueError("draws need a shape of at least one axis")
    r0, r1 = (0, shape[0]) if rows is None else rows
    if not 0 <= r0 <= r1 <= shape[0]:
        raise ValueError(f"rows {rows} lie outside the leading axis of {shape}")
    part = (r1 - r0,) + shape[1:]
    lead = tuple(key.shape[:-1])
    if out is None:
        out = torch.empty(lead + part, dtype=torch.int64, device=key.device)
    elif tuple(out.shape) != lead + part or out.dtype != torch.int64:
        raise ValueError(f"out is {out.dtype} {tuple(out.shape)}, not int64 {lead + part}")
    keys = key.reshape(-1, 2)
    R, size = keys.shape[0], math.prod(shape)
    if R == 0 or math.prod(part) == 0:
        return out
    inner = size // shape[0]
    view = out.view((R,) + part)
    join = torus and not lifted            # two words an element
    per = CHUNK // (2 if join else 1)
    if (r1 - r0) * inner <= per:
        step, kb = r1 - r0, per // ((r1 - r0) * inner)
    else:
        step, kb = max(1, per // inner), 1
    for k in range(0, R, kb):
        k0, k1 = keys[k:k + kb, 0, None], keys[k:k + kb, 1, None]
        for i0 in range(r0, r1, step):
            i1 = min(i0 + step, r1)
            ctr = torch.arange(i0 * inner, i1 * inner, dtype=torch.int64, device=key.device)
            if join:
                ctr = torch.cat([ctr, ctr + size])
            out0, out1 = threefry2x32(k0, k1, ctr >> 32, ctr & _M32)
            if lifted:
                val = out0.bitwise_xor_(out1) << 32
            elif torus:
                words = out0.bitwise_xor_(out1)
                half = words.shape[1] // 2
                val = (words[:, :half] << 32) | words[:, half:]
            else:
                val = (out0 >> 31).eq_(0)
            view[k:k + kb, i0 - r0:i1 - r0] = val.view((val.shape[0], i1 - i0) + shape[1:])
    return out


def uniform_torus(key: torch.Tensor, shape, out: torch.Tensor | None = None,
                  rows: tuple | None = None, log_q: int = 64) -> torch.Tensor:
    """Uniform torus words under keys [..., 2]: int64 [..., *shape], those
    of tfhe_tpu rng.uniform_torus(key, shape, log_q) for each key, lifted
    at log_q = 32 (with rows=(r0, r1), only rows r0..r1-1 of the leading
    axis)."""
    return _draw(key, shape, True, out, rows, lifted=check_log_q(log_q) == 32)


def binary_key(key: torch.Tensor, shape, out: torch.Tensor | None = None,
               rows: tuple | None = None) -> torch.Tensor:
    """Uniform key bits under keys [..., 2]: int64 0/1 [..., *shape], those
    of tfhe_tpu rng.binary_key(key, shape) for each key (with rows=(r0, r1),
    only rows r0..r1-1 of the leading axis)."""
    return _draw(key, shape, False, out, rows)


__all__ = ["CHUNK", "threefry2x32", "key_from_seed", "fold_in", "fork", "split",
           "uniform_torus", "binary_key"]
