"""Encrypted order matching (counterpart of `tfhe_tpu/examples/dark_market.py`;
reference tfhe/examples/dark_market/).

Volume matching: buy and sell quantities are encrypted; the exchange
computes each order's filled amount without learning any quantity.  Two
implementations, after the reference's `fhe.rs` and
`improved_parallel_fhe.rs`:

* `volume_match`: the sequential greedy fill: total_matched = min(Σ buys,
  Σ sells), each side filled in order-book order with min and sub;
* `volume_match_parallel`: the order book on the batch axis, one
  RadixCiphertext a side; prefix sums by a Hillis–Steele scan (log2(n)
  batched adds), then every order's fill
      filled_i = min(order_i, max(0, total_other - prefix_{i-1}))
  in one batched sub / gt / cmux / min sweep.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .. import integer
from ..core.entities import LweCiphertext


def _fill_orders(sk: integer.ServerKey, orders: List, total_matched):
    """Greedy fill: filled_i = min(order_i, remaining); remaining -= filled."""
    filled = []
    remaining = total_matched
    for o in orders:
        f = sk.min(o, remaining)
        remaining = sk.sub(remaining, f)
        filled.append(f)
    return filled


def volume_match(sk: integer.ServerKey, buy_orders: List, sell_orders: List
                 ) -> Tuple[List, List]:
    """→ (filled_buys, filled_sells), the reference `volume_match`."""
    total_buy = buy_orders[0]
    for o in buy_orders[1:]:
        total_buy = sk.add(total_buy, o)
    total_sell = sell_orders[0]
    for o in sell_orders[1:]:
        total_sell = sk.add(total_sell, o)
    matched = sk.min(total_buy, total_sell)
    return _fill_orders(sk, buy_orders, matched), _fill_orders(sk, sell_orders, matched)


# ---------------------------------------------------------------------------
# the improved parallel variant (reference improved_parallel_fhe.rs:97): the
# order book rides the batch axis
# ---------------------------------------------------------------------------


def _batch_size(ct) -> int:
    return ct.blocks[0].lwe.data.shape[0]


def _shift_batch(ct, k: int):
    """The batch axis shifted down by k, filled with zero rows (an all-zero
    LWE row encrypts 0): out[i] = ct[i-k], out[:k] = 0."""
    blocks = []
    for b in ct.blocks:
        d = b.lwe.data
        blocks.append(b.with_(lwe=LweCiphertext(
            data=torch.cat([torch.zeros_like(d[:k]), d[:-k]]))))
    return type(ct)(blocks=blocks)


def _broadcast_last(ct, n: int):
    """The last batch element broadcast to a batch of n."""
    return type(ct)(blocks=[b.with_(lwe=LweCiphertext(
        data=b.lwe.data[-1].expand((n,) + tuple(b.lwe.data.shape[1:]))))
        for b in ct.blocks])


def compute_prefix_sum(sk: integer.ServerKey, orders):
    """Inclusive prefix sum over the batch axis: a Hillis–Steele scan of
    log2(n) batched additions."""
    n = _batch_size(orders)
    acc = orders
    s = 1
    while s < n:
        acc = sk.add(acc, _shift_batch(acc, s))
        s <<= 1
    return acc


def _fill_side(sk, orders, prefix_own, total_other):
    """filled_i = min(order_i, max(0, total_other - prefix_own[i-1])) for
    every order in one batched sweep (reference fill_orders)."""
    n = _batch_size(orders)
    prev = _shift_batch(prefix_own, 1)
    total_b = _broadcast_last(total_other, n)
    diff = sk.sub(total_b, prev)                      # wraps when negative...
    cond = sk.gt(total_b, prev)                       # ...but cond masks it
    zero = sk.create_trivial_zero_radix(orders.num_blocks, (n,))
    return sk.min(sk.cmux(cond, diff, zero), orders)


def volume_match_parallel(sk: integer.ServerKey, buy_orders, sell_orders):
    """`buy_orders` / `sell_orders`: one RadixCiphertext each, the batch
    axis the order book.  → (filled_buys, filled_sells) in the same form;
    each order is filled against the other side's total left after every
    earlier order (reference improved_parallel_fhe.rs:97)."""
    prefix_buy = compute_prefix_sum(sk, buy_orders)
    prefix_sell = compute_prefix_sum(sk, sell_orders)
    filled_sells = _fill_side(sk, sell_orders, prefix_sell, prefix_buy)
    filled_buys = _fill_side(sk, buy_orders, prefix_buy, prefix_sell)
    return filled_buys, filled_sells
