"""Exact negacyclic polynomial products via CRT number-theoretic transforms,
as plain int64 tensor code.

Counterpart of `tfhe_tpu/core/poly/ntt.py`.  The prime pools, `primes_for`
and the plan's Garner constants are copied; the transform is the port's own:

  forward: Cooley-Tukey with the psi twist merged into the twiddles
           (Longa-Naehrig), natural order in, bit-reversed order out;
  inverse: Gentleman-Sande with psi^-1 merged, bit-reversed in, natural out,
           then a multiply by N^-1.

Spectral slot k of the forward transform holds the evaluation at
psi^(2*brv(k) + 1), so the monomial X^e is the pointwise phase
psi^(e*(2*brv(k)+1) mod 2N) there (`NttPlan.slot_odd`, `psi_pow`).  This
order equals the JAX package's DIF order.  Keys read from the JAX package
cross through standard coefficients (`interop.py`, with `dif_inverse` as
the JAX order's inverse); the `tfhe_tpu-v1` writer relies on the equality
to write the port's spectra as a JAX key (tests/test_torch_serialization.py
holds the written residues equal to the JAX package's).

Residues live in int64 tensors.  They stay below 2^30, so a product of two
is below 2^60 and the plain version may reduce with `%` (Shoup's trick in
int64 would overflow: a * w_shoup reaches 2^64).  The CUDA kernel
(`rotation.py`, `csrc/rotation.cu`) uses the same tables with 32-bit Shoup
multiplies.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..numeric import as_i64

# NTT primes just below 2^30 with p ≡ 1 (mod 2^14): negacyclic NTT up to
# N = 2^13.  Values copied from the JAX package (hazard C2 in ROADMAP.md).
PRIMES_31 = (   # name kept for source compatibility; values are 30-bit
    1073692673,
    1073643521,
    1073479681,
    1073430529,
    1073299457,
    1073233921,
    1073184769,
)

# High-N pool: p ≡ 1 (mod 2^17), so a primitive 2N-th root of unity exists
# up to N = 2^16.  Keeping PRIMES_31 above N = 8192 silently truncates psi
# and decrypts garbage.
PRIMES_HIGH_N = (
    1073479681,
    1071513601,
    1070727169,
    1068236801,
    1065484289,
    1064697857,
    1062862849,
)


def primes_for(n: int):
    """The CRT prime pool for polynomial size n (negacyclic NTT needs a
    2n-th root of unity, i.e. 2n | p - 1 for every pool prime)."""
    if n <= (1 << 13):
        return PRIMES_31
    assert n <= (1 << 16), f"N={n} exceeds the high-N prime pool's 2-adicity"
    return PRIMES_HIGH_N


def _primitive_root(p: int) -> int:
    n = p - 1
    factors = set()
    m, d = n, 2
    while d * d <= m:
        while m % d == 0:
            factors.add(d)
            m //= d
        d += 1
    if m > 1:
        factors.add(m)
    g = 2
    while True:
        if all(pow(g, n // f, p) != 1 for f in factors):
            return g
        g += 1


def required_num_primes(log_bound: float, n: int) -> int:
    """Primes of `primes_for(n)` so the CRT modulus exceeds 2^(log_bound+1)
    (signed values).  The JAX package sizes against PRIMES_31 whatever n
    (tfhe_tpu/core/poly/ntt.py:100); every named set's count is the same
    either way (tests/test_torch_ntt.py holds it)."""
    acc = 0.0
    for i, p in enumerate(primes_for(n)):
        acc += np.log2(p)
        if acc >= log_bound + 1.0:
            return i + 1
    raise ValueError(f"convolution bound 2^{log_bound} too large for prime pool")


def _bitrev(k: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(k)
    for b in range(bits):
        out |= ((k >> b) & 1) << (bits - 1 - b)
    return out


def _powers(base: int, count: int, p: int) -> np.ndarray:
    out = np.empty(count, dtype=np.int64)
    acc = 1
    for j in range(count):
        out[j] = acc
        acc = acc * base % p
    return out


class NttPlan:
    """Tables for the negacyclic NTT of size n over the first `num_primes`
    primes of `primes_for(n)`.  All arrays are numpy int64 [P, ...]."""

    def __init__(self, n: int, num_primes: int):
        assert n & (n - 1) == 0, "N must be a power of two"
        self.n = n
        self.log_n = n.bit_length() - 1
        self.primes = tuple(primes_for(n)[:num_primes])
        self.num_primes = num_primes
        P = list(self.primes)

        brv = _bitrev(np.arange(n, dtype=np.int64), self.log_n)
        self.slot_odd = 2 * brv + 1                  # slot k ↔ psi^(2 brv(k) + 1)
        self.psi, self.psi_rev, self.psi_inv_rev, self.psi_pow = [], [], [], []
        self.n_inv = []
        for p in P:
            g = _primitive_root(p)
            psi = pow(g, (p - 1) // (2 * n), p)
            pw = _powers(psi, 2 * n, p)               # psi^m, m in [0, 2N)
            inv_pw = _powers(pow(psi, p - 2, p), n, p)
            self.psi.append(psi)
            self.psi_pow.append(pw)
            self.psi_rev.append(pw[brv])
            self.psi_inv_rev.append(inv_pw[brv])
            self.n_inv.append(pow(n, p - 2, p))
        self.psi_pow = np.stack(self.psi_pow)
        self.psi_rev = np.stack(self.psi_rev)
        self.psi_inv_rev = np.stack(self.psi_inv_rev)
        self.p64 = np.array(P, dtype=np.int64).reshape(num_primes, 1)

        # Garner constants (python ints), as tfhe_tpu/core/poly/ntt.py:165-189
        self.garner_inv = []
        self.garner_weights = []
        for i in range(num_primes):
            prod = 1
            for j in range(i):
                prod *= P[j]
            self.garner_inv.append(pow(prod % P[i], P[i] - 2, P[i]) if i else 1)
            self.garner_weights.append([
                int(np.prod([1] + P[:j], dtype=object)) % P[i] for j in range(i)])
        M = 1
        for p in P:
            M *= p
        half_digits = []
        h = M // 2
        for p in P:
            half_digits.append(h % p)
            h //= p
        self.half_digits = half_digits
        prefixes = [int(np.prod([1] + P[:j], dtype=object)) for j in range(num_primes)]
        self.prefix_mod = [x & ((1 << 64) - 1) for x in prefixes]
        self.M_mod = M & ((1 << 64) - 1)
        # the 2^128 torus's constants (tfhe_tpu/core/poly/ntt.py:186-189)
        self.prefix_mod128 = [x & ((1 << 128) - 1) for x in prefixes]
        self.M_mod128 = M & ((1 << 128) - 1)
        self._dif = None
        self._device_tables = {}

    def tables(self, device) -> dict:
        """The plan's int64 tables as tensors on `device` (cached)."""
        key = str(torch.device(device))
        if key not in self._device_tables:
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            self._device_tables[key] = dict(
                p=t(self.p64), psi_rev=t(self.psi_rev),
                psi_inv_rev=t(self.psi_inv_rev), psi_pow=t(self.psi_pow),
                slot_odd=t(self.slot_odd),
                n_inv=t(np.array(self.n_inv, dtype=np.int64).reshape(-1, 1)))
        return self._device_tables[key]

    def dif_tables(self):
        """The JAX package's DIT-inverse stage tables and untwist, built as
        in tfhe_tpu/core/poly/ntt.py:132-163 (value column only)."""
        if self._dif is None:
            n = self.n
            inv_stages = [[] for _ in range(self.log_n)]
            untwists = []
            for p in self.primes:
                g = _primitive_root(p)
                psi = pow(g, (p - 1) // (2 * n), p)
                psi_inv = pow(psi, p - 2, p)
                w_inv = pow(psi * psi % p, p - 2, p)
                n_inv = pow(n, p - 2, p)
                untwists.append([pow(psi_inv, j, p) * n_inv % p for j in range(n)])
                m = 2
                for s in range(self.log_n):
                    wm_inv = pow(w_inv, n // m, p)
                    inv_stages[s].append([pow(wm_inv, j, p) for j in range(m // 2)])
                    m *= 2
            self._dif = ([np.array(s, dtype=np.int64) for s in inv_stages],
                         np.array(untwists, dtype=np.int64))
        return self._dif


@functools.lru_cache(maxsize=None)
def get_plan(n: int, num_primes: int) -> NttPlan:
    return NttPlan(n, num_primes)


# ---------------------------------------------------------------------------
# transforms — residues are int64 [..., P, N], values in [0, p)
# ---------------------------------------------------------------------------


def reduce(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """int64 values [..., N] (small digits or torus values as signed
    representatives) → residues [..., P, N]."""
    p = plan.tables(x.device)["p"]
    return torch.remainder(x.unsqueeze(-2), p)


def ntt_forward(plan: NttPlan, v: torch.Tensor) -> torch.Tensor:
    """Residues [..., P, N], natural order → spectra, bit-reversed order."""
    tab = plan.tables(v.device)
    n, P = plan.n, plan.num_primes
    lead = v.shape[:-2]
    p = tab["p"].unsqueeze(-1)                              # [P, 1, 1]
    m, t = 1, n // 2
    while m < n:
        v = v.reshape(lead + (P, m, 2, t))
        s = tab["psi_rev"][:, m:2 * m].unsqueeze(-1)        # [P, m, 1]
        u, w = v[..., 0, :], v[..., 1, :] * s % p
        v = torch.stack([(u + w) % p, (u - w) % p], dim=-2)
        m, t = 2 * m, t // 2
    return v.reshape(lead + (P, n))


def ntt_inverse(plan: NttPlan, v: torch.Tensor) -> torch.Tensor:
    """Spectra [..., P, N], bit-reversed order → residues, natural order."""
    tab = plan.tables(v.device)
    n, P = plan.n, plan.num_primes
    lead = v.shape[:-2]
    p = tab["p"].unsqueeze(-1)
    h, t = n // 2, 1
    while h >= 1:
        v = v.reshape(lead + (P, h, 2, t))
        s = tab["psi_inv_rev"][:, h:2 * h].unsqueeze(-1)    # [P, h, 1]
        u, w = v[..., 0, :], v[..., 1, :]
        v = torch.stack([(u + w) % p, (u - w) % p * s % p], dim=-2)
        h, t = h // 2, 2 * t
    return v.reshape(lead + (P, n)) * tab["n_inv"] % tab["p"]


def dif_inverse(plan: NttPlan, v: torch.Tensor) -> torch.Tensor:
    """Inverse of the JAX package's DIF forward transform
    (tfhe_tpu/core/poly/ntt.py:282 ntt_inverse): spectra [..., P, N] in its
    scrambled order → residues in natural order."""
    stages, untwist = plan.dif_tables()
    n, P = plan.n, plan.num_primes
    lead = v.shape[:-2]
    p = torch.tensor(plan.p64, device=v.device).unsqueeze(-1)    # [P, 1, 1]
    m = 2
    for st in range(plan.log_n):
        half = m // 2
        v = v.reshape(lead + (P, n // m, m))
        w = torch.from_numpy(stages[st]).to(v.device)[:, None, :]
        lo, hi = v[..., :half], v[..., half:] * w % p
        v = torch.cat([(lo + hi) % p, (lo - hi) % p], dim=-1)
        m *= 2
    v = v.reshape(lead + (P, n))
    return v * torch.from_numpy(untwist).to(v.device) % p.squeeze(-1)


def _garner_digits(plan: NttPlan, res: torch.Tensor) -> tuple:
    """CRT residues [..., P, N] → (mixed-radix digits t_i [..., N] int64,
    the signed-lift predicate value >= M/2), as tfhe_tpu
    ntt.py `_garner_digits`."""
    P = plan.num_primes
    v = [res[..., i, :] for i in range(P)]
    t = [v[0]]
    for i in range(1, P):
        pi = plan.primes[i]
        acc = torch.zeros_like(v[i])
        for j in range(i):
            acc = (acc + t[j] * plan.garner_weights[i][j]) % pi
        t.append((v[i] - acc) % pi * plan.garner_inv[i] % pi)
    ge = torch.zeros(t[0].shape, dtype=torch.bool, device=res.device)
    eq = torch.ones(t[0].shape, dtype=torch.bool, device=res.device)
    for i in reversed(range(P)):
        h = plan.half_digits[i]
        ge = ge | (eq & (t[i] > h))
        eq = eq & (t[i] == h)
    return t, ge | eq


def garner_to_torus(plan: NttPlan, res: torch.Tensor) -> torch.Tensor:
    """CRT residues [..., P, N] → the signed-lifted integer mod 2^64 [..., N]
    (int64), as tfhe_tpu/core/poly/ntt.py:351 garner_to_torus."""
    t, lift = _garner_digits(plan, res)
    c = torch.zeros_like(t[0])
    for i in range(plan.num_primes):
        c = c + t[i] * as_i64(plan.prefix_mod[i])
    return torch.where(lift, c - as_i64(plan.M_mod), c)


def negacyclic_polymul(a: torch.Tensor, b: torch.Tensor,
                       log_bound: float | None = None) -> torch.Tensor:
    """Exact negacyclic product of int64 polynomials mod 2^64 (a, b [..., N],
    broadcastable), as tfhe_tpu/core/poly/ntt.py:432 negacyclic_polymul."""
    n = a.shape[-1]
    if log_bound is None:
        log_bound = 2 * 64 + np.log2(n)
    plan = get_plan(n, required_num_primes(log_bound, n))
    p = plan.tables(a.device)["p"]
    a_hat = ntt_forward(plan, reduce(plan, a))
    b_hat = ntt_forward(plan, reduce(plan, b))
    return garner_to_torus(plan, ntt_inverse(plan, a_hat * b_hat % p))


# ---------------------------------------------------------------------------
# the 2^128 torus (tfhe_tpu/core/poly/ntt.py:388-430): the same transforms
# over more primes; only the reduction and the reconstruction differ
# ---------------------------------------------------------------------------


def _reduce_torus128(x128: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """128-bit torus values [..., N, 2] → residues [..., P, N] of their
    signed representatives (hi as int64) * 2^64 + lo (lo unsigned)."""
    p = plan.tables(x128.device)["p"]                            # [P, 1]
    hi = x128[..., 0].unsqueeze(-2)
    lo = x128[..., 1].unsqueeze(-2)
    two64 = torch.tensor([[pow(2, 64, q)] for q in plan.primes], dtype=torch.int64,
                         device=x128.device)
    r_lo = (torch.remainder(lo, p) + (lo < 0).to(torch.int64) * two64) % p
    return (torch.remainder(hi, p) * two64 + r_lo) % p


def ntt_forward128(plan: NttPlan, x128: torch.Tensor) -> torch.Tensor:
    """128-bit torus polynomials [..., N, 2] → spectra [..., P, N]."""
    return ntt_forward(plan, _reduce_torus128(x128, plan))


def garner_to_torus128(plan: NttPlan, res: torch.Tensor) -> torch.Tensor:
    """CRT residues [..., P, N] → the signed-lifted value mod 2^128
    [..., N, 2]: sum_i t_i * (prod_{j<i} p_j mod 2^128), less M mod 2^128
    where the lift is negative (M itself exceeds 2^128)."""
    from ..u128 import add128, mul_u64_by_u128, sub128, where128
    t, lift = _garner_digits(plan, res)
    c = mul_u64_by_u128(t[0], 0, 1)
    for i in range(1, plan.num_primes):
        pref = plan.prefix_mod128[i]
        c = add128(c, mul_u64_by_u128(t[i], pref >> 64, pref & ((1 << 64) - 1)))
    m = plan.M_mod128
    m_arr = mul_u64_by_u128(torch.ones((), dtype=torch.int64, device=res.device), m >> 64,
                            m & ((1 << 64) - 1))
    return where128(lift, sub128(c, m_arr.expand_as(c)), c)


def negacyclic_polymul128(a128: torch.Tensor, b: torch.Tensor,
                          log_bound: float) -> torch.Tensor:
    """Exact negacyclic product of a 128-bit polynomial [..., N, 2] with a
    small-integer polynomial [..., N], mod 2^128 (tfhe_tpu ntt.py:416)."""
    n = a128.shape[-2]
    plan = get_plan(n, required_num_primes(log_bound, n))
    p = plan.tables(a128.device)["p"]
    a_hat = ntt_forward128(plan, a128)
    b_hat = ntt_forward(plan, reduce(plan, b))
    return garner_to_torus128(plan, ntt_inverse(plan, a_hat * b_hat % p))


__all__ = ["PRIMES_31", "PRIMES_HIGH_N", "primes_for", "required_num_primes",
           "NttPlan", "get_plan", "reduce", "ntt_forward",
           "ntt_inverse", "dif_inverse", "garner_to_torus",
           "negacyclic_polymul", "ntt_forward128", "garner_to_torus128",
           "negacyclic_polymul128"]
