"""K6's cluster step (`csrc/rotation.cu` `cluster_step`): its layout
(`rotation._cluster_layout`), the rule that picks it (`rotation._k6_layout`,
`rotation._cluster_rule`) and its index maps, run in numpy with the
kernel's own indexing.  No JAX: the kernel runs only on the card, and
`chip_smoke.py` holds it there against the plain rotation; here the maps it
follows are held against the port's transforms (`ntt.py`) and its plain
step.

The model mirrors the kernel.  A cluster of C blocks owns a ciphertext;
block q keeps the region [q*W, (q+1)*W), W = N/C, of every polynomial,
each slot at its swizzled word relative to the region.  The exchange: item
(r, off), off in block q's column share, takes the C words off + k*W
through the top log2 C forward stages (heap node 1) and writes output k to
block k.  Inside a block, head passes over the region and tail passes over
tail regions of 2^log_t slots (heap nodes of the whole transform), then the
MAC's two stages; the inverse mirrors them, and the gather takes slot off
of every block through the bottom log2 C inverse stages."""
import numpy as np
import pytest
import torch

from test_torch_delta_plan import (csub, ct, garner, gs, mul_lazy, mul_shoup, pass_positions,
                                   prime_tables, swizzle, twiddles)
from test_torch_kernel_coverage import SHAPES
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.poly import ntt, rotation


def region_word(off, k, log_w):
    """Where block k keeps slot `off` of its region (region_word in
    rotation.cu)."""
    return swizzle(off + (k << log_w)) - (k << log_w)


def region_pass(blocks, lay, lo, r, table, p, forward):
    """A pass at stride 2^lo over every block's region of every polynomial
    (blocks [C][npoly][W]): items it < W/2^r of block q are heap block
    (q*W >> (lo + r)) + (it >> lo), offset it mod 2^lo (region_pass)."""
    C, npoly, W = blocks.shape
    log_w = W.bit_length() - 1
    q, poly, it = np.meshgrid(np.arange(C), np.arange(npoly), np.arange(W >> r), indexing="ij")
    blk = ((q << log_w) >> (lo + r)) + (it >> lo)
    node = (1 << (lay.log_n - lo - r)) + blk
    pos = [swizzle(x) - (q << log_w) for x in pass_positions(lo, r, blk, it & ((1 << lo) - 1))]
    a = [blocks[q, poly, x] for x in pos]
    (ct if forward else gs)(a, twiddles(table, node, r, p), r, p)
    for x, v in zip(pos, a):
        blocks[q, poly, x] = v


def tail_passes(blocks, lay, table, p, forward):
    """The tail passes of every tail region (one warp each): tail region gi
    of block q starts at tb = q*W + gi*2^log_t; the same items as a region
    pass, confined to it."""
    C, npoly, W = blocks.shape
    log_w, log_t = lay.log_w, lay.log_t
    los, lo = [], log_t
    for r in lay.tail:
        lo -= r
        los.append((lo, r))
    for lo, r in (los if forward else los[::-1]):
        q, poly, gi, it = np.meshgrid(np.arange(C), np.arange(npoly), np.arange(W >> log_t),
                                      np.arange(1 << (log_t - r)), indexing="ij")
        tb = (q << log_w) + (gi << log_t)
        blk = (tb >> (lo + r)) + (it >> lo)
        pos = pass_positions(lo, r, blk, it & ((1 << lo) - 1))
        assert all(((x >= tb) & (x < tb + (1 << log_t))).all() for x in pos)
        words = [swizzle(x) - (q << log_w) for x in pos]
        a = [blocks[q, poly, x] for x in words]
        (ct if forward else gs)(a, twiddles(table, (1 << (lay.log_n - lo - r)) + blk, r, p), r, p)
        for x, v in zip(words, a):
            blocks[q, poly, x] = v


def head_los(lay):
    out, top = [], lay.log_w
    for r in lay.head:
        out.append((top - r, r))
        top -= r
    return out


def cluster_forward(lay, table, p, polys):
    """Natural-order residues [J][N] → slot-order spectra, fully reduced:
    the exchange, the region's head and tail passes, the MAC's first two
    stages."""
    C, log_w, W = lay.cluster, lay.log_w, 1 << lay.log_w
    cl = C.bit_length() - 1
    blocks = np.zeros((C, polys.shape[0], W), dtype=np.uint64)
    off = np.arange(W)
    a = [polys[:, off + (k << log_w)].copy() for k in range(C)]
    ct(a, twiddles(table, 1, cl, p), cl, p)
    for k in range(C):
        blocks[k][:, region_word(off, k, log_w)] = a[k]
    for lo, r in head_los(lay):
        region_pass(blocks, lay, lo, r, table, p, True)
    tail_passes(blocks, lay, table, p, True)
    n = C * W
    x = np.arange(n // 4)
    q = x // (W // 4)
    out = np.zeros_like(polys)
    tw = twiddles(table, n // 4 + x, 2, p)
    for j in range(polys.shape[0]):
        b = [blocks[q, j, swizzle(4 * x + c) - (q << log_w)] for c in range(4)]
        ct(b, tw, 2, p)
        for c in range(4):
            out[j, 4 * x + c] = csub(csub(b[c], 2 * p), p)
    return out


def cluster_inverse(lay, table, p, spectra):
    """Slot-order products [R][N] in [0, 2p) → natural-order residues times
    N: the MAC's inverse stages, the tail and head passes bottom up, the
    gather (reduced to [0, p))."""
    C, log_w, W = lay.cluster, lay.log_w, 1 << lay.log_w
    cl, n = C.bit_length() - 1, C * W
    blocks = np.zeros((C, spectra.shape[0], W), dtype=np.uint64)
    x = np.arange(n // 4)
    q = x // (W // 4)
    tw = twiddles(table, n // 4 + x, 2, p)
    for r in range(spectra.shape[0]):
        b = [spectra[r, 4 * x + c].copy() for c in range(4)]
        gs(b, tw, 2, p)
        for c in range(4):
            blocks[q, r, swizzle(4 * x + c) - (q << log_w)] = b[c]
    tail_passes(blocks, lay, table, p, False)
    for lo, r in head_los(lay)[::-1]:
        region_pass(blocks, lay, lo, r, table, p, False)
    off = np.arange(W)
    a = [blocks[k][:, region_word(off, k, log_w)] for k in range(C)]
    gs(a, twiddles(table, 1, cl, p), cl, p)
    out = np.zeros_like(spectra)
    for k in range(C):
        out[:, off + (k << log_w)] = csub(a[k], p)
    return out


# ---- ownership: regions, column shares, the words sent and gathered --------

LAYOUTS = [(64, 2, 2, 2, 2, 1), (512, 2, 4, 4, 4, 2), (4096, 2, 4, 4, 2, 4),
           (8192, 2, 4, 4, 4, 4), (32768, 2, 4, 4, 16, 4), (32768, 2, 6, 4, 8, 1),
           (65536, 2, 4, 4, 16, 1), (1024, 3, 6, 3, 8, 3)]


@pytest.mark.parametrize("n, R, J, P, C, group", LAYOUTS)
def test_regions_and_column_shares_cover_every_slot_once(n, R, J, P, C, group):
    lay = rotation._cluster_layout(n, R, J, P, C, group)
    W = n // C
    assert lay.log_w == (W.bit_length() - 1) and W >= 32
    regions = np.zeros(n, dtype=np.int64)
    shares = np.zeros(n, dtype=np.int64)
    groups = np.zeros(n // 4, dtype=np.int64)
    for q in range(C):
        regions[q * W:(q + 1) * W] += 1
        off = np.arange(q * (W // C), (q + 1) * (W // C))
        for k in range(C):
            shares[off + k * W] += 1        # the words block q reads and lifts
        for gi in range(W >> lay.log_t):   # one warp's tail region and its MAC groups
            tb = q * W + (gi << lay.log_t)
            groups[tb // 4:(tb + (1 << lay.log_t)) // 4] += 1
    assert (regions == 1).all() and (shares == 1).all() and (groups == 1).all()


@pytest.mark.parametrize("n, R, J, P, C, group", LAYOUTS)
def test_words_sent_and_gathered_are_the_regions_words(n, R, J, P, C, group):
    """The exchange writes coefficient off + k*W to block k at the word
    where the block's passes read it (the whole transform's swizzle,
    relative to the region), each word of a region once; the gather reads
    the same words."""
    lay = rotation._cluster_layout(n, R, J, P, C, group)
    W = n // C
    for k in range(C):
        words = region_word(np.arange(W), k, lay.log_w)
        assert sorted(words) == list(range(W))
        for lo, r in head_los(lay) + [(lay.log_t - 2, 2)]:
            blk = ((k * W) >> (lo + r)) + (np.arange(W >> r) >> lo)
            for x in pass_positions(lo, r, blk, np.arange(W >> r) & ((1 << lo) - 1)):
                assert ((x >= k * W) & (x < (k + 1) * W)).all()
                assert np.array_equal(swizzle(x) - k * W, region_word(x - k * W, k, lay.log_w))


def test_layout_covers_every_stage_once():
    for s in SHAPES:
        lay = rotation._shape_plan(s.n, s.R, s.L, s.base_log, s.P, s.variants)[1]
        if not isinstance(lay, rotation.ClusterLayout):
            continue
        cl = lay.cluster.bit_length() - 1
        assert cl + sum(lay.head) + sum(lay.tail) + 2 == lay.log_n
        assert lay.log_t == lay.log_w - sum(lay.head) and 5 <= lay.log_t <= 8
        assert all(1 <= r <= 3 for r in lay.head + lay.tail)


# ---- the transforms ---------------------------------------------------------

@pytest.mark.parametrize("n, C", [(4096, 2), (8192, 4), (16384, 8), (32768, 16), (8192, 2),
                                  (512, 16)])
def test_cluster_passes_reproduce_the_transforms_for_every_prime(n, C):
    P = 4
    plan = ntt.get_plan(n, P)
    lay = rotation._cluster_layout(n, 2, 2, P, C, 1)
    tab = rotation._delta_tables(plan, "cpu")
    rng = np.random.default_rng(n + C)
    for pi, prime in enumerate(plan.primes):
        p = np.uint64(prime)
        fwd, inv, _ = prime_tables(tab, P, n, pi)
        x = rng.integers(0, prime, (1, n), dtype=np.int64)
        want = ntt.ntt_forward(plan, torch.from_numpy(x).unsqueeze(1).expand(1, P, n).contiguous())
        got = cluster_forward(lay, fwd, p, x.astype(np.uint64))
        assert np.array_equal(got.astype(np.int64), want[:, pi].numpy())
        back = cluster_inverse(lay, inv, p, got)
        assert np.array_equal(back.astype(np.int64) * plan.n_inv[pi] % prime, x)


def simulate_step(acc, e, key, decomp, P, lay, variants):
    """One step of the cluster step on one ciphertext: acc [R][N] uint64,
    e (delta: the exponent; variants: c_1..c_{V-1}), key [P][J][R][N] (or
    [V][P][J][R][N]) → the new acc."""
    R, n = acc.shape
    L, base_log = decomp.level, decomp.base_log
    J = L * R
    plan = ntt.get_plan(n, P)
    tab = rotation._delta_tables(plan, "cpu", variants)
    cs = rotation._host_consts(plan)
    shift = 64 - base_log * L
    digits = np.zeros((J, n), dtype=np.int64)
    st = (acc + np.uint64(1 << (shift - 1))) >> np.uint64(shift) if shift > 0 else acc.copy()
    for lvl in reversed(range(L)):
        raw = st & np.uint64((1 << base_log) - 1)
        carry = (raw + np.uint64(1 << (base_log - 1))) >> np.uint64(base_log)
        digits[lvl * R:(lvl + 1) * R] = (raw.astype(np.int64)
                                         - (carry << np.uint64(base_log)).astype(np.int64))
        st = (st >> np.uint64(base_log)) + carry
    res = np.zeros((P, R, n), dtype=np.uint64)
    for pi, prime in enumerate(plan.primes):
        p = np.uint64(prime)
        fwd, inv, ph = prime_tables(tab, P, n, pi)
        spec = cluster_forward(lay, fwd, p, np.where(digits < 0, digits + prime,
                                                     digits).astype(np.uint64))
        for r in range(R):
            if variants:
                total = np.zeros(n, dtype=np.uint64)
                for v in range(key.shape[0]):
                    m = (int(e[v - 1]) * plan.slot_odd) % (2 * n) if v else np.zeros(n, int)
                    s = np.zeros(n, dtype=np.uint64)
                    for j in range(J):
                        d = mul_shoup(spec[j], (ph[m, 0], ph[m, 1], p))
                        s = s + d * key[v, pi, j, r].astype(np.uint64)
                    total = (total + s % p) % p
                res[pi, r] = total
            else:
                m = (e * plan.slot_odd) % (2 * n)
                s = np.zeros(n, dtype=np.uint64)
                for j in range(J):
                    s = s + spec[j] * key[pi, j, r].astype(np.uint64)
                res[pi, r] = mul_lazy(s % p, (ph[m, 0], ph[m, 1], p))
        res[pi] = cluster_inverse(lay, inv, p, res[pi])
    lifted = garner(cs, res, P)
    return lifted if variants else acc + lifted


@pytest.mark.parametrize("n, R, L, base_log, P, C, group, g",
                         [(256, 2, 1, 23, 4, 2, 4, 0), (512, 3, 3, 6, 3, 4, 1, 0),
                          (64, 2, 2, 10, 2, 2, 1, 0), (512, 2, 2, 10, 4, 16, 2, 0),
                          (256, 2, 2, 12, 4, 4, 4, 1), (512, 2, 1, 20, 3, 8, 3, 3)])
def test_simulated_step_equals_the_plain_step(n, R, L, base_log, P, C, group, g):
    rng = np.random.default_rng(n + C + g)
    decomp = DecompParams(base_log=base_log, level=L)
    plan = ntt.get_plan(n, P)
    lay = rotation._cluster_layout(n, R, L * R, P, C, group)
    lead = (1 << g,) if g else ()
    key = np.stack([rng.integers(0, p, lead + (L * R, R, n)) for p in plan.primes],
                   axis=len(lead))
    acc = rng.integers(0, 2 ** 64, (2, R, n), dtype=np.uint64)
    acc[0, 0, :4] = [0, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1]
    e = rng.integers(0, 2 * n, (2, (1 << g) - 1)) if g else np.array([rng.integers(0, 2 * n), 0])
    want = rotation.blind_rotate_step_plain(from_numpy_u64(acc), torch.from_numpy(e),
                                            torch.from_numpy(key).to(torch.int32),
                                            "variants" if g else "delta", decomp)
    got = np.stack([simulate_step(acc[b], e[b], key, decomp, P, lay, bool(g))
                    for b in range(2)])
    assert np.array_equal(got, to_numpy_u64(want))


# ---- the rule: which form and cluster each named set takes ------------------

# (N, J, P, 2^g or 0) of the 65 named sets beyond one block → (C, prime
# group) of the cluster step, or "passes"; the number of sets.  Blocks of
# at most 116,224 B (two a SM) where a cluster of 8 or fewer gives them
# every prime: 3_3 and its multi-bit sets at C = 8 (98,304 B)
RULE = {(4096, 4, 4, 0): ((4, 4), 4), (8192, 2, 4, 0): ((8, 4), 4),
        (8192, 4, 4, 0): ((8, 4), 11), (8192, 4, 4, 4): ((8, 4), 1),
        (8192, 4, 4, 8): ((8, 4), 1), (8192, 6, 3, 0): ((8, 3), 1),
        (16384, 4, 4, 0): ((8, 4), 15), (16384, 6, 4, 0): ((16, 4), 2),
        (32768, 4, 4, 0): ((16, 4), 13), (32768, 6, 4, 0): ((16, 2), 7),
        (65536, 4, 4, 0): ((16, 1), 2), (65536, 6, 4, 0): ((16, 1), 3),
        (65536, 8, 4, 0): ("passes", 1)}


def test_rule_gives_each_named_set_beyond_one_block_its_form():
    seen = {}
    for s in SHAPES:
        route, lay = rotation._shape_plan(s.n, s.R, s.L, s.base_log, s.P, s.variants)
        if route != "staged":
            continue
        assert s.R == 2
        form = ((lay.cluster, lay.group) if isinstance(lay, rotation.ClusterLayout)
                else "passes")
        key = (s.n, s.J, s.P, s.variants)
        assert RULE[key][0] == form, (s.name, form)
        seen[key] = seen.get(key, 0) + 1
        assert lay.smem <= rotation._SMEM_LIMIT
        if form != "passes":
            assert lay.smem == 4 * (lay.group * s.J + s.P * s.R) * s.n // lay.cluster
    assert seen == {k: v[1] for k, v in RULE.items()}
    assert sum(seen.values()) == 65
    assert sum(v for k, v in seen.items() if RULE[k][0] != "passes") == 64


def test_every_set_up_to_n_32768_takes_the_cluster_step_and_per_step_too():
    count = 0
    for s in SHAPES:
        if s.n > 32768 or rotation._shape_plan(s.n, s.R, s.L, s.base_log, s.P,
                                               s.variants)[0] != "staged":
            continue
        count += 1
        assert isinstance(rotation._shape_plan(s.n, s.R, s.L, s.base_log, s.P, s.variants)[1],
                          rotation.ClusterLayout)
        if s.n <= 8192:
            lay = rotation._shape_plan(s.n, s.R, s.L, s.base_log, s.P, s.variants,
                                       per_step=True)[1]
            assert isinstance(lay, rotation.ClusterLayout)
    assert count == 59


def test_forms_can_be_asked_for():
    assert isinstance(rotation._k6_layout(8192, 2, 4, 4, 0, "passes"), rotation.StagedLayout)
    lay = rotation._k6_layout(8192, 2, 4, 4, 0, (2, 1))
    assert (lay.cluster, lay.group, lay.head, lay.tail, lay.log_t) == (2, 1, (2, 2), (3, 3), 8)
    assert lay.smem == 4 * (4 + 8) * 4096
    lay = rotation._k6_layout(2048, 2, 2, 4, 0, (4, 4))
    assert (lay.cluster, lay.group, lay.smem) == (4, 4, 4 * (4 * 2 + 4 * 2) * 512)
    with pytest.raises(ValueError, match="delta steps only"):
        rotation._k6_layout(8192, 2, 4, 4, 8, "passes")


@pytest.mark.parametrize("n, R, J, P, C, group, match", [
    (8192, 2, 4, 4, 2, 2, "shared memory"), (8192, 2, 4, 4, 32, 1, "clusters of"),
    (8192, 2, 4, 5, 4, 1, "P <= 4"), (8192, 2, 4, 4, 4, 3, "group dividing P"),
    (8192, 5, 5, 4, 4, 1, "R <= 4"), (256, 2, 2, 2, 16, 1, "below 32"),
    (65536, 2, 8, 4, 16, 1, "shared memory")])
def test_cluster_layout_refuses_what_the_kernel_does_not_take(n, R, J, P, C, group, match):
    with pytest.raises(ValueError, match=match):
        rotation._cluster_layout(n, R, J, P, C, group)


def test_no_cluster_means_the_passes_form_for_delta_and_an_error_for_variants():
    assert rotation._cluster_rule(65536, 2, 8, 4) is None
    assert rotation._cluster_rule(8192, 2, 4, 5) is None
    assert isinstance(rotation._k6_layout(65536, 2, 8, 4, 0), rotation.StagedLayout)
    with pytest.raises(ValueError, match="no cluster holds"):
        rotation._k6_layout(65536, 2, 8, 4, 8)

