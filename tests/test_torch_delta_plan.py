"""The delta body's plan (K1/K4, `csrc/rotation.cu` `delta_kernel`): its
layout (`rotation._delta_layout`) and tables (`rotation._delta_tables`),
run in numpy pass by pass with the kernel's own indexing.  No JAX: the
kernels run only on the card, and `chip_smoke.py` holds them there against
their plain versions; here the schedule they follow is held against the
port's transforms (`ntt.py`) and its plain step.

The simulation mirrors the kernel: a pass of radix log r over a thread's
item reads 2^r coefficients at base + s*2^lo through the shared-memory
swizzle, loads the twiddles of heap node q = 2^(log N - lo - r) + blk from
the interleaved (value, Shoup twin) table and runs r butterfly stages with
32-bit Shoup multiplies; head passes map items over the whole block, tail
passes over one warp's region, the MAC over (chunk, group of 4 slots)."""
import numpy as np
import pytest
import torch

from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.poly import ntt, rotation

M32 = np.uint64(0xFFFFFFFF)
SIZES = (256, 512, 1024, 2048, 4096)
# (N, R, L, P) of the main path's delta shapes: 2_2, 2_1, 1_1, boolean
# DEFAULT_PARAMETERS_KS_PBS, 2_3 (N = 4096), and 1_0 (R = 6)
SHAPES = [(2048, 2, 1, 4), (1024, 3, 1, 4), (512, 4, 1, 4), (512, 3, 3, 3), (4096, 2, 1, 4),
          (256, 6, 1, 3)]


# ---- the kernel's arithmetic, on uint64 arrays ------------------------------

def mul_lazy(a, w):
    """mul_lazy(a, w.value, w.twin, p) of rotation.cu, a*w mod p plus 0 or
    p; w is (value, twin, p)."""
    wv, ws, p = w
    assert (a < 2 ** 32).all()
    q = (a * ws) >> np.uint64(32)
    r = (a * wv - q * p) & M32
    assert (r < 2 * p).all()
    return r


def mul_shoup(a, w):
    """mul_shoup(a, w.value, w.twin, p) of rotation.cu, a*w mod p."""
    return csub(mul_lazy(a, w), w[2])


def csub(x, m):
    """csub(x, m) of rotation.cu: x - m if x >= m."""
    return np.where(x >= m, x - m, x)


def add_mod(a, b, p):
    s = a + b
    return np.where(s >= p, s - p, s)


def sub_mod(a, b, p):
    return np.where(a >= b, a - b, a + p - b)


def swizzle(pos):
    return rotation._swizzle(pos)


def twiddles(table, q, r, p):
    """The 2^r - 1 twiddles of heap node q, by heap-relative index 1..7."""
    tw = {}
    for level in range(r):
        for i in range(1 << level):
            idx = (q << level) + i
            tw[(1 << level) + i] = (table[idx, 0], table[idx, 1], p)
    return tw


def ct(a, tw, r, p):
    """Forward Cooley-Tukey stages of one item, t = 2^(lo+r-1) first, lazily
    reduced: [0, 4p) in and out."""
    for i in reversed(range(r)):
        for s in range(1 << r):
            if s & (1 << i):
                continue
            w = tw[(1 << (r - 1 - i)) + (s >> (i + 1))]
            u, v = csub(a[s], 2 * p), mul_lazy(a[s + (1 << i)], w)
            a[s], a[s + (1 << i)] = u + v, u + 2 * p - v
            assert (a[s] < 4 * p).all() and (a[s + (1 << i)] < 4 * p).all()


def gs(a, tw, r, p):
    """Inverse Gentleman-Sande stages of one item, t = 2^lo first, lazily
    reduced: [0, 2p) in and out."""
    for i in range(r):
        for s in range(1 << r):
            if s & (1 << i):
                continue
            w = tw[(1 << (r - 1 - i)) + (s >> (i + 1))]
            u, v = a[s], a[s + (1 << i)]
            assert (u < 2 * p).all() and (v < 2 * p).all()
            a[s], a[s + (1 << i)] = csub(u + v, 2 * p), mul_lazy(u + 2 * p - v, w)


# ---- the passes, all items of a pass at once, indexed as the threads are ---

def items_of_block(count, threads):
    """(thread, item) arrays of `for (f = tid; f < count; f += threads)`."""
    f = np.arange(count)
    return f % threads, f


def pass_positions(lo, r, blk, off):
    """The 2^r coefficients of item (blk, off) of a pass at stride 2^lo."""
    base = (blk << (lo + r)) + off
    return [base + (s << lo) for s in range(1 << r)]


def run_items(arr, table, log_n, lo, r, poly, blk, off, p, forward):
    """One pass over the items (poly, blk, off) (arrays) of arr [npoly][N]."""
    q = (1 << (log_n - lo - r)) + blk
    tw = twiddles(table, q, r, p)
    pos = [swizzle(x) for x in pass_positions(lo, r, blk, off)]
    a = [arr[poly, x] for x in pos]
    (ct if forward else gs)(a, tw, r, p)
    for x, v in zip(pos, a):
        arr[poly, x] = v


def head_pass(arr, lay, lo, r, table, p, forward):
    """A head pass over every polynomial of arr [npoly][N] (swizzled)."""
    per = 1 << (lay.log_n - r)
    _, f = items_of_block(arr.shape[0] * per, lay.threads)
    it = f & (per - 1)
    run_items(arr, table, lay.log_n, lo, r, f >> (lay.log_n - r), it >> lo,
              it & ((1 << lo) - 1), p, forward)


def tail_los(lay):
    """(lo, r) of each tail pass, top pass first."""
    out, lo = [], lay.log_w
    for r in lay.tail:
        lo -= r
        out.append((lo, r))
    return out


def tail_passes(arr, lay, table, p, forward):
    """The tail passes, region by region (one warp each, warp barriers):
    region g is polynomial g >> (log N - log W), coefficients from
    (g mod 2^(log N - log W)) * W; item it (lane + 32k) of a pass is block
    (base >> (lo + r)) + (it >> lo), offset it mod 2^lo."""
    shift = lay.log_n - lay.log_w
    g = np.arange(arr.shape[0] << shift)
    for lo, r in (tail_los(lay) if forward else tail_los(lay)[::-1]):
        it = np.arange(1 << (lay.log_w - r))
        gg, ii = np.meshgrid(g, it, indexing="ij")
        base = (gg & ((1 << shift) - 1)) << lay.log_w
        run_items(arr, table, lay.log_n, lo, r, gg >> shift, (base >> (lo + r)) + (ii >> lo),
                  ii & ((1 << lo) - 1), p, forward)


def head_los(lay):
    """(lo, r) of each head pass, top pass first."""
    out, top = [], lay.log_n
    for r in lay.head:
        out.append((top - r, r))
        top -= r
    return out


def mac_groups(n):
    """The MAC's 4-slot groups x, with their heap node n/4 + x (the last
    two forward stages and the first two inverse ones)."""
    x = np.arange(n // 4)
    return x, n // 4 + x


def forward(lay, table, p, polys):
    """Natural-order residues [J][N] → slot-order spectra, through the
    head passes, the tail and the MAC's first two stages."""
    n = polys.shape[1]
    k = np.arange(n)
    arr = np.zeros_like(polys)
    arr[:, swizzle(k)] = polys
    for lo, r in head_los(lay):
        head_pass(arr, lay, lo, r, table, p, True)
    tail_passes(arr, lay, table, p, True)
    x, q = mac_groups(n)
    tw = twiddles(table, q, 2, p)
    out = np.zeros_like(polys)
    for j in range(polys.shape[0]):
        a = [arr[j, swizzle(4 * x + c)] for c in range(4)]
        ct(a, tw, 2, p)
        for c in range(4):
            out[j, 4 * x + c] = csub(csub(a[c], 2 * p), p)
    return out


def inverse(lay, table, p, spectra):
    """Slot-order spectra [R][N] in [0, 2p) → natural-order residues times
    N: the MAC's inverse stages, the tail, then the head passes bottom up,
    the last reducing to [0, p)."""
    n = spectra.shape[1]
    x, q = mac_groups(n)
    tw = twiddles(table, q, 2, p)
    arr = np.zeros_like(spectra)
    for r in range(spectra.shape[0]):
        a = [spectra[r, 4 * x + c] for c in range(4)]
        gs(a, tw, 2, p)
        for c in range(4):
            arr[r, swizzle(4 * x + c)] = a[c]
    tail_passes(arr, lay, table, p, False)
    for lo, r in head_los(lay)[::-1]:
        head_pass(arr, lay, lo, r, table, p, False)
    return csub(arr[:, swizzle(np.arange(n))], p)


def prime_tables(tab, P, n, pi):
    """(forward, inverse, phase) of prime pi as [rows, 2] uint64 (value, twin)."""
    t = tab.numpy().view(np.uint32).astype(np.uint64)
    fwd = t[:2 * P * n].reshape(P, n, 2)[pi]
    inv = t[2 * P * n:4 * P * n].reshape(P, n, 2)[pi]
    ph = t[4 * P * n:].reshape(P, 2 * n, 2)[pi]
    return fwd, inv, ph


# ---- the transforms ---------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_pass_schedule_reproduces_the_transforms_for_every_prime(n):
    P = len(ntt.PRIMES_31)
    plan = ntt.get_plan(n, P)
    lay = rotation._delta_layout(n, 2, 2, 4)
    tab = rotation._delta_tables(plan, "cpu")
    rng = np.random.default_rng(n)
    for pi, prime in enumerate(plan.primes):
        p = np.uint64(prime)
        fwd, inv, _ = prime_tables(tab, P, n, pi)
        x = rng.integers(0, prime, (2, n), dtype=np.int64)
        want = ntt.ntt_forward(plan, torch.from_numpy(x).unsqueeze(1).expand(2, P, n).contiguous())
        got = forward(lay, fwd, p, x.astype(np.uint64))
        assert np.array_equal(got.astype(np.int64), want[:, pi].numpy())
        # the inverse leaves out the 1/N that the phase table carries
        back = inverse(lay, inv, p, got)
        assert np.array_equal(back.astype(np.int64) * plan.n_inv[pi] % prime, x)


def test_tables_interleave_each_value_with_its_shoup_twin():
    plan = ntt.get_plan(512, 4)
    tab = rotation._delta_tables(plan, "cpu")
    assert tab.dtype == torch.int32 and tab.numel() == 8 * 4 * 512
    fwd, inv, ph = prime_tables(tab, 4, 512, 2)
    p = plan.primes[2]
    assert np.array_equal(fwd[:, 0], plan.psi_rev[2])
    assert np.array_equal(inv[:, 0], plan.psi_inv_rev[2])
    assert np.array_equal(ph[:, 0], (plan.psi_pow[2] - 1) % p * plan.n_inv[2] % p)
    for t in (fwd, inv, ph):
        assert np.array_equal(t[:, 1], (t[:, 0].astype(object) << 32) // p)
    assert rotation._delta_tables(plan, "cpu") is tab


# ---- the layout ------------------------------------------------------------

@pytest.mark.parametrize("n, R, L, P", SHAPES)
def test_layout_covers_every_stage_once(n, R, L, P):
    lay = rotation._delta_layout(n, R, L * R, P)
    assert sum(lay.head) + sum(lay.tail) + 2 == lay.log_n == n.bit_length() - 1
    assert lay.log_w == lay.log_n - sum(lay.head) and lay.log_w <= 8
    assert all(1 <= r <= 3 for r in lay.head + lay.tail)
    assert lay.smem == 8 * R * n + 4 * L * R * n + 4 * P * R * n <= rotation._SMEM_LIMIT
    assert lay.rt * lay.chunks == R and lay.rt <= 4
    for code, radices in ((lay.head_code, lay.head), (lay.tail_code, lay.tail)):
        assert code & 15 == len(radices)
        assert [(code >> (4 + 4 * i)) & 15 for i in range(len(radices))] == list(radices)


def test_main_path_layout_gives_every_thread_equal_work():
    """2_2: one radix-8 head pass (512 items), two radix-8 tail passes in 16
    regions of 256 (32 items each), 512 groups of 4 slots in the MAC: every
    thread and every warp the same number of items."""
    lay = rotation._delta_layout(2048, 2, 2, 4)
    assert (lay.head, lay.tail, lay.log_w, lay.rt, lay.chunks) == ((3,), (3, 3), 8, 2, 1)
    assert 2 * 2048 // 8 == 2048 // 4 == 512 and 512 % lay.threads == 0
    assert 2 * 2048 // 256 % (lay.threads // 32) == 0


@pytest.mark.parametrize("n, R, L, P", SHAPES)
def test_mac_covers_every_output_slot_once(n, R, L, P):
    lay = rotation._delta_layout(n, R, L * R, P)
    covered = np.zeros((R, n), dtype=np.int64)
    for f in items_of_block(lay.chunks * n // 4, lay.threads)[1]:
        x, c = f % (n // 4), f // (n // 4)
        for r in range(c * lay.rt, (c + 1) * lay.rt):
            covered[r, 4 * x:4 * x + 4] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("n, R, L, P", SHAPES)
def test_tail_regions_stay_inside_one_warp(n, R, L, P):
    """Every tail pass of a region reads and writes exactly the region's
    coefficients, so a warp barrier orders the passes."""
    lay = rotation._delta_layout(n, R, L * R, P)
    w = 1 << lay.log_w
    lo = lay.log_w
    for r in lay.tail:
        lo -= r
        for base in range(0, n, w):
            seen = []
            for it in range(w >> r):
                blk = (base >> (lo + r)) + (it >> lo)
                seen += pass_positions(lo, r, blk, it & ((1 << lo) - 1))
            assert sorted(seen) == list(range(base, base + w))


@pytest.mark.parametrize("n, R", [(2048, 2), (4096, 2)])
def test_region_pipeline_keeps_each_region_in_one_warp(n, R):
    """Where every warp has a 256-slot region of its own (N >= 256 * warps),
    one warp runs a region's forward tail in every digit polynomial, the MAC
    of its 64 groups and the inverse tail in every product: the MAC's slots
    are the region's, and the regions cover every output slot once."""
    lay = rotation._delta_layout(n, R, R, 4)
    warps = lay.threads // 32
    assert n // 256 >= warps and lay.log_w == 8
    covered = np.zeros((R, n), dtype=np.int64)
    for g in range(n // 256):                          # warp g % warps
        for f in range(lay.chunks * 64):               # lane + 32k
            x, c = 64 * g + f % 64, f // 64
            assert 256 * g <= 4 * x < 4 * x + 4 <= 256 * (g + 1)
            covered[c * lay.rt:(c + 1) * lay.rt, 4 * x:4 * x + 4] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("n, R, L, P", SHAPES)
def test_decompose_and_garner_passes_give_each_thread_the_same_coefficients(n, R, L, P):
    """The first forward pass (decompose) and the last inverse pass (Garner
    into acc) map a thread to the same accumulator words, so the lift of one
    step and the digits of the next need no block barrier between them."""
    lay = rotation._delta_layout(n, R, L * R, P)
    r = lay.head[0]
    lo = lay.log_n - r
    seen = np.zeros((R, n), dtype=np.int64)
    tid, f = items_of_block(R << lo, lay.threads)
    out, off = f >> lo, f & ((1 << lo) - 1)
    for x in pass_positions(lo, r, 0, off):
        np.add.at(seen, (out, x), 1)
    assert (seen == 1).all()


def banks(words):
    return len({w % 32 for w in words})


def test_main_path_accesses_fall_in_32_banks():
    """At N = 2048 each warp-wide access of the tail passes (strides 32 and
    4) and of the head pass hits 32 banks; the MAC's 16-byte loads of a
    quarter warp hit 8 distinct 4-bank groups."""
    lay = rotation._delta_layout(2048, 2, 2, 4)
    for lo, r in [(8, 3), (5, 3), (2, 3)]:
        for warp in range(lay.threads // 32 * 2):
            for s in range(8):
                words = []
                for lane in range(32):
                    it = (warp * 32 + lane) % (2048 >> r)
                    blk, off = it >> lo, it & ((1 << lo) - 1)
                    words.append(swizzle(pass_positions(lo, r, blk, off)[s]))
                assert banks(words) == 32, (lo, r, warp, s)
    for x0 in range(0, 512, 8):
        groups = {swizzle(4 * x) // 4 % 8 for x in range(x0, x0 + 8)}
        assert len(groups) == 8 and all(swizzle(4 * x) % 4 == 0 for x in range(x0, x0 + 8))


# ---- one whole step, against the plain step ---------------------------------

def garner(cs, vals, P):
    """garner_last of rotation.cu on uint64 arrays: residues vals[a] → the
    signed lift mod 2^64."""
    c32 = lambda i: np.uint64(int(cs[i]) & 0xFFFFFFFF)
    t = [vals[0]]
    c = vals[0].copy()
    for a in range(1, P):
        pa = c32(0 + a)
        acc = np.zeros_like(vals[0])
        for b in range(a):
            acc = add_mod(acc, mul_shoup(t[b], (c32(32 + 8 * a + b), c32(96 + 8 * a + b), pa)), pa)
        t.append(mul_shoup(sub_mod(vals[a], acc, pa), (c32(16 + a), c32(24 + a), pa)))
        c = c + t[a] * np.uint64(int(cs[168 + a]) & (2 ** 64 - 1))
    ge = np.zeros(c.shape, dtype=bool)
    eq = np.ones(c.shape, dtype=bool)
    for a in reversed(range(P)):
        h = c32(160 + a)
        ge |= eq & (t[a] > h)
        eq &= t[a] == h
    return np.where(ge | eq, c - np.uint64(int(cs[176]) & (2 ** 64 - 1)), c)


def simulate_step(acc, e, key, decomp, P):
    """One delta step of the kernel on one ciphertext: acc [R][N] uint64,
    key [P][J][R][N] → the new acc."""
    R, n = acc.shape
    L, base_log = decomp.level, decomp.base_log
    J = L * R
    lay = rotation._delta_layout(n, R, J, P)
    plan = ntt.get_plan(n, P)
    tab = rotation._delta_tables(plan, "cpu")
    cs = rotation._host_consts(plan)
    shift = 64 - base_log * L
    res = np.zeros((P, R, n), dtype=np.uint64)
    for pi, prime in enumerate(plan.primes):
        p = np.uint64(prime)
        fwd, inv, ph = prime_tables(tab, P, n, pi)
        # the first head pass: balanced digits of each coefficient, level by level
        digits = np.zeros((J, n), dtype=np.uint64)
        st = (acc + np.uint64(1 << (shift - 1))) >> np.uint64(shift) if shift > 0 else acc.copy()
        for lvl in reversed(range(L)):
            raw = st & np.uint64((1 << base_log) - 1)
            carry = (raw + np.uint64(1 << (base_log - 1))) >> np.uint64(base_log)
            d = raw.astype(np.int64) - (carry << np.uint64(base_log)).astype(np.int64)
            st = (st >> np.uint64(base_log)) + carry
            digits[lvl * R:(lvl + 1) * R] = np.where(d < 0, d + prime, d).astype(np.uint64)
        spec = forward(lay, fwd, p, digits)
        # the MAC: J products in one 64-bit sum, reduced, times the phase
        m = (e * plan.slot_odd) % (2 * n)
        for r in range(R):
            s = np.zeros(n, dtype=np.uint64)
            for j in range(J):
                s = s + spec[j] * key[pi, j, r].astype(np.uint64)
            res[pi, r] = mul_lazy(s % p, (ph[m, 0], ph[m, 1], p))
        res[pi] = inverse(lay, inv, p, res[pi])
    return acc + garner(cs, res, P)


@pytest.mark.parametrize("n, R, L, base_log, P", [(256, 2, 1, 23, 4), (512, 3, 3, 6, 3),
                                                  (256, 6, 1, 15, 3), (64, 2, 2, 10, 2)])
def test_simulated_step_equals_the_plain_step(n, R, L, base_log, P):
    rng = np.random.default_rng(n + R)
    decomp = DecompParams(base_log=base_log, level=L)
    plan = ntt.get_plan(n, P)
    key = np.stack([rng.integers(0, p, (L * R, R, n)) for p in plan.primes])   # [P, J, R, N]
    acc = rng.integers(0, 2 ** 64, (2, R, n), dtype=np.uint64)
    acc[0, 0, :4] = [0, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1]
    e = np.array([rng.integers(0, 2 * n), 0])
    want = rotation.blind_rotate_step_plain(from_numpy_u64(acc), torch.from_numpy(e),
                                            torch.from_numpy(key).to(torch.int32), "delta",
                                            decomp)
    got = np.stack([simulate_step(acc[b], int(e[b]), key, decomp, P) for b in range(2)])
    assert np.array_equal(got, to_numpy_u64(want))


# ---- the wrapper's checks ---------------------------------------------------

@pytest.mark.parametrize("n, R, L, P", SHAPES + [(4, 1, 1, 1), (8, 2, 1, 2), (8192, 1, 1, 1),
                                           (2048, 2, 8, 4), (1024, 3, 6, 3)])
def test_layout_accepts_the_shapes_k1_takes(n, R, L, P):
    lay = rotation._delta_layout(n, R, L * R, P)
    assert lay.threads == rotation._DELTA_THREADS


@pytest.mark.parametrize("n, R, L, P", [(8192, 2, 1, 4), (8192, 2, 2, 4), (4096, 2, 2, 4)])
def test_layout_refuses_a_working_set_above_shared_memory(n, R, L, P):
    with pytest.raises(ValueError, match="shared memory"):
        rotation._delta_layout(n, R, L * R, P)


@pytest.mark.parametrize("n, R, J, P", [(2048, 2, 0, 4), (2048, 2, 2, 9), (12, 1, 1, 1),
                                        (2, 1, 1, 1), (2048, 2, 3, 4)])
def test_layout_refuses_what_the_kernel_does_not_take(n, R, J, P):
    with pytest.raises(ValueError):
        rotation._delta_layout(n, R, J, P)
