"""K6 (the staged blind rotation: the cluster step and the passes form),
the J > 15 bodies of K1, K3, K4 and K5, and K3/K5 in clusters of two, all
from `tfhe_tpu_torch/csrc/rotation.cu` built for the host against
`tests/cuda_host_stub.h` (which runs a cluster's blocks together) and run
on the CPU, held bit for bit against the plain rotation.  No JAX.

K6 runs in the form the wrapper's rule gives (`rotation._k6_layout`: the
cluster step at every shape here) at the shapes it takes on the card (N =
4096 with L = 2, N = 8192, delta and variant steps with g = 1 and 3) and,
forced (`_staged=True` on the card), at small N; the cluster step also at
each cluster size and prime group, and the passes form where it is asked
for; each over 2 steps at batch 1 or 2, through the layout and tables the
wrapper passes.  K1/K4 run at `AES_PARAMETERS_40`'s shape (J = 16) and the
WoP-PBS shape (J = 18), K3 and K5 at J = 16 and 18 (a cluster of 1) and in
clusters of 2.  `chip_smoke.py` holds the same kernels on the card.
"""
import numpy as np
import pytest
import torch

from cuda_host import build_rotation_host
from tfhe_tpu_torch.core.entities import NttBootstrapKey, NttMultiBitBootstrapKey
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.poly import ntt, rotation

ENTRIES = ("tfhe_staged_rotate", "tfhe_cluster_step", "tfhe_blind_rotate",
           "tfhe_blind_rotate_step", "tfhe_blind_rotate_multi_bit",
           "tfhe_blind_rotate_step_variants")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_rotation_host(tmp_path_factory.mktemp("host_staged"), ENTRIES)


def inputs(n, R, L, P, g, batch, steps, seed, base_log=None):
    """Key residues [steps, (2^g,) P, J, R, N] int32, acc [batch, R, N] u64
    with the top bit set in places, exponents [batch, steps(, 2^g - 1)].
    With `base_log`, the first step is the MAC's worst case instead: acc
    zero but for coefficient 0, whose balanced digits are all -1, so that
    every digit spectrum is p - 1 in every slot, and the key residues p - 1
    in a random half of the slots, 0 in the others: each MAC sum there
    gathers J products of (p - 1)^2.  (Were they p - 1 in every slot, a
    64-bit sum that wraps would wrap alike in every slot and prime, and its
    error, a multiple of 2^64, would vanish in the lift.)"""
    rng = np.random.default_rng(seed)
    plan = ntt.get_plan(n, P)
    lead = (steps, 1 << g) if g else (steps,)
    key = np.stack([rng.integers(0, p, lead + (L * R, R, n)) for p in plan.primes],
                   axis=len(lead)).astype(np.int32)
    acc = rng.integers(0, 2 ** 64, (batch, R, n), dtype=np.uint64)
    acc[0, 0, :4] = [0, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1]
    if base_log is not None:
        key[0] = (np.array(plan.primes, dtype=np.int64).reshape(
            (-1,) + (1,) * (key.ndim - 2 - (1 if g else 0))) - 1) * rng.integers(0, 2, n)
        ones = sum(1 << (base_log * l) for l in range(L))        # digits all 1
        acc[:] = 0
        acc[:, :, 0] = np.uint64((-ones << (64 - base_log * L)) % 2 ** 64)
    exps = rng.integers(0, 2 * n, (batch, steps) + (((1 << g) - 1,) if g else ())
                        ).astype(np.int32)
    return plan, key, acc, exps


def plain(acc, exps, key, L, base_log, plan, g):
    decomp = DecompParams(base_log=base_log, level=L)
    spectra = torch.from_numpy(key)
    k = (NttMultiBitBootstrapKey(spectra=spectra, decomp=decomp, primes=plan.primes,
                                 grouping_factor=g) if g else
         NttBootstrapKey(spectra=spectra, decomp=decomp, primes=plan.primes))
    return to_numpy_u64(rotation.blind_rotate_plain(
        from_numpy_u64(acc), torch.from_numpy(exps.astype(np.int64)), k))


def staged(lib, out, exps, e_stride, e_step, key, n, R, L, base_log, P, g, steps, form=None):
    """One K6 call on numpy arrays, as `rotation._staged_rotate` makes it, in
    the form `rotation._k6_layout` gives (`form` asks for one: "passes", or
    (C, group)); → its return code."""
    plan = ntt.get_plan(n, P)
    lay = rotation._k6_layout(n, R, L * R, P, 1 << g if g else 0, form)
    tab = rotation._delta_tables(plan, "cpu", bool(g)).numpy()
    consts = rotation._host_consts(plan).ctypes.data
    if isinstance(lay, rotation.ClusterLayout):
        return lib.tfhe_cluster_step(
            out.ctypes.data, exps.ctypes.data, e_stride, e_step, key.ctypes.data,
            tab.ctypes.data, consts, out.shape[0], steps, n, plan.log_n, P, R, L, base_log, g,
            lay.cluster, lay.group, lay.head_code, lay.tail_code, lay.log_t, lay.smem, None)
    spec = np.empty((out.shape[0], P, L * R, n), dtype=np.int32)
    res = np.empty((out.shape[0], P, R, n), dtype=np.int32)
    return lib.tfhe_staged_rotate(
        out.ctypes.data, exps.ctypes.data, e_stride, e_step, key.ctypes.data, tab.ctypes.data,
        consts, spec.ctypes.data, res.ctypes.data, out.shape[0], steps, n, plan.log_n, P, R, L,
        base_log, *rotation._staged_args(lay), None)


def run_staged(lib, n, R, L, base_log, P, g, batch, seed, form=None, worst=False):
    """K6 over 2 steps against the plain rotation on the same inputs."""
    plan, key, acc, exps = inputs(n, R, L, P, g, batch, 2, seed=seed,
                                  base_log=base_log if worst else None)
    out = acc.copy()
    assert staged(lib, out, exps, exps.strides[0] // 4, (1 << g) - 1 if g else 1, key, n, R, L,
                  base_log, P, g, 2, form) == 0
    assert np.array_equal(out, plain(acc, exps, key, L, base_log, plan, g))


# (N, R, L, base_log, P, g, batch): K6's shapes on the card (N = 4096 at L = 2,
# 3_3, and the 3_3 multi-bit and paired steps), and forced at small N (one
# head pass of radix 1, 2 or 3; a region of 32 slots at N = 64)
STAGED = [(4096, 2, 2, 15, 4, 0, 1), (8192, 2, 2, 15, 4, 0, 2), (8192, 2, 2, 14, 4, 1, 1),
          (8192, 2, 2, 14, 4, 3, 1), (64, 2, 2, 10, 2, 0, 2), (512, 2, 1, 23, 4, 0, 2),
          (1024, 3, 2, 10, 3, 0, 2), (2048, 2, 1, 23, 4, 0, 2), (64, 2, 2, 10, 2, 2, 2),
          (512, 2, 1, 20, 4, 3, 2)]


@pytest.mark.parametrize("n, R, L, base_log, P, g, batch", STAGED)
def test_k6_source_on_the_host_equals_the_plain_rotation(host_lib, n, R, L, base_log, P, g,
                                                         batch):
    run_staged(host_lib, n, R, L, base_log, P, g, batch, seed=n + g)


@pytest.mark.parametrize("g", [0, 1])
def test_k6_mac_takes_18_digit_rows_at_their_worst(host_lib, g):
    """K6 forced at the WoP-PBS shape (J = 18), the first step every MAC
    sum's largest: 18 products of (p - 1)^2 pass 2^64 unless reduced."""
    run_staged(host_lib, 1024, 3, 6, 7, 3, g, 2, seed=18 + g, worst=True)


# (N, R, L, base_log, P, g, batch, C, group): the cluster step at each
# cluster size, one prime a group and several, a region of 32 slots (N =
# 64 at C = 2) up to 8192 (C = 2), with and without in-block head passes,
# tail regions of 32 to 256 slots, P = 2, 3 and 4, R = 1 to 4, delta and
# variant steps with g = 1, 2 and 3; batch 3 at C = 4 starts a cluster's
# blocks in three orders (the host stand-in's start order turns by a rank
# from cluster to cluster)
CLUSTER = [(8192, 2, 2, 15, 4, 0, 1, 2, 1), (8192, 2, 2, 14, 4, 3, 1, 4, 2),
           (4096, 2, 2, 15, 4, 0, 2, 8, 4), (4096, 1, 3, 9, 2, 2, 1, 8, 2),
           (2048, 4, 1, 20, 4, 1, 1, 16, 4), (512, 2, 1, 23, 4, 0, 2, 16, 1),
           (64, 2, 2, 10, 2, 0, 2, 2, 1), (1024, 3, 2, 10, 3, 3, 2, 8, 3),
           (2048, 2, 2, 12, 4, 1, 2, 4, 4), (16384, 2, 2, 15, 4, 0, 1, 16, 2),
           (2048, 2, 1, 23, 4, 0, 3, 4, 4)]


@pytest.mark.parametrize("n, R, L, base_log, P, g, batch, C, group", CLUSTER)
def test_k6_cluster_step_at_each_cluster_size(host_lib, n, R, L, base_log, P, g, batch, C,
                                              group):
    run_staged(host_lib, n, R, L, base_log, P, g, batch, seed=C + group + g, form=(C, group))


@pytest.mark.parametrize("g", [0, 2])
def test_k6_cluster_step_mac_takes_16_digit_rows_at_their_worst(host_lib, g):
    """AES_PARAMETERS_40's shape (J = 16) forced onto the cluster step, the
    first step every MAC sum's largest: 16 products of (p - 1)^2 each (and
    more for the variants, reduced on the way)."""
    run_staged(host_lib, 512, 4, 4, 6, 3, g, 2, seed=16 + g, form=(4, 3), worst=True)


# (N, R, L, base_log, P, batch): the passes form where it is asked for: one
# head pass of each radix, 2 and 3 head passes, J = 8 (the digits of the set
# it serves, PARAM_MESSAGE_7_CARRY_1_COMPACT_PK_PBS_KS)
PASSES = [(64, 2, 2, 10, 2, 2), (512, 2, 1, 23, 4, 2), (1024, 3, 2, 10, 3, 2),
          (8192, 2, 4, 9, 4, 1), (16384, 2, 2, 15, 4, 1)]


@pytest.mark.parametrize("n, R, L, base_log, P, batch", PASSES)
def test_k6_passes_form_on_the_host_equals_the_plain_rotation(host_lib, n, R, L, base_log, P,
                                                              batch):
    run_staged(host_lib, n, R, L, base_log, P, 0, batch, seed=n + 1, form="passes")


def test_k6_passes_form_mac_takes_18_digit_rows_at_their_worst(host_lib):
    run_staged(host_lib, 1024, 3, 6, 7, 3, 0, 2, seed=18, form="passes", worst=True)


@pytest.mark.parametrize("g", [0, 1])
def test_k6_one_step_launches_read_the_exponents_through_their_stride(host_lib, g):
    """The per-step route at a staged shape: one K6 step a call (the
    cluster step), the step's exponent column read in place."""
    n, R, L, base_log, P = 8192, 2, 2, 15, 4
    plan, key, acc, exps = inputs(n, R, L, P, g, 2, 2, seed=5 + g)
    out = acc.copy()
    for j in range(2):
        assert staged(host_lib, out, exps[:, j:], exps.strides[0] // 4, 0, key[j:], n, R, L,
                      base_log, P, g, 1) == 0
    assert np.array_equal(out, plain(acc, exps, key, L, base_log, plan, g))


def test_k6_refuses_a_layout_that_does_not_cover_the_stages(host_lib):
    n, R, L, base_log, P = 2048, 2, 1, 23, 4
    plan, key, acc, exps = inputs(n, R, L, P, 0, 1, 1, seed=1)
    lay = rotation._staged_layout(n, R, L * R, P)
    tab = rotation._delta_tables(plan, "cpu").numpy()
    spec = np.empty((1, P, L * R, n), dtype=np.int32)
    res = np.empty((1, P, R, n), dtype=np.int32)
    rt, head, tail, log_w, warps, smem = rotation._staged_args(lay)
    for bad in ((rt, head, rotation._pack((3,)), log_w, warps, smem),   # a stage short
                (rt, head, tail, log_w, warps, smem + 16),              # not the regions' smem
                (rt, head, tail, log_w, 16, 16 * smem // warps),        # more than 8 warps
                (3, head, tail, log_w, warps, smem)):                   # rt does not divide R
        assert host_lib.tfhe_staged_rotate(
            acc.ctypes.data, exps.ctypes.data, 1, 1, key.ctypes.data, tab.ctypes.data,
            rotation._host_consts(plan).ctypes.data, spec.ctypes.data, res.ctypes.data, 1, 1,
            n, plan.log_n, P, R, L, base_log, *bad, None) != 0


def test_k6_cluster_step_refuses_a_layout_it_does_not_take(host_lib):
    n, R, L, base_log, P = 2048, 2, 2, 12, 4
    plan, key, acc, exps = inputs(n, R, L, P, 0, 1, 1, seed=2)
    lay = rotation._cluster_layout(n, R, L * R, P, 4, 2)
    tab = rotation._delta_tables(plan, "cpu").numpy()
    good = (lay.cluster, lay.group, lay.head_code, lay.tail_code, lay.log_t, lay.smem)
    for bad in ((3, 2) + good[2:],                                   # not a cluster size
                (32, 2) + good[2:],                                  # 32 blocks
                (4, 3) + good[2:],                                   # a group not dividing P
                good[:2] + (rotation._pack(()),) + good[3:],         # a head stage short
                good[:3] + (rotation._pack((3, 2)),) + good[4:],     # a tail stage short
                good[:4] + (7,) + good[5:],                          # not the tail regions
                good[:5] + (lay.smem + 16,)):                        # not the layout's smem
        assert host_lib.tfhe_cluster_step(
            acc.ctypes.data, exps.ctypes.data, 1, 1, key.ctypes.data, tab.ctypes.data,
            rotation._host_consts(plan).ctypes.data, 1, 1, n, plan.log_n, P, R, L, base_log, 0,
            *bad, None) != 0
    # 5 primes: beyond what the lift holds
    plan5 = ntt.get_plan(n, 5)
    assert host_lib.tfhe_cluster_step(
        acc.ctypes.data, exps.ctypes.data, 1, 1, key.ctypes.data, tab.ctypes.data,
        rotation._host_consts(plan5).ctypes.data, 1, 1, n, plan.log_n, 5, R, L, base_log, 0,
        4, 5, lay.head_code, lay.tail_code, lay.log_t, 4 * (5 * L * R + 5 * R) * n // 4,
        None) != 0


# ---- J > 15: K1/K4 (the delta MAC) and K3/K5 (the variant MAC) ---------------

# AES_PARAMETERS_40 (N = 512, k = 3, L = 4: J = 16) and the WoP-PBS sets
# (N = 1024, k = 2, L = 6: J = 18)
WIDE = [(512, 4, 4, 6, 3), (1024, 3, 6, 7, 3)]


@pytest.mark.parametrize("worst", [False, True])
@pytest.mark.parametrize("n, R, L, base_log, P", WIDE)
def test_k1_and_k4_bodies_take_more_than_15_digit_rows(host_lib, n, R, L, base_log, P, worst):
    plan, key, acc, exps = inputs(n, R, L, P, 0, 2, 2, seed=L * R,
                                  base_log=base_log if worst else None)
    lay = rotation._delta_layout(n, R, L * R, P)
    tab = rotation._delta_tables(plan, "cpu").numpy()
    hc = rotation._host_consts(plan)
    want = plain(acc, exps, key, L, base_log, plan, 0)
    out = acc.copy()
    assert host_lib.tfhe_blind_rotate(out.ctypes.data, exps.ctypes.data, key.ctypes.data,
                                      tab.ctypes.data, hc.ctypes.data, 2, 2, n, plan.log_n, P,
                                      R, L, base_log, *rotation._delta_args(lay), None) == 0
    assert np.array_equal(out, want)
    out = acc.copy()
    for j in range(2):
        assert host_lib.tfhe_blind_rotate_step(
            out.ctypes.data, exps[:, j:].ctypes.data, exps.shape[1], key[j].ctypes.data,
            tab.ctypes.data, hc.ctypes.data, 2, n, plan.log_n, P, R, L, base_log,
            *rotation._delta_args(lay), None) == 0
    assert np.array_equal(out, want)


@pytest.mark.parametrize("worst", [False, True])
@pytest.mark.parametrize("n, R, L, base_log, P, g", [(512, 4, 4, 6, 3, 2),
                                                     (1024, 3, 6, 7, 3, 1)])
def test_k3_and_k5_bodies_take_more_than_15_digit_rows(host_lib, n, R, L, base_log, P, g,
                                                       worst):
    """K3 over 2 steps and K5 one step a call; g = 1 is the paired key's
    step (K5 on the MXU=0 route)."""
    plan, key, acc, exps = inputs(n, R, L, P, g, 2, 2, seed=g + L,
                                  base_log=base_log if worst else None)
    tab, cs = rotation._kernel_tables(plan, "cpu")
    launch = rotation._variant_launch_plan(2, n, R, L * R, P, 1)
    want = plain(acc, exps, key, L, base_log, plan, g)
    out = acc.copy()
    assert host_lib.tfhe_blind_rotate_multi_bit(
        out.ctypes.data, exps.ctypes.data, key.ctypes.data, tab.data_ptr(), cs.data_ptr(), 2,
        2, n, plan.log_n, P, R, L, base_log, g, launch.grid, 1, launch.smem, None) == 0
    assert np.array_equal(out, want)
    out = acc.copy()
    for j in range(2):
        step_e = np.ascontiguousarray(exps[:, j])
        assert host_lib.tfhe_blind_rotate_step_variants(
            out.ctypes.data, step_e.ctypes.data, step_e.strides[0] // 4, key[j].ctypes.data,
            tab.data_ptr(), cs.data_ptr(), 2, n, plan.log_n, P, R, L, base_log, g,
            launch.grid, 1, launch.smem, None) == 0
    assert np.array_equal(out, want)


@pytest.mark.parametrize("n, R, L, base_log, P, g, batch", [(512, 2, 2, 10, 2, 2, 3),
                                                            (256, 3, 1, 20, 3, 1, 2)])
def test_k3_and_k5_in_clusters_of_two(host_lib, n, R, L, base_log, P, g, batch):
    """K3 over 2 steps and K5 one step a call at a cluster of 2 blocks
    (each key word loaded once for both ciphertexts through the cluster);
    an odd batch leaves a padding block in the last cluster."""
    plan, key, acc, exps = inputs(n, R, L, P, g, batch, 2, seed=batch + g)
    tab, cs = rotation._kernel_tables(plan, "cpu")
    launch = rotation._variant_launch_plan(batch, n, R, L * R, P, 2)
    want = plain(acc, exps, key, L, base_log, plan, g)
    out = acc.copy()
    assert host_lib.tfhe_blind_rotate_multi_bit(
        out.ctypes.data, exps.ctypes.data, key.ctypes.data, tab.data_ptr(), cs.data_ptr(),
        batch, 2, n, plan.log_n, P, R, L, base_log, g, launch.grid, 2, launch.smem, None) == 0
    assert np.array_equal(out, want)
    out = acc.copy()
    for j in range(2):
        step_e = np.ascontiguousarray(exps[:, j])
        assert host_lib.tfhe_blind_rotate_step_variants(
            out.ctypes.data, step_e.ctypes.data, step_e.strides[0] // 4, key[j].ctypes.data,
            tab.data_ptr(), cs.data_ptr(), batch, n, plan.log_n, P, R, L, base_log, g,
            launch.grid, 2, launch.smem, None) == 0
    assert np.array_equal(out, want)
