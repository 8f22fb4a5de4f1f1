"""The launch plan of K3 and K5, the variant-step blind-rotation kernels
(`rotation._variant_launch_plan`), and their CPU entry points' cluster
argument.  No JAX: the kernels run only on the card, so what surrounds them
(grid, cluster, each rank's slot range, padding blocks, shared memory) is
held here, and `chip_smoke.py` holds the kernels themselves at every
cluster size against their plain versions."""
import numpy as np
import pytest
import torch

from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.numeric import from_numpy_u64
from tfhe_tpu_torch.core.params import MultiBitPBSParameters
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.poly import rotation
from torch_keys import multi_bit_params, random_multi_bit_bsk

CLUSTERS = (1, 2, 4, 8)
BATCHES = (1, 5, 6, 8, 512, 513)


def _smem(n, R, J, P):
    return 8 * R * n + 4 * J * n + 4 * P * R * n


@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_ranks_cover_every_slot_once(n, cluster):
    plan = rotation._variant_launch_plan(8, n, 2, 2, 4, cluster)
    assert plan.cluster == cluster and len(plan.slots) == cluster
    covered = np.zeros(n, dtype=np.int64)
    for lo, hi in plan.slots:
        assert 0 <= lo < hi <= n
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_grid_is_whole_clusters_and_pads_past_the_batch(batch, cluster):
    plan = rotation._variant_launch_plan(batch, 2048, 2, 2, 4, cluster)
    assert plan.grid % cluster == 0
    assert batch <= plan.grid < batch + cluster
    assert list(plan.padding) == [b for b in range(plan.grid) if b >= batch]


@pytest.mark.parametrize("n, R, J, P", [(2048, 2, 2, 4), (512, 4, 4, 4), (256, 2, 4, 3),
                                        (4096, 2, 2, 4)])
def test_shared_memory_is_the_working_set(n, R, J, P):
    for cluster in CLUSTERS:
        assert rotation._variant_launch_plan(6, n, R, J, P, cluster).smem == _smem(n, R, J, P)
    assert _smem(2048, 2, 2, 4) == 114688       # GROUP_2, GROUP_3 and paired 2_2


def test_plan_takes_the_default_cluster():
    plan = rotation._variant_launch_plan(512, 2048, 2, 2, 4, None)
    assert plan.cluster == rotation._CLUSTER in CLUSTERS


@pytest.mark.parametrize("cluster", [0, 3, 16, -4])
def test_plan_refuses_an_unsupported_cluster(cluster):
    with pytest.raises(ValueError, match="cluster"):
        rotation._variant_launch_plan(8, 2048, 2, 2, 4, cluster)


def test_plan_refuses_a_cluster_that_does_not_divide_the_slots():
    with pytest.raises(ValueError, match="divide"):
        rotation._variant_launch_plan(8, 4, 1, 1, 1, 8)
    with pytest.raises(ValueError, match="divide"):
        rotation._variant_launch_plan(8, 12, 1, 1, 1, 8)


@pytest.mark.parametrize("n, R, J, P", [(8192, 2, 4, 4), (4096, 2, 4, 5)])
def test_plan_refuses_a_working_set_above_shared_memory(n, R, J, P):
    assert _smem(n, R, J, P) > 232448
    with pytest.raises(ValueError, match="shared memory"):
        rotation._variant_launch_plan(8, n, R, J, P, 1)


# ---------------------------------------------------------------------------
# the entry points on CPU tensors: the plain path, whatever the cluster
# ---------------------------------------------------------------------------

G, N_IN, NPR = 2, 4, 4
N, R = P.polynomial_size, P.glwe_size


@pytest.fixture(scope="module")
def mb():
    tp = multi_bit_params(MultiBitPBSParameters, P, G, N_IN)
    key = interop.multi_bit_bootstrap_key_from_standard(random_multi_bit_bsk(tp, 7), P.pbs_decomp,
                                                        G, NPR, device="cpu")
    rng = np.random.default_rng(8)
    acc = from_numpy_u64(rng.integers(0, 2 ** 64, (3, R, N), dtype=np.uint64))
    exps = torch.from_numpy(rng.integers(0, 2 * N, (3, N_IN)))
    cexp = rotation.variant_exponents(exps, G, N)
    return dict(key=key, acc=acc, cexp=cexp,
                k3=rotation.rotate_accumulator_multi_bit(acc, cexp, key),
                k5=rotation.blind_rotate_step(acc.clone(), cexp[:, 1], key.spectra[1],
                                              "variants", P.pbs_decomp))


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_k3_on_cpu_takes_the_plain_path_at_any_cluster(mb, cluster):
    before = rotation.multi_bit_launches
    acc = mb["acc"].clone()
    out = rotation.rotate_accumulator_multi_bit(acc, mb["cexp"], mb["key"], _cluster=cluster)
    assert torch.equal(out, mb["k3"])
    assert torch.equal(acc, mb["acc"])                 # a new tensor; the input is unchanged
    assert rotation.multi_bit_launches == before


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_k5_on_cpu_takes_the_plain_path_at_any_cluster(mb, cluster):
    before = rotation.step_variant_launches
    acc = mb["acc"].clone()
    out = rotation.blind_rotate_step(acc, mb["cexp"][:, 1], mb["key"].spectra[1], "variants",
                                     P.pbs_decomp, _cluster=cluster)
    assert out is acc and torch.equal(out, mb["k5"])
    assert rotation.step_variant_launches == before


def test_entry_points_refuse_a_bad_cluster_and_a_cluster_for_k4(mb):
    with pytest.raises(ValueError, match="cluster"):
        rotation.rotate_accumulator_multi_bit(mb["acc"], mb["cexp"], mb["key"], _cluster=3)
    with pytest.raises(ValueError, match="cluster"):
        rotation.blind_rotate_step(mb["acc"].clone(), mb["cexp"][:, 1], mb["key"].spectra[1],
                                   "variants", P.pbs_decomp, _cluster=16)
    with pytest.raises(ValueError, match="cluster"):
        rotation.blind_rotate_step(mb["acc"].clone(), mb["cexp"][:, 0, 0].to(torch.int64),
                                   mb["key"].spectra[0, 0], "delta", P.pbs_decomp, _cluster=4)
