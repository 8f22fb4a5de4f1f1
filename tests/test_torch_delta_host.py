"""The delta kernels' CUDA source (K1, K4 in `tfhe_tpu_torch/csrc/rotation.cu`)
built for the host and run on the CPU, held bit for bit against the plain
rotation.  No JAX.

`tests/cuda_host_stub.h` stands in for the CUDA runtime: each CUDA thread
is a std::thread, `__syncthreads()` and `__syncwarp()` are barriers, and the
intrinsics compute what the device's do.  So this runs the kernel's own
indexing, pass schedule, barriers, lazy arithmetic and Garner lift, with
the layout, tables and constants the wrapper passes; `chip_smoke.py` holds
the same kernels on the card.  Skips where no C++20 host compiler is found.
"""
import numpy as np
import pytest
import torch

from cuda_host import build_rotation_host
from tfhe_tpu_torch.core.entities import NttBootstrapKey
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.poly import ntt, rotation

# (N, R, L, base_log, P): the main path's delta shapes (2_2, which takes the
# kernel compiled for N = 2048 and P = 4, and on the general kernel 2_1, 1_1,
# the boolean set, 2_3 at N = 4096, 1_0 with R = 6), and small and odd ones
SHAPES = [(2048, 2, 1, 23, 4), (1024, 3, 1, 23, 4), (512, 4, 1, 18, 4), (512, 3, 3, 6, 3),
          (4096, 2, 1, 22, 4), (256, 6, 1, 15, 3), (128, 5, 1, 10, 3), (64, 2, 2, 10, 2),
          (16, 2, 1, 12, 2), (4, 1, 1, 20, 1)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_rotation_host(tmp_path_factory.mktemp("host_rotation"),
                               ("tfhe_blind_rotate", "tfhe_blind_rotate_step"))


def inputs(n, R, L, base_log, P, batch, steps, seed):
    rng = np.random.default_rng(seed)
    plan = ntt.get_plan(n, P)
    key = np.stack([rng.integers(0, p, (steps, L * R, R, n)) for p in plan.primes],
                   axis=1).astype(np.int32)                       # [steps, P, J, R, N]
    acc = rng.integers(0, 2 ** 64, (batch, R, n), dtype=np.uint64)
    acc[0, 0, :3] = [0, 2 ** 63, 2 ** 64 - 1]
    exps = rng.integers(0, 2 * n, (batch, steps)).astype(np.int32)
    return plan, key, acc, exps


def plain(acc, exps, key, n, L, base_log, plan):
    k = NttBootstrapKey(spectra=torch.from_numpy(key),
                        decomp=DecompParams(base_log=base_log, level=L), primes=plan.primes)
    return to_numpy_u64(rotation.blind_rotate_plain(
        from_numpy_u64(acc), torch.from_numpy(exps.astype(np.int64)), k))


def tables(plan, n, R, L, P):
    lay = rotation._delta_layout(n, R, L * R, P)
    tab = rotation._delta_tables(plan, "cpu").numpy()
    return lay, tab, rotation._host_consts(plan)


@pytest.mark.parametrize("n, R, L, base_log, P", SHAPES)
def test_k1_source_on_the_host_equals_the_plain_rotation(host_lib, n, R, L, base_log, P):
    plan, key, acc, exps = inputs(n, R, L, base_log, P, batch=2, steps=2, seed=n + R)
    lay, tab, hc = tables(plan, n, R, L, P)
    out = acc.copy()
    code = host_lib.tfhe_blind_rotate(out.ctypes.data, exps.ctypes.data, key.ctypes.data,
                                      tab.ctypes.data, hc.ctypes.data, 2, 2, n, plan.log_n,
                                      P, R, L, base_log,
                                      *rotation._delta_args(lay), None)
    assert code == 0
    assert np.array_equal(out, plain(acc, exps, key, n, L, base_log, plan))


@pytest.mark.parametrize("n, R, L, base_log, P", [SHAPES[0], SHAPES[3]])
def test_k4_source_on_the_host_equals_the_plain_steps(host_lib, n, R, L, base_log, P):
    """Two K4 launches, the exponents read through their batch stride."""
    plan, key, acc, exps = inputs(n, R, L, base_log, P, batch=2, steps=2, seed=7)
    lay, tab, hc = tables(plan, n, R, L, P)
    out = acc.copy()
    for j in range(2):
        code = host_lib.tfhe_blind_rotate_step(
            out.ctypes.data, exps[:, j:].ctypes.data, exps.shape[1], key[j].ctypes.data,
            tab.ctypes.data, hc.ctypes.data, 2, n, plan.log_n, P, R, L, base_log, *rotation._delta_args(lay), None)
        assert code == 0
    assert np.array_equal(out, plain(acc, exps, key, n, L, base_log, plan))


def test_host_launch_refuses_a_layout_that_does_not_cover_the_stages(host_lib):
    n, R, L, base_log, P = SHAPES[0]
    plan, key, acc, exps = inputs(n, R, L, base_log, P, batch=1, steps=1, seed=1)
    lay, tab, hc = tables(plan, n, R, L, P)
    rt, head, tail, log_w, smem = rotation._delta_args(lay)
    for bad in ((rt, head, rotation._pack((3,)), log_w, smem),    # a stage short
                (rt, head, tail, log_w, smem + 4),                # not the working set
                (3, head, tail, log_w, smem)):                    # rt does not divide R
        assert host_lib.tfhe_blind_rotate(acc.ctypes.data, exps.ctypes.data,
                                          key.ctypes.data, tab.ctypes.data, hc.ctypes.data,
                                          1, 1, n, plan.log_n, P, R, L, base_log, *bad,
                                          None) != 0
