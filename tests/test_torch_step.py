"""The per-step blind rotation of the port (the plain paths of K4 and K5 on
CPU) against tfhe_tpu's per-step Pallas kernels in interpret mode, at
TEST_PARAMS_SHORTINT (n=16, N=256, P=4) and its multi-bit copy with g=2:

  * one step, delta and multibit, against `blind_rotate_step_pallas_mxu`
    (B4) with phases gathered from `monomial_full_tables`;
  * the classic per-step rotation against `blind_rotate_pallas` with
    mxu=True (B4) and lanes=True (B5), and against the port's fused form;
  * the rotation switches: their defaults, and the route every row of the
    switch table takes in both packages;
  * no fallback: the step wrapper raises on other devices.

Tolerance 0 throughout: the arithmetic is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.core.poly.pallas_ntt as jax_pallas
from tfhe_tpu import config as jconfig
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.algorithms.bootstrap import programmable_bootstrap as jax_pbs
from tfhe_tpu.core.algorithms.multi_bit import multi_bit_bootstrap_key_to_ntt as jax_mb_to_ntt
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.params import MultiBitPBSParameters as JMultiBit
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.core.poly import fourstep
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import config, interop, shortint
from tfhe_tpu_torch.core.algorithms import programmable_bootstrap
from tfhe_tpu_torch.core.entities import GlweCiphertext, LweCiphertext
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import MultiBitPBSParameters
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.poly import rotation
from torch_keys import multi_bit_params, random_bsk, random_multi_bit_bsk

U64 = np.uint64
N, R, NPR = P.polynomial_size, P.glwe_size, 4
G = 2
TPM, JPM = multi_bit_params(MultiBitPBSParameters, P, G, 16), multi_bit_params(JMultiBit, JP, G, 16)
SWITCHES = {"TFHE_TPU_MXU": "_USE_MXU", "TFHE_TPU_MXU_LANES": "_MXU_LANES",
            "TFHE_TPU_FUSED": "_FUSED_ROTATION"}


@pytest.fixture(scope="module")
def keys():
    """A classic and a g=2 multi-bit key (uniform numpy arrays), each
    converted by both packages under the default switches."""
    std = random_bsk(P, 21)
    mb_std = random_multi_bit_bsk(TPM, 42)
    jkey = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, NPR))(
        jnp.asarray(std))
    jmb = jax.jit(lambda d: jax_mb_to_ntt(d, JP.pbs_decomp, G, 64))(jnp.asarray(mb_std))
    assert (jkey.paired_order, jmb.u32_order) == ("fourstep", "fourstep")
    return dict(std=std, mb_std=mb_std, jkey=jkey, jmb=jmb,
                key=interop.bootstrap_key_from_standard(std, P.pbs_decomp, NPR, device="cpu"),
                mb=interop.multi_bit_bootstrap_key_from_standard(mb_std, P.pbs_decomp, G, NPR,
                                                                 device="cpu"))


def _inputs(batch, n_in, seed, per_element=False):
    rng = np.random.default_rng(seed)
    lwe = rng.integers(0, 2 ** 64, (batch, n_in + 1), dtype=U64)
    lwe[0, :3] = [2 ** 64 - 1, 2 ** 63, 0]
    lut = rng.integers(0, 2 ** 64, (batch, R, N) if per_element else (R, N), dtype=U64)
    return lwe, lut


def _rotate(fn, lut, lwe, key):
    return to_numpy_u64(fn(from_numpy_u64(lut), from_numpy_u64(lwe), key))


# ---------------------------------------------------------------------------
# one step against blind_rotate_step_pallas_mxu (B4)
# ---------------------------------------------------------------------------


def _jax_step(acc, ph, bsk_j, mode):
    """One B4 step on acc [B, R, N] u64 with pre-gathered phases and a key
    slice in four-step order (the layouts `blind_rotate_pallas` builds)."""
    n1, n2 = fourstep._split_nm(N)
    tab = fourstep.monomial_full_tables(N, NPR, mode == "delta")
    hi = (acc >> U64(32)).astype(np.uint32).reshape(acc.shape[:-1] + (n1, n2))
    lo = acc.astype(np.uint32).reshape(acc.shape[:-1] + (n1, n2))
    data, shoup = (np.asarray(a).reshape(a.shape[:-1] + (n1, n2)) for a in bsk_j)
    hi, lo = jax.jit(lambda *a: jax_pallas.blind_rotate_step_pallas_mxu(
        *a, JP.pbs_decomp, n=N, num_primes=NPR, glwe_size=R, block_b=8, interpret=True,
        grouping=G if mode == "multibit" else 1, mode=mode))(
        tab[0][ph], tab[1][ph], hi, lo, data, shoup)
    out = (np.asarray(hi).astype(U64) << U64(32)) | np.asarray(lo).astype(U64)
    return out.reshape(acc.shape)


@pytest.mark.parametrize("mode", ["delta", "multibit"])
def test_step_matches_jax(keys, mode):
    rng = np.random.default_rng(5)
    acc = rng.integers(0, 2 ** 64, (8, R, N), dtype=U64)
    acc[0, 0, :4] = [2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0]             # C1: top bit set
    j = 3
    if mode == "delta":
        e = rng.integers(0, 2 * N, 8)
        e[:3] = [0, N, 2 * N - 1]
        ref = _jax_step(acc, e, (keys["jkey"].paired[j], keys["jkey"].paired_shoup[j]), mode)
        e_port, key_slice, port_mode = torch.from_numpy(e), keys["key"].spectra[j], "delta"
    else:
        grp = rng.integers(0, 2 * N, (8, 1, G))
        grp[0, 0] = [2 * N - 1, N]                                      # c_3 wraps mod 2N
        c = rotation.variant_exponents(torch.from_numpy(grp.reshape(8, G)), G, N)[:, 0]
        ref = _jax_step(acc, c.numpy(), (keys["jmb"].data_u32[j], keys["jmb"].shoup_u32[j]),
                        mode)
        e_port, key_slice, port_mode = c, keys["mb"].spectra[j], "variants"
    before = (rotation.step_launches, rotation.step_variant_launches)
    port = from_numpy_u64(acc)
    out = rotation.blind_rotate_step(port, e_port, key_slice, port_mode, P.pbs_decomp)
    assert out is port                                     # updated in place
    np.testing.assert_array_equal(to_numpy_u64(out), ref)
    assert (rotation.step_launches, rotation.step_variant_launches) == before


def test_step_refuses_other_devices_and_modes(keys):
    acc = torch.zeros((1, R, N), dtype=torch.int64, device="meta")
    e = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        rotation.blind_rotate_step(acc, e, keys["key"].spectra[0], "delta", P.pbs_decomp)
    with pytest.raises(ValueError, match="mode"):
        rotation.blind_rotate_step(torch.zeros((1, R, N), dtype=torch.int64),
                                   torch.zeros((1,), dtype=torch.int64),
                                   keys["key"].spectra[0], "paired", P.pbs_decomp)


# ---------------------------------------------------------------------------
# the classic per-step rotation against B4 and B5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [False, True], ids=["B4", "B5"])
def test_steps_match_jax(keys, lanes):
    lwe, lut = _inputs(8, P.lwe_dimension, seed=11)
    fn = lambda lt, lw, b, s: jax_pallas.blind_rotate_pallas(
        lt, lw, b, s, JP.pbs_decomp, block_b=8, interpret=True, mxu=True, lanes=lanes)
    if not lanes:           # XLA:CPU cannot compile the lanes layout under jit; run it eagerly
        fn = jax.jit(fn)
    ref = np.asarray(fn(jnp.asarray(lut), jnp.asarray(lwe), keys["jkey"].paired,
                        keys["jkey"].paired_shoup))
    before = rotation.step_launches
    np.testing.assert_array_equal(_rotate(rotation.blind_rotate_steps, lut, lwe, keys["key"]),
                                  ref)
    np.testing.assert_array_equal(_rotate(rotation.blind_rotate_fused, lut, lwe, keys["key"]),
                                  ref)
    assert rotation.step_launches == before


# ---------------------------------------------------------------------------
# the switches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env", [{}, {"TFHE_TPU_MXU": "0"}, {"TFHE_TPU_MXU_LANES": "1"},
                                 {"TFHE_TPU_FUSED": "false"}, {"TFHE_TPU_MXU": "1"}],
                         ids=["defaults", "mxu0", "lanes1", "fused-false", "mxu1"])
def test_switches_read_the_environment_as_jax_does(monkeypatch, env):
    for name, attr in SWITCHES.items():
        monkeypatch.delenv(name, raising=False)
        monkeypatch.setattr(config, attr, None)
        monkeypatch.setattr(jconfig, attr, None)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = (config.use_mxu_ntt(), config.use_mxu_lanes(), config.use_fused_rotation())
    assert got == (jconfig.use_mxu_ntt(), jconfig.use_mxu_lanes(), jconfig.use_fused_rotation())
    config.set_use_fused_rotation(not got[2])
    assert config.use_fused_rotation() is (not got[2])


# Each row of the switch table: the switches, and the JAX kernel route it
# takes for a classic and a multi-bit key.  ROTATION_LOOP only changes the
# fused kernel's inside, so its row routes as the defaults do.
ROWS = {
    "defaults": ({}, ("fused", "delta"), ("fused", "multibit")),
    "fused0": ({"_FUSED_ROTATION": False}, ("steps", True, False), ("mb-steps", True, False)),
    "lanes1": ({"_MXU_LANES": True}, ("steps", True, True), ("mb-steps", True, True)),
    "mxu0": ({"_USE_MXU": False}, ("steps", False, False), ("mb-steps", False, False)),
    "loop1": ({}, ("fused", "delta"), ("fused", "multibit")),
}


def _port_kernels(jax_route, n_in):
    """The port's kernel launches for one PBS on the JAX route given."""
    if jax_route[0] == "fused":
        return {"K1" if jax_route[1] == "delta" else "K3": 1}
    if jax_route[0] == "steps":
        return {"K4" if jax_route[1] else "K5/V=2": n_in}
    return {f"K5/V={1 << G}": n_in // G}


def _spy_jax(monkeypatch, seen):
    def fused(lut, lwe, *a, mode, **kw):
        seen.append(("fused", mode))
        return jnp.zeros(lwe.shape[:-1] + (R, N), jnp.uint64)

    def steps(name):
        def run(lut, lwe, *a, mxu=False, lanes=False, **kw):
            seen.append((name, mxu, lanes))
            return jnp.zeros(lwe.shape[:-1] + (R, N), jnp.uint64)
        return run

    monkeypatch.setattr(jax_pallas, "blind_rotate_fused", fused)
    monkeypatch.setattr(jax_pallas, "blind_rotate_pallas", steps("steps"))
    monkeypatch.setattr(jax_pallas, "multi_bit_blind_rotate_pallas", steps("mb-steps"))


def _spy_port(monkeypatch, seen):
    def count(name):
        seen[name] = seen.get(name, 0) + 1

    def k1(acc, exps, key):
        count("K1")
        return acc

    def k3(acc, exps, key):
        count("K3")
        return acc

    def step(acc, exps_j, key_slice, mode, decomp):
        count("K4" if mode == "delta" else f"K5/V={key_slice.shape[0]}")
        return acc

    monkeypatch.setattr(rotation, "rotate_accumulator", k1)
    monkeypatch.setattr(rotation, "rotate_accumulator_multi_bit", k3)
    monkeypatch.setattr(rotation, "blind_rotate_step", step)


@pytest.mark.parametrize("row", sorted(ROWS))
def test_switch_table_routes_as_jax(keys, row, monkeypatch):
    """Both packages convert their keys under the row's switches and run a
    PBS; each records the kernel it reaches (spies in place of the
    rotations), and the port's kernel must be the counterpart of JAX's."""
    switches, want_classic, want_mb = ROWS[row]
    for attr in SWITCHES.values():
        value = switches.get(attr, True if attr != "_MXU_LANES" else False)
        monkeypatch.setattr(config, attr, value)
        monkeypatch.setattr(jconfig, attr, value)
    monkeypatch.setattr(jconfig, "_USE_PALLAS", True)
    monkeypatch.setattr(jconfig, "_PALLAS_INTERPRET", True)
    if row == "loop1":
        monkeypatch.setenv("TFHE_TPU_ROTATION_LOOP", "1")
    jkey = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, NPR))(
        jnp.asarray(keys["std"]))
    jmb = jax.jit(lambda d: jax_mb_to_ntt(d, JP.pbs_decomp, G, 64))(jnp.asarray(keys["mb_std"]))
    key = interop.bootstrap_key_from_standard(keys["std"], P.pbs_decomp, NPR, device="cpu")
    mb = interop.multi_bit_bootstrap_key_from_standard(keys["mb_std"], P.pbs_decomp, G, NPR,
                                                       device="cpu")
    lut = np.zeros((R, N), U64)
    jseen, pseen = [], {}
    _spy_jax(monkeypatch, jseen)
    _spy_port(monkeypatch, pseen)

    lwe = np.zeros((2, P.lwe_dimension + 1), U64)
    jax_pbs(JLwe(data=jnp.asarray(lwe)), JGlwe(data=jnp.asarray(lut)), jkey, 64)
    port_lwe, port_lut = LweCiphertext(data=from_numpy_u64(lwe)), GlweCiphertext(
        data=from_numpy_u64(lut))
    programmable_bootstrap(port_lwe, port_lut, key)
    assert (jseen, pseen) == ([want_classic], _port_kernels(want_classic, P.lwe_dimension))
    jseen.clear(), pseen.clear()
    shortint.ServerKey(ksk=None, bsk=key, params=P)._pbs(port_lwe, port_lut)
    assert pseen == _port_kernels(want_classic, P.lwe_dimension)

    jseen.clear(), pseen.clear()
    lwe = np.zeros((2, TPM.lwe_dimension + 1), U64)
    JServerKey(ksk=None, bsk=jmb, params=JPM)._pbs(JLwe(data=jnp.asarray(lwe)),
                                                    JGlwe(data=jnp.asarray(lut)))
    shortint.ServerKey(ksk=None, bsk=mb, params=TPM)._pbs(
        LweCiphertext(data=from_numpy_u64(lwe)), port_lut)
    assert (jseen, pseen) == ([want_mb], _port_kernels(want_mb, TPM.lwe_dimension))
