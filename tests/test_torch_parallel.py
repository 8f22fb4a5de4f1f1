"""The port's dp mesh (`tfhe_tpu_torch.parallel`) on CPU devices: the
batched KS+PBS step under `shard_map_kspbs` equals the unsplit port call
bit for bit (tolerance 0: rows are independent and the pipeline is exact),
on a mesh of 8 entries (the CPU named 8 times, as conftest's 8-device
virtual CPU mesh serves the JAX package) and on one of 2; it decrypts as
the JAX package's `shard_map_kspbs` over that 8-device mesh decrypts on the
same numpy key (the JAX XLA rotation differs from the port's delta form in
low bits, ROADMAP C4, so the words are not compared).  Then the placement
helpers, and the refusals: cp > 1, another batch axis, a batch that does
not divide, the card by default without one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.parallel as JPar
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu_torch import parallel as TPar
from tfhe_tpu_torch.core.entities import LweCiphertext
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.shortint.ciphertext import Ciphertext
from torch_jax_pbs import jax_server, port_keys
from torch_keys import decrypt_big, encrypt_big, real_keys

M = P.message_modulus
F = lambda x: (3 * x + 1) % M


@pytest.fixture(scope="module")
def sides():
    k = real_keys(P, seed=11)
    tck, tsk = port_keys(k, P)
    return k, tck, tsk


def _step(ct_data, sk, lut):
    ct = Ciphertext(lwe=LweCiphertext(data=ct_data), degree=M - 1, message_modulus=M,
                    carry_modulus=P.carry_modulus)
    return sk.apply_lookup_table(ct, lut).lwe.data


def _jax_step(ct_data, sk, lut):
    ct = JCt(lwe=JLwe(data=ct_data), degree=M - 1, message_modulus=M,
             carry_modulus=P.carry_modulus)
    return sk.apply_lookup_table(ct, lut).lwe.data


def _batch(k, batch, seed=21):
    msgs = np.arange(batch) % M
    return msgs, encrypt_big(P, k["big_bits"], msgs, seed)


@pytest.mark.parametrize("entries", [8, 2])
def test_dp_split_equals_unsplit(sides, entries):
    k, tck, tsk = sides
    msgs, data = _batch(k, 16)
    lut = tsk.generate_lookup_table(F)
    whole = _step(from_numpy_u64(data), tsk, lut)
    mesh = TPar.make_mesh(devices=["cpu"] * entries)
    assert mesh.shape == {"dp": entries, "cp": 1} and mesh.distinct == (torch.device("cpu"),)
    run = TPar.shard_map_kspbs(_step, mesh)
    out = run(from_numpy_u64(data), TPar.replicate_tree(tsk, mesh), lut)
    assert torch.equal(out, whole)
    np.testing.assert_array_equal(decrypt_big(P, k["big_bits"], to_numpy_u64(out)), F(msgs))
    shards = TPar.shard_lwe_batch(from_numpy_u64(data), mesh)
    assert torch.equal(run(shards, tsk, lut), whole)


def test_dp_split_decrypts_as_the_jax_mesh(sides):
    """The JAX package's dp shard_map over conftest's 8 CPU devices, on the
    same numpy key and ciphertexts, decrypts to what the port's mesh does."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    k, tck, tsk = sides
    msgs, data = _batch(k, 16, seed=22)
    jsk = jax_server(k, JP)
    jlut = jsk.generate_lookup_table(F)
    jmesh = JPar.make_mesh(8, cp=1)
    jout = jax.jit(JPar.shard_map_kspbs(_jax_step, jmesh))(
        JPar.shard_lwe_batch(jnp.asarray(data), jmesh), JPar.replicate_tree(jsk, jmesh),
        JPar.replicate_tree(jlut, jmesh))
    mesh = TPar.make_mesh(8, devices=["cpu"] * 8)
    out = TPar.shard_map_kspbs(_step, mesh)(from_numpy_u64(data), tsk,
                                            tsk.generate_lookup_table(F))
    mine = decrypt_big(P, k["big_bits"], to_numpy_u64(out))
    theirs = decrypt_big(P, k["big_bits"], np.asarray(jout))
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(mine, F(msgs))


def test_placement_helpers(sides):
    _, _, tsk = sides
    mesh = TPar.make_mesh(devices=["cpu", "cpu", "meta"])
    assert mesh.distinct == (torch.device("cpu"), torch.device("meta"))
    rep = TPar.replicate_tree({"sk": tsk, "again": tsk}, mesh)
    assert set(rep.copies) == {torch.device("cpu"), torch.device("meta")}
    meta = rep.on(torch.device("meta"))
    assert meta["sk"] is meta["again"], "an object met twice is moved once"
    assert meta["sk"].bsk.spectra.device.type == "meta"
    assert meta["sk"].ksk.data.device.type == "meta" and meta["sk"].ksk.limbs is None
    assert rep.on(torch.device("cpu"))["sk"].params == tsk.params
    assert TPar.shard_server_key_tree(tsk, mesh).copies.keys() == rep.copies.keys()
    parts = TPar.shard_lwe_batch(torch.arange(12).reshape(6, 2), mesh)
    assert [p.device.type for p in parts] == ["cpu", "cpu", "meta"]
    assert [tuple(p.shape) for p in parts] == [(2, 2)] * 3


def test_refusals(monkeypatch):
    with pytest.raises(NotImplementedError, match="cp axis"):
        TPar.make_mesh(devices=["cpu"] * 4, cp=2)
    mesh = TPar.make_mesh(devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="dp"):
        TPar.shard_map_kspbs(_step, mesh, batch_axis="cp")
    with pytest.raises(NotImplementedError, match="shard_lwe_batch"):
        TPar.pbs_sharding_specs(mesh)
    with pytest.raises(ValueError, match="does not divide"):
        TPar.shard_lwe_batch(torch.zeros(6, 3, dtype=torch.int64), mesh)
    with pytest.raises(ValueError, match="5 devices"):
        TPar.make_mesh(5, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPar.make_mesh()
