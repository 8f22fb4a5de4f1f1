"""The data-parallel device mesh for batched KS+PBS (counterpart of
`tfhe_tpu/parallel/mesh.py`).

The JAX package's mesh has two axes: ``dp`` splits the ciphertext batch
(every device runs the whole KS+PBS on its shard, the keys replicated, no
collectives) and ``cp`` splits the CRT primes of the bootstrap key, on its
XLA path only (`tfhe_tpu/parallel/mesh.py:12-17`).  The port keeps ``dp``:

  * one process drives every device, as the single-controller
    `jax.shard_map` does.  The port's kernels launch on PyTorch's current
    stream and never wait on the host (`cuda_lib.stream_of`), so
    `shard_map_kspbs` queues each shard's step on its device's stream and
    the devices run concurrently; the shards are gathered back in order
    once every stream's work is queued behind the gathering stream;
  * a mesh may name one device several times (one card split in turns, or
    the CPU in tests): each repeat gets a stream of its own on that device,
    so shards overlap on one card too;
  * keys are replicated once per distinct device (`replicate_tree`).

``cp`` has no counterpart: no kernel of the port reads a partial prime set,
so `make_mesh(cp > 1)` raises (ROADMAP C, a deliberate deviation).  Nothing
here needs a card: a mesh of CPU devices runs the plain versions in turn.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..core.algorithms.keyswitch import keyswitch_key
from ..core.entities import LweKeyswitchKey
from ..cuda_lib import resolve_device

_CP_REFUSAL = ("the cp axis shards the CRT primes across devices on the JAX package's XLA "
               "path only (tfhe_tpu/parallel/mesh.py:12-17); no kernel of the port reads a "
               "partial prime set, so the port's mesh is dp only")


@dataclass(frozen=True)
class Mesh:
    """The dp axis: the devices a batch is split across, in order."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "cp": 1}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """Each device once, in first-named order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: Optional[int] = None, cp: int = 1, devices=None) -> Mesh:
    """A mesh of `devices` (torch devices or names; default every card),
    its first `n_devices`.  cp must be 1."""
    if cp != 1:
        raise NotImplementedError(f"cp = {cp}: {_CP_REFUSAL}")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(count)] or ["cuda"]
    devices = [resolve_device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, {len(devices)} named")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices=tuple(devices))


def pbs_sharding_specs(mesh: Mesh):
    """The JAX package's `NamedSharding`s for a jit over the (dp, cp) mesh
    have no torch meaning: place with `shard_lwe_batch` and
    `replicate_tree`."""
    raise NotImplementedError("NamedShardings place arrays for XLA's partitioner; the port "
                              "places shards itself (shard_lwe_batch, replicate_tree), and "
                              + _CP_REFUSAL)


def _moved(obj, device: torch.device, memo: dict):
    """obj (tensors, lists, tuples, dicts and dataclasses of them) with every
    tensor on `device`; an object met twice is moved once, and a keyswitch
    key is rebuilt there (its K2′ byte layout belongs to the card)."""
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif isinstance(obj, LweKeyswitchKey):
        out = keyswitch_key(obj.data.to(device), obj.decomp)
    elif isinstance(obj, (list, tuple)):
        out = type(obj)(_moved(x, device, memo) for x in obj)
    elif isinstance(obj, dict):
        out = {k: _moved(v, device, memo) for k, v in obj.items()}
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = dataclasses.replace(obj, **{f.name: _moved(getattr(obj, f.name), device, memo)
                                          for f in dataclasses.fields(obj) if f.init})
    else:
        out = obj
    memo[id(obj)] = out
    return out


@dataclass(frozen=True)
class Replicated:
    """A key (or any tree of tensors) placed once on each distinct device of
    a mesh: `copies[device]`."""

    copies: Dict[torch.device, object]

    def on(self, device: torch.device):
        return self.copies[device]


def replicate_tree(tree, mesh: Mesh) -> Replicated:
    """Put `tree` on every distinct device of the mesh, once each."""
    return Replicated(copies={d: _moved(tree, d, {}) for d in mesh.distinct})


def shard_server_key_tree(sk, mesh: Mesh) -> Replicated:
    """The server key placed for the mesh: with cp = 1 nothing is split,
    so this is `replicate_tree`."""
    return replicate_tree(sk, mesh)


def shard_lwe_batch(data: torch.Tensor, mesh: Mesh) -> list:
    """A [B, ...] ciphertext batch → one contiguous shard of the batch axis
    per mesh entry, each on its device (B must divide by the mesh size, as
    under the JAX package's dp sharding)."""
    if data.shape[0] % mesh.size:
        raise ValueError(f"a batch of {data.shape[0]} does not divide over {mesh.size} "
                         f"devices")
    return [part.to(dev) for part, dev in zip(torch.chunk(data, mesh.size), mesh.devices)]


def _streams(mesh: Mesh) -> list:
    """One stream per mesh entry: a device's current stream for its first
    entry, a new stream for each repeat; None off the card."""
    seen, out = set(), []
    for dev in mesh.devices:
        if dev.type != "cuda":
            out.append(None)
        elif dev in seen:
            out.append(torch.cuda.Stream(device=dev))
        else:
            seen.add(dev)
            out.append(torch.cuda.current_stream(dev))
    return out


def shard_map_kspbs(step: Callable, mesh: Mesh, batch_axis: str = "dp") -> Callable:
    """Wrap a batched `(ct_data, server_key, lut) -> out_data` step: the batch
    split over dp, the key and LUT replicated (`Replicated`, or any tree,
    replicated on the call), each shard's step queued on its own stream of
    its device, the outputs gathered in order on the first device's current
    stream.  The result equals the unsplit step's bit for bit: rows are
    independent."""
    if batch_axis != "dp":
        raise NotImplementedError(f"the port's mesh splits the batch over dp, not "
                                  f"{batch_axis!r}: {_CP_REFUSAL}")
    streams = _streams(mesh)

    def placed(tree):
        return tree if isinstance(tree, Replicated) else replicate_tree(tree, mesh)

    def run(ct_data, server_key, lut):
        sk, lt = placed(server_key), placed(lut)
        shards = ct_data if isinstance(ct_data, list) else shard_lwe_batch(ct_data, mesh)
        outs = []
        for shard, dev, stream in zip(shards, mesh.devices, streams):
            if stream is None:
                outs.append(step(shard, sk.on(dev), lt.on(dev)))
                continue
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                out = step(shard, sk.on(dev), lt.on(dev))
            outs.append(out)
        home = mesh.devices[0]
        for out, dev, stream in zip(outs, mesh.devices, streams):
            if stream is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_stream(stream)
                out.record_stream(current)
        return torch.cat([o.to(home) for o in outs])

    return run


__all__ = ["Mesh", "Replicated", "make_mesh", "pbs_sharding_specs", "replicate_tree",
           "shard_server_key_tree", "shard_lwe_batch", "shard_map_kspbs"]
