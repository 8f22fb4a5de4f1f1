"""File-backed key cache keyed by name (counterpart of
`tfhe_tpu/utils/keycache.py`; reference tfhe/src/keycache/mod.rs:1-60).

Keys are generated once per name and shared by every process through the
tfhe_tpu-v1 files of `serialization`, so a cache written by the JAX package
loads here and the reverse.  Generation runs under an atomic O_EXCL lock
file that records its owner's pid; a lock whose owner has died is broken by
renaming it aside and checking the renamed file again, so two waiters never
both break it.  Loading puts the keys on the cache's device (the card
unless given device="cpu").
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable

from . import serialization


def _owner(path: Path) -> int:
    try:
        return int(path.read_text().strip() or "0")
    except (OSError, ValueError):
        return 0


def _alive(pid: int) -> bool:
    return bool(pid) and os.path.exists(f"/proc/{pid}")


class KeyCache:
    def __init__(self, root: str = "keys_cache", device="cuda"):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.device = device
        self._mem = {}

    def _path(self, name: str) -> Path:
        return self.root / f"{name}.npz"

    def _break_stale(self, lock: Path) -> None:
        """Remove a lock whose owner has died (rename, then re-check)."""
        if _alive(_owner(lock)) or not _owner(lock):
            return
        claimed = lock.with_suffix(f".stale.{os.getpid()}")
        try:
            os.rename(lock, claimed)
        except OSError:
            return                                 # another waiter broke it first
        if _alive(_owner(claimed)):
            os.rename(claimed, lock)               # raced: a live lock, put it back
        else:
            os.unlink(claimed)

    def get(self, name: str, generate: Callable[[], object]):
        """The keys cached under `name`, generated (under the lock) if absent."""
        if name in self._mem:
            return self._mem[name]
        path = self._path(name)
        lock = path.with_suffix(".lock")
        for _ in range(600):
            if path.exists():
                obj = serialization.load(path, device=self.device)
                self._mem[name] = obj
                return obj
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                self._break_stale(lock)
                time.sleep(1.0)
                continue
            os.write(fd, str(os.getpid()).encode())
            try:
                obj = generate()
                # a per-pid temporary name, published by an atomic rename
                tmp = path.with_suffix(f".tmp.{os.getpid()}.npz")
                serialization.save(obj, tmp, compress=False)
                os.replace(tmp, path)
                self._mem[name] = obj
                return obj
            finally:
                os.close(fd)
                try:
                    os.unlink(lock)
                except FileNotFoundError:
                    pass
        raise TimeoutError(f"key cache lock for {name} never released")

    def clear(self) -> None:
        self._mem.clear()
        for f in self.root.glob("*.npz"):
            f.unlink()


__all__ = ["KeyCache"]
