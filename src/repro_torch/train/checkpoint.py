"""Checkpoints with an asynchronous save (twin of
``repro.train.checkpoint``), on the reference's on-disk layout:

* ``step_%08d/``, written as ``.tmp_step_N`` and renamed into place, so a
  checkpoint is visible only once it is whole (``latest_step`` ignores
  the temporary name);
* one ``.npy`` per leaf at its full shape, holding the leaf's bits as an
  unsigned integer array (0-d leaves written as shape (1,)), since
  ``np.save`` cannot round-trip bfloat16;
* ``meta.json``: the step, a manifest mapping each leaf's key (dict keys
  and ``#i`` list indices joined by ``::``) to its file, shape and dtype
  name (numpy's and ml_dtypes' spelling: ``"bfloat16"``, ``"float32"``,
  ``"int32"``), and ``extra``.

Either package reads what the other writes.  :class:`Checkpointer`
copies the tree to the host on the calling thread and writes it on a
worker thread, joined before the next save.  ``restore`` places each
leaf on the device and in the dtype of its ``like`` leaf, or, given
``sharding_fn``, onto a device mesh: the elastic restore of a
checkpoint saved by one process onto a multi-rank mesh, as the
reference's ``sharding_fn`` does.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, tree_map

__all__ = ["save", "restore", "latest_step", "Checkpointer"]

_SEP = "::"
_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def _key(path) -> str:
    return _SEP.join(str(p) if isinstance(p, str) else f"#{p}"
                     for p in path) or "_root"


def _flatten(tree) -> Dict[str, Any]:
    return {_key(path): leaf for path, leaf in flatten_with_path(tree)}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_bits(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bits as a contiguous uintN array, 0-d as (1,)."""
    t = t.detach().contiguous().reshape(-1 if t.dim() == 0 else t.shape)
    n = t.element_size()
    return t.view(_INT_OF_SIZE[n]).numpy().view(np.dtype(f"uint{8 * n}"))


def _from_bits(bits: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    dtype = getattr(torch, dtype_name)
    n = bits.dtype.itemsize
    t = torch.from_numpy(bits.view(np.dtype(f"int{8 * n}")).copy())
    return t.view(dtype).reshape(shape)


def save(ckpt_dir, step: int, tree, *, extra: Optional[Dict] = None) -> Path:
    """Blocking save of ``tree`` at ``step`` (atomic via rename)."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {}
    for key, leaf in _flatten(tree).items():
        t = leaf.detach().cpu()
        fname = f"{len(manifest):06d}.npy"
        np.save(tmp / fname, _to_bits(t))
        manifest[key] = {"file": fname, "shape": list(t.shape),
                         "dtype": _dtype_name(t.dtype)}
    meta = {"step": step, "manifest": manifest, "extra": extra or {}}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")]
    return max(steps) if steps else None


def restore(ckpt_dir, like, *, step: Optional[int] = None,
            sharding_fn: Optional[Callable] = None) -> Tuple[Any, int]:
    """Restore the checkpoint at ``step`` (default the latest) into the
    structure of ``like``, a tree of tensors (or DTensors; their global
    shapes are checked): each leaf lands on its ``like`` leaf's device in
    its dtype.  ``sharding_fn(path_key, tensor)``, given the leaf's key
    and its full host tensor (already in the ``like`` dtype), may return
    a ``(mesh, placements)`` pair, which places the leaf on that mesh
    (each rank keeps its own block; the device is the mesh's), a
    DTensor, which is used as it is, or None, the default placement.
    Raises ``FileNotFoundError`` when there is no checkpoint and
    ``ValueError`` when a key is missing or a shape differs."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "meta.json").read_text())["manifest"]
    flat_like = _flatten(like)
    missing = set(flat_like) - set(manifest)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    for key, like_leaf in flat_like.items():
        ent = manifest[key]
        if tuple(ent["shape"]) != tuple(like_leaf.shape):
            raise ValueError(
                f"{key}: checkpoint shape {tuple(ent['shape'])} != expected "
                f"{tuple(like_leaf.shape)}")

    def load(path, like_leaf):
        key = _key(path)
        ent = manifest[key]
        t = _from_bits(np.load(d / ent["file"]), ent["dtype"], ent["shape"])
        t = t.to(dtype=like_leaf.dtype)
        placed = sharding_fn(key, t) if sharding_fn is not None else None
        if placed is None:
            return t.to(device=like_leaf.device)
        if isinstance(placed, tuple):
            from repro_torch.parallel.api import place
            mesh, placements = placed
            return place(t.to(mesh.device_type), mesh, placements)
        return placed

    paths = iter(path for path, _ in flatten_with_path(like))
    return tree_map(lambda leaf: load(next(paths), leaf), like), step


class Checkpointer:
    """Asynchronous checkpointer: ``maybe_save`` returns once the tree is
    copied to the host; the write happens on a worker thread (joined
    before the next save, or by ``wait``)."""

    def __init__(self, ckpt_dir, *, every: int = 100, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.every = every
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Join the pending write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def maybe_save(self, step: int, tree, *, extra=None,
                   force: bool = False) -> bool:
        if not force and (step == 0 or step % self.every):
            return False
        self.wait()
        # copy to the host here; the caller may go on to change the tree
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save(self.dir, step, host_tree, extra=extra)
                self._gc()
            except Exception as e:      # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
