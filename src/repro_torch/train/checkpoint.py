"""Checkpointing: chunked npz shards + JSON manifest with integrity hashes.

The port of `repro/train/checkpoint.py`, file for file the same format, so
a checkpoint written by either package restores in the other bit for bit:

  * layout — a step is a directory `step_<10 digits>` holding
    `shard_<5 digits>.npz` files of ~CHUNK_BYTES and `manifest.json` (the
    step, the caller's `extra`, and each shard's file name, crc32, leaf
    names and dtypes). Leaves are named as the JAX package names them:
    the tree is flattened as `jax.tree_util` flattens it (dicts in sorted
    key order, lists and tuples by index, None as an empty subtree) and
    each leaf's keys are joined with "/" ("%" inside an npz key).
  * dtypes — bfloat16 has no numpy dtype: a bfloat16 leaf is stored as its
    raw 16 bits (`Tensor.view(torch.int16)`, written as uint16) with
    "bfloat16" in the manifest, as the reference stores it.
  * integrity — every shard carries a crc32 in the manifest; restore
    verifies before handing tensors out (a half-written shard fails
    loudly, and the manager falls back to the previous step).
  * placement — restore puts each leaf on its template leaf's device, in
    its dtype (the reference's `shardings` has no counterpart here).
  * async — `save_async` copies the tree to the host at once and hands
    the copy to a writer thread; `wait()` joins before the next save
    (bounded staleness 1).

`StreamCheckpointer` builds on the manager for always-on chunked-online
SNN runs: one snapshot per window captures the full streaming tree —
`state[node]` neuron tensors, `syn:<conn>` plasticity state, params, and
the host RNG state of the input stream — and restores it bit-identically
(same-dtype leaves round-trip exactly), so an interrupted stream resumes
mid-sequence with no numerical drift.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

CHUNK_BYTES = 256 * 1024 * 1024

# leaves as the writer holds them: (name, savable numpy array, dtype name)
_Leaf = Tuple[str, np.ndarray, str]


def _paths(tree: Any, prefix: Tuple[str, ...] = ()
           ) -> List[Tuple[Tuple[str, ...], Any]]:
    """The tree's leaves with their key paths, in `jax.tree_util` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _paths(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _unflatten(tree: Any, leaves: List[Any]) -> Any:
    """`tree` with its leaves replaced, in `_paths` order, by `leaves`."""
    it = iter(leaves)

    def rebuild(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)
    return rebuild(tree)


def _to_savable(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy copy npz can hold, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).to("cpu", copy=True).numpy()
            return raw.view(np.uint16), "bfloat16"
        arr = t.to("cpu", copy=True).numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_savable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype_name:
        arr = arr.view(np.dtype(dtype_name))
    return torch.from_numpy(arr)


def _host_leaves(tree: Any) -> List[_Leaf]:
    return [("/".join(path), *_to_savable(leaf))
            for path, leaf in _paths(tree)]


def _write(ckpt_dir: str, step: int, leaves: List[_Leaf],
           extra: Optional[Dict] = None) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    shards: List[List[_Leaf]] = [[]]
    size = 0
    for leaf in leaves:
        if size > CHUNK_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(leaf)
        size += leaf[1].nbytes

    manifest = {"step": step, "extra": extra or {}, "shards": []}
    for i, shard in enumerate(shards):
        fname = f"shard_{i:05d}.npz"
        arrays = {name.replace("/", "%"): arr for name, arr, _ in shard}
        path = os.path.join(tmp, fname)
        np.savez(path, **arrays)
        with open(path, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["shards"].append(
            {"file": fname, "crc32": crc,
             "names": [n for n, _, _ in shard],
             "dtypes": {n: dt for n, _, dt in shard}})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    """Write step checkpoint atomically (tmp dir + rename)."""
    return _write(ckpt_dir, step, _host_leaves(tree), extra)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load_arrays(path: str) -> Dict[str, torch.Tensor]:
    """{leaf name: CPU tensor} of one step directory, each shard's crc32
    verified first."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for sh in manifest["shards"]:
        fpath = os.path.join(path, sh["file"])
        with open(fpath, "rb") as f:
            if zlib.crc32(f.read()) != sh["crc32"]:
                raise IOError(f"checksum mismatch in {fpath}")
        dtypes = sh.get("dtypes", {})
        with np.load(fpath) as z:
            for key in z.files:
                name = key.replace("%", "/")
                arr = z[key]
                out[name] = _from_savable(arr, dtypes.get(name,
                                                          str(arr.dtype)))
    return out


def restore_checkpoint(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of `like`: each leaf on its template
    leaf's device and in its dtype (a numpy template leaf comes back as a
    numpy array)."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    arrays = _load_arrays(path)
    out = []
    for keys, leaf in _paths(like):
        name = "/".join(keys)
        t = arrays[name]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: ckpt {tuple(t.shape)} != model "
                             f"{tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        else:
            out.append(t.numpy().astype(np.asarray(leaf).dtype))
    return _unflatten(like, out)


class CheckpointManager:
    """keep-last-k manager with an async writer thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.wait()
        leaves = _host_leaves(tree)                 # device->host now

        def work():
            _write(self.dir, step, leaves, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.wait()
        save_checkpoint(self.dir, step, tree, extra)
        self._gc()

    def restore_latest(self, like: Any) -> Tuple[Optional[int], Any]:
        self.wait()
        step = latest_step(self.dir)
        if step is None:
            return None, like
        try:
            return step, restore_checkpoint(self.dir, step, like)
        except Exception:
            # half-written / corrupt latest: fall back one step
            steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                           if d.startswith("step_"))
            for s in reversed(steps[:-1]):
                try:
                    return s, restore_checkpoint(self.dir, s, like)
                except Exception:
                    continue
            raise

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)


class StreamCheckpointer:
    """Durable snapshots of a chunked-online streaming run.

    One snapshot per processed window holds the complete resume tree:
    the engine state dict (neuron states, rings, `syn:<conn>` plasticity
    tensors), the current params (carrying weights already merged by
    `plasticity.apply_learned`), and the host-side RNG state driving the
    input stream. Restoring the latest snapshot and replaying from the
    recorded window is bit-identical to never having stopped: npz
    round-trips same-dtype leaves exactly, and `restore_checkpoint`
    places each leaf with `Tensor.to(device, dtype)` (a copy, no cast).

    ``save`` is synchronous by default — a streaming snapshot must be
    durable before its window's effects are published downstream; pass
    ``sync=False`` for the async writer (bounded staleness 1).
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.manager = CheckpointManager(ckpt_dir, keep)

    @staticmethod
    def _tree(state: Any, params: Any, rng: Any) -> Dict[str, Any]:
        # None members flatten to empty subtrees, so save/restore stay
        # structurally consistent as long as the caller is consistent
        return {"state": state, "params": params, "rng": rng}

    def save(self, window: int, state: Any, params: Any = None,
             rng: Any = None, extra: Optional[Dict] = None,
             sync: bool = True) -> None:
        """Snapshot the streaming tree after window `window` completed."""
        tree = self._tree(state, params, rng)
        meta = {"window": int(window), **(extra or {})}
        save: Callable = (self.manager.save_sync if sync
                          else self.manager.save_async)
        save(window, tree, extra=meta)

    def restore_latest(self, state: Any, params: Any = None, rng: Any = None
                       ) -> Tuple[Optional[int], Any, Any, Any]:
        """-> (last completed window or None, state, params, rng).

        The passed trees are templates (shapes/dtypes/devices) AND the
        cold-start values: with no checkpoint on disk they come back
        unchanged with window None, so callers can write one resume loop
        for both cases.
        """
        window, tree = self.manager.restore_latest(
            self._tree(state, params, rng))
        if window is None:
            return None, state, params, rng
        return window, tree["state"], tree["params"], tree["rng"]

    def wait(self) -> None:
        self.manager.wait()


__all__ = ["CHUNK_BYTES", "save_checkpoint", "latest_step",
           "restore_checkpoint", "CheckpointManager", "StreamCheckpointer"]
