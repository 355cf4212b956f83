"""Checkpointing: save and restore a tree of arrays with a JSON manifest
(the port of ``repro.train.checkpoint``, with the same on-disk layout).

* **Layout**: ``<dir>/step_%08d/`` holds one ``arr_%05d.npy`` per leaf
  and a ``manifest.json`` of names, dtypes and shapes.  Leaves are named
  by their path in the JAX package's form (``"['ts']/.eval_p/.w1"``), so
  either package reads the other's checkpoints by name.
* **Atomic**: writes go to ``<dir>.tmp`` then ``os.replace``; a crash
  mid-write never corrupts the latest checkpoint.
* **Async**: ``AsyncCheckpointer`` copies to host memory synchronously and
  writes to disk on a background thread.

A tree is nested dicts (keys in sorted order), NamedTuples, lists and
tuples over leaves: tensors, NumPy arrays, NumPy and Python scalars and
``torch.Generator`` (its state bytes).  Tensors come to the host before
``save`` returns, every device's leaves in one transfer.  A bf16 tensor is
stored as its 16-bit patterns with ``"bfloat16"`` in the manifest, the
file the JAX package writes for an ``ml_dtypes`` array (no ``ml_dtypes``
needed here); it loads as ``uint16`` bits in ``BF16_BITS``.
``restore_checkpoint`` gives each leaf the template leaf's type, dtype
and device; float64 stays exact.

A state of ``DTensor`` leaves (a partitioned train state) saves as the
same files: every rank of its mesh takes part in gathering each leaf
whole to the host, on the calling thread, and the mesh's first rank
writes.  ``restore_checkpoint(..., shardings=)`` loads each array whole
and places it on a mesh by its ``NamedSharding``
(``sharding.place``), whatever mesh saved it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

# the host form of a bf16 leaf: its bits, marked for the manifest
BF16_BITS = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})


def _flatten_with_names(tree):
    """``(names, leaves, unflatten)``: leaves in the JAX package's order
    (dict keys sorted), named by path as ``jax.tree_util`` prints it;
    ``unflatten(leaves)`` rebuilds a tree of this structure.  None is an
    empty subtree."""
    names, leaves = [], []

    def walk(node, prefix):
        def sub(child, part):
            return walk(child, f"{prefix}/{part}" if prefix else part)
        if node is None:
            return lambda it: None
        if isinstance(node, dict):
            keys = sorted(node)
            subs = [sub(node[k], f"[{k!r}]") for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            subs = [sub(getattr(node, f), f".{f}") for f in node._fields]
            return lambda it: type(node)(*[s(it) for s in subs])
        if isinstance(node, (list, tuple)):
            subs = [sub(c, f"[{i}]") for i, c in enumerate(node)]
            return lambda it: type(node)([s(it) for s in subs])
        names.append(prefix)
        leaves.append(node)
        return lambda it: next(it)

    build = walk(tree, "")
    # ``walk`` reaches itself through its closure: drop the name, so that
    # the cycle (and the leaves it holds) does not wait for the collector
    del walk
    return names, leaves, lambda new: build(iter(new))


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the JAX package's order."""
    return _flatten_with_names(tree)[1]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), as ``jax.tree_util.tree_map``."""
    _, leaves, unflatten = _flatten_with_names(tree)
    others = [_flatten_with_names(t)[1] for t in rest]
    return unflatten([fn(*xs) for xs in zip(leaves, *others)])


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        return BF16_BITS
    return torch.empty((), dtype=dtype).numpy().dtype


def host_arrays(leaves) -> list:
    """Host NumPy copies of ``leaves``: the tensors of each device in ONE
    transfer (their bytes packed on the device), arrays copied, scalars
    as 0-d arrays, a generator as its state bytes."""
    out: list = [None] * len(leaves)
    by_dev: dict = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            by_dev.setdefault(x.device, []).append(i)
        elif isinstance(x, torch.Generator):
            out[i] = x.get_state().numpy()
        else:
            out[i] = np.array(x)
    for dev, idx in by_dev.items():
        flat = [leaves[i].detach().contiguous().reshape(-1) for i in idx]
        if dev.type == "cpu":
            raw = [f.view(torch.int16) if f.dtype == torch.bfloat16 else f
                   for f in flat]
            for i, f, r in zip(idx, flat, raw):
                out[i] = np.array(r.numpy()).view(_np_dtype(f.dtype)) \
                    .reshape(leaves[i].shape)
            continue
        buf = torch.cat([f.view(torch.uint8) for f in flat]).cpu().numpy()
        off = 0
        for i, f in zip(idx, flat):
            n = f.numel() * f.element_size()
            out[i] = buf[off: off + n].copy().view(_np_dtype(f.dtype)) \
                .reshape(leaves[i].shape)
            off += n
    return out


def _gathered(leaves):
    """(mesh, leaves): with ``DTensor`` leaves, their mesh and every leaf
    whole on the host (a collective: every rank of the mesh calls it);
    else (None, leaves)."""
    from repro_torch.sharding import partition as P
    mesh = P.mesh_of(leaves)
    if mesh is None:
        return None, leaves
    return mesh, [P.full_tensor(x, "cpu") for x in leaves]


def _writes(mesh) -> bool:
    """Whether this process writes a save from ``mesh``: its first rank
    (or any process without a mesh)."""
    import torch.distributed as dist
    return mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Blocking save.  Returns the checkpoint path.  With ``DTensor``
    leaves every rank of their mesh calls it; the first writes, and all
    return once the files are there."""
    names, leaves, _ = _flatten_with_names(state)
    mesh, leaves = _gathered(leaves)
    if mesh is None:
        return _write(directory, step, names, host_arrays(leaves))
    path = os.path.join(directory, f"step_{step:08d}")
    if _writes(mesh):
        _write(directory, step, names, host_arrays(leaves))
    from repro_torch import distributed as pdist
    pdist.mesh_barrier(mesh)
    return path


def _dtype_name(arr: np.ndarray) -> str:
    return (arr.dtype.metadata or {}).get("dtype", str(arr.dtype))


def _write(directory: str, step: int, names, host) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "arrays": []}
    for i, (name, arr) in enumerate(zip(names, host)):
        fname = f"arr_{i:05d}.npy"
        # bf16 bits as 2-byte voids: what NumPy writes for an ml_dtypes
        # bfloat16 array, so the JAX package reads the leaf as bf16
        np.save(os.path.join(tmp, fname),
                arr.view("V2") if arr.dtype.metadata else arr)
        manifest["arrays"].append({
            "name": name, "file": fname,
            "dtype": _dtype_name(arr), "shape": list(arr.shape),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = [d for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    if not steps:
        return None
    return os.path.join(directory, sorted(steps)[-1])


def _load_entry(path: str, entry: dict) -> np.ndarray:
    """One manifest array.  A bf16 leaf (2-byte voids on disk) comes back
    as its bits in ``BF16_BITS``."""
    arr = np.load(os.path.join(path, entry["file"]))
    if entry["dtype"] == "bfloat16":
        arr = arr.view(BF16_BITS)
    return arr


def load_checkpoint_arrays(path: str) -> tuple[int, list, list]:
    """Template-free restore: ``(step, host_arrays, names)`` in manifest
    order, the self-describing path the serving snapshots use."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = [_load_entry(path, e) for e in manifest["arrays"]]
    names = [e["name"] for e in manifest["arrays"]]
    return manifest["step"], arrays, names


def _shape(leaf) -> tuple:
    if isinstance(leaf, (torch.Tensor, np.ndarray)):
        return tuple(leaf.shape)
    return ()


def _like(leaf, arr: np.ndarray):
    """``arr`` as the template ``leaf``'s type, dtype and device."""
    if isinstance(leaf, torch.Generator):
        gen = torch.Generator(device=leaf.device)
        gen.set_state(torch.from_numpy(arr.copy()))
        return gen
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return arr.astype(leaf.dtype)
    return type(leaf)(arr[()])   # a NumPy or Python scalar


def restore_checkpoint(path: str, template: Any, shardings: Any = None) -> Any:
    """Restore into the structure of ``template``, each leaf as the
    template's (a tensor on the template tensor's device and dtype).

    ``shardings``: a tree of ``sharding.NamedSharding`` leaves of the
    template's structure, for the *target* mesh: each array is loaded
    whole and placed on it (``sharding.place``; every rank of the mesh
    reads the files), so a checkpoint saved from one mesh restores onto
    another."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names, leaves, unflatten = _flatten_with_names(template)
    by_name = {a["name"]: a for a in manifest["arrays"]}
    shards = [None] * len(leaves)
    if shardings is not None:
        shards = _flatten_with_names(shardings)[1]
        if len(shards) != len(leaves):
            raise ValueError(f"{len(leaves)} leaves in the template, "
                             f"{len(shards)} shardings")
    out = []
    for name, leaf, sh in zip(names, leaves, shards):
        arr = _load_entry(path, by_name[name])
        if (not isinstance(leaf, torch.Generator)
                and tuple(arr.shape) != _shape(leaf)):
            raise ValueError(
                f"checkpoint shape mismatch for {name}: "
                f"{arr.shape} vs {_shape(leaf)}")
        x = _like(leaf, arr)
        if sh is not None:
            from repro_torch.sharding import partition as P
            x = P.from_local(P.block_of(x, sh), sh)
        out.append(x)
    return unflatten(out)


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["step"]


class AsyncCheckpointer:
    """Copy to the host synchronously, write on a background thread.

    Writes are serialized in submission order (each background write
    joins the previous one) and stale steps lose: a ``save`` whose step
    is <= the newest step already submitted is dropped, so
    ``latest_checkpoint`` never goes backwards.

    ``state`` may be a zero-argument callable returning the tree: then
    the flatten and the host copy run on the writer thread too, and the
    callable must return copies that nothing mutates afterwards (tensors
    the serving or training loop writes in place are not such copies).

    A state of ``DTensor`` leaves is passed as a tree (a callable's
    leaves would be gathered off the calling thread, so they raise):
    every rank of the mesh calls ``save`` and ``wait``; ``save`` gathers
    each leaf whole to the host on the calling thread (a collective),
    only the mesh's first rank writes, and ``wait`` returns on every
    rank once the writes are on disk.

    A disk write retries ``OSError`` up to ``retries`` times with backoff
    ``backoff_s * 2**attempt``; a failed attempt is restartable, since
    ``_write`` wipes the partial ``.tmp`` first.  The last failure
    surfaces on ``wait()``.
    """

    def __init__(self, directory: str, keep: int = 3, *,
                 retries: int = 3, backoff_s: float = 0.05):
        self.directory = directory
        self.keep = keep
        self.retries = retries
        self.backoff_s = backoff_s
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._highest_step: int = -1
        self._mesh = None   # the mesh of saves since the last wait()

    def save(self, step: int, state: Any) -> None:
        mesh = None
        if callable(state):
            names = host = None   # made on the writer thread
        else:
            names, leaves, _ = _flatten_with_names(state)
            mesh, leaves = _gathered(leaves)
            host = host_arrays(leaves) if _writes(mesh) else None
        with self._lock:
            if step <= self._highest_step:
                return   # a newer (or equal) step is already in flight
            self._highest_step = step
            if mesh is not None:
                self._mesh = mesh
                if not _writes(mesh):
                    return
            prev = self._thread

            def work():
                if prev is not None:
                    prev.join()   # disk order == submission order
                try:
                    if names is None:
                        n, leaves, _ = _flatten_with_names(state())
                        from repro_torch.sharding import partition as P
                        if P.mesh_of(leaves) is not None:
                            raise ValueError(
                                "a state of DTensor leaves is saved as a "
                                "tree, not through a callable")
                        h = host_arrays(leaves)
                    else:
                        n, h = names, host
                    for attempt in range(self.retries + 1):
                        try:
                            _write(self.directory, step, n, h)
                            break
                        except OSError:
                            if attempt == self.retries:
                                raise
                            time.sleep(self.backoff_s * (2 ** attempt))
                    self._gc()
                except BaseException as e:   # surfaced on the next wait()
                    self._error = e

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
            mesh, self._mesh = self._mesh, None
        if t is not None:
            t.join()
        if mesh is not None:
            from repro_torch import distributed as pdist
            pdist.mesh_barrier(mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
