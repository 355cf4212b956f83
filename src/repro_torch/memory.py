"""Live device bytes of a program traced on meta tensors: the dry run's
stand-in for XLA's ``memory_analysis()``.

:class:`LiveBytes` is a ``TorchDispatchMode`` that sees every tensor an
op returns on the traced device.  A new storage adds its bytes, rounded
as the CUDA caching allocator rounds a request (to a multiple of 512
bytes, at least 512; nothing for an empty tensor), and the storage's
bytes leave when the last tensor that the mode saw on it is freed; a
view or an in-place result adds nothing.  ``peak`` is the most that was
live at once, the arguments held (:meth:`LiveBytes.hold`) included.

A hand-written kernel's op on meta tensors runs its plain version, whose
intermediates (a materialised score matrix, a chunked scan's decay
matrices) the kernel never allocates: :func:`as_kernel` runs it with
the mode quiet and then adds what the kernel allocates on the card, its
outputs and its workspace (the workspace only at that moment).
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_ACTIVE: list = []


def rounded(nbytes: int) -> int:
    """A request's bytes as the CUDA caching allocator counts them."""
    if nbytes <= 0:
        return 0
    return max(512, -(-nbytes // 512) * 512)


class LiveBytes(TorchDispatchMode):
    """Track the bytes live on ``device`` (default meta) under the mode:
    ``live``, ``peak`` and ``held`` (the arguments')."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = device
        self.live = self.peak = self.held = 0
        self._quiet = 0
        self._refs: dict = {}        # storage key -> [tensors seen, bytes]

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return super().__exit__(*exc)

    def _add(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage once; returns the bytes it added."""
        if t.device.type != self.device:
            return 0
        key = t.untyped_storage()._cdata
        ref = self._refs.get(key)
        added = 0
        if ref is None:
            added = rounded(t.untyped_storage().nbytes())
            ref = self._refs[key] = [0, added]
            self.live += added
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._drop, key, ref)
        return added

    def _drop(self, key, ref) -> None:
        ref[0] -= 1
        if ref[0] == 0 and self._refs.get(key) is ref:
            del self._refs[key]
            self.live -= ref[1]

    def hold(self, tree) -> int:
        """Count the tensors of ``tree`` (the program's arguments) as
        live; returns their bytes."""
        added = sum(self._add(t) for t in tree_leaves(tree)
                    if isinstance(t, torch.Tensor))
        self.held += added
        return added

    def bytes_of(self, tree, exclude=()) -> int:
        """The bytes of the distinct storages of ``tree``'s tensors on the
        device, less those of ``exclude``'s (arguments written in
        place)."""
        skip = {t.untyped_storage()._cdata for t in tree_leaves(exclude)
                if isinstance(t, torch.Tensor)}
        seen: dict = {}
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor) and t.device.type == self.device:
                key = t.untyped_storage()._cdata
                if key not in skip:
                    seen[key] = rounded(t.untyped_storage().nbytes())
        return sum(seen.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._quiet:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._add(t)
        return out


@contextlib.contextmanager
def untracked():
    """Within the block the active :class:`LiveBytes` (if any) counts
    nothing: for meta tensors that describe shapes and are never
    allocated on the card (``models.layers.abstract``'s boxes)."""
    mode = _ACTIVE[-1] if _ACTIVE else None
    if mode is not None:
        mode._quiet += 1
    try:
        yield
    finally:
        if mode is not None:
            mode._quiet -= 1


def as_kernel(fn, *args, workspace_bytes: int = 0, **kwargs):
    """``fn(*args, **kwargs)`` (a kernel's plain version); under an active
    :class:`LiveBytes`, counted as the kernel allocates: its outputs, and
    ``workspace_bytes`` at the moment of the launch only."""
    if not _ACTIVE:
        return fn(*args, **kwargs)
    mode = _ACTIVE[-1]
    with untracked():
        out = fn(*args, **kwargs)
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            mode._add(t)
    mode.peak = max(mode.peak, mode.live + rounded(workspace_bytes))
    return out
