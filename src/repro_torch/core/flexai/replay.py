"""Device-resident experience replay (paper §7.1 step (2)).

``DeviceReplay`` is the JAX package's ring buffer as tensors.  Unlike the
JAX version (pure, returning new arrays), ``device_replay_add`` writes the
ring in place: a functional copy of a [50,001, D] buffer per step would
cost more than the step.  ``ptr`` and ``size`` are host integers, since
they depend only on which tasks are valid, so deciding an update never
waits for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DeviceReplay(NamedTuple):
    s: torch.Tensor       # [C + 1, D] f32
    a: torch.Tensor       # [C + 1] i32
    r: torch.Tensor       # [C + 1] f32
    s_next: torch.Tensor  # [C + 1, D] f32
    done: torch.Tensor    # [C + 1] f32
    ptr: int
    size: int

    @property
    def capacity(self) -> int:
        return self.s.shape[0] - 1


def device_replay_init(capacity: int, state_dim: int,
                       device="cpu") -> DeviceReplay:
    """Rows [0, capacity) are the ring; row ``capacity`` is a trash slot
    that absorbs masked-out writes."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device=device)

    return DeviceReplay(
        s=z(capacity + 1, state_dim), a=z(capacity + 1, dtype=torch.int32),
        r=z(capacity + 1), s_next=z(capacity + 1, state_dim),
        done=z(capacity + 1), ptr=0, size=0)


def device_replay_add(buf: DeviceReplay, s, a, r, s_next, done,
                      write: bool = True) -> DeviceReplay:
    """Circular write at ``ptr`` (in place); when ``write`` is False
    (padding row) the values land in the trash slot instead."""
    cap = buf.capacity
    i = buf.ptr if write else cap
    buf.s[i] = s
    buf.a[i] = a
    buf.r[i] = r
    buf.s_next[i] = s_next
    buf.done[i] = done
    if not write:
        return buf
    return buf._replace(ptr=(buf.ptr + 1) % cap,
                        size=min(buf.size + 1, cap))


def device_replay_sample(buf: DeviceReplay, idx: torch.Tensor) -> dict:
    """Gather the rows ``idx`` ([B], drawn uniformly over the filled
    prefix by the caller)."""
    return {"s": buf.s[idx], "a": buf.a[idx], "r": buf.r[idx],
            "s_next": buf.s_next[idx], "done": buf.done[idx]}
