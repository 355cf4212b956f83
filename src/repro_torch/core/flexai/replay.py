"""Experience replay memory (paper §7.1 step (2)).

``ReplayBuffer`` is the loop trainer's host ring (NumPy, sampled from
``np.random.default_rng(seed)``), a copy of the JAX package's.
``DeviceReplay`` is the JAX package's device ring as tensors: one ring
([C + 1, D] rows), or a stack of rings, one a lane ([L, C + 1, D], the
data-parallel and population trainers').  Unlike the JAX version (pure,
returning new arrays), ``device_replay_add`` writes the ring in place: a
functional copy of a [50,001, D] buffer per step would cost more than the
step.  ``ptr`` and ``size`` are host integers (NumPy [L] arrays for a
stack), since they depend only on which tasks are valid, so deciding an
update never waits for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ReplayBuffer:
    def __init__(self, capacity: int, state_dim: int, seed: int = 0):
        self.capacity = capacity
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity,), np.int32)
        self.r = np.zeros((capacity,), np.float32)
        self.s_next = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.size = 0
        self.ptr = 0
        self.rng = np.random.default_rng(seed)

    def add(self, s, a, r, s_next, done) -> None:
        i = self.ptr
        self.s[i] = s
        self.a[i] = a
        self.r[i] = r
        self.s_next[i] = s_next
        self.done[i] = float(done)
        self.ptr = (self.ptr + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, batch_size: int) -> dict:
        idx = self.rng.integers(0, self.size, size=batch_size)
        return {
            "s": self.s[idx], "a": self.a[idx], "r": self.r[idx],
            "s_next": self.s_next[idx], "done": self.done[idx],
        }


class DeviceReplay(NamedTuple):
    s: torch.Tensor       # [(L,) C + 1, D] f32
    a: torch.Tensor       # [(L,) C + 1] i32
    r: torch.Tensor       # [(L,) C + 1] f32
    s_next: torch.Tensor  # [(L,) C + 1, D] f32
    done: torch.Tensor    # [(L,) C + 1] f32
    ptr: "int | np.ndarray"
    size: "int | np.ndarray"

    @property
    def capacity(self) -> int:
        return self.s.shape[-2] - 1


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


# ---------------------------------------------------------------------------
# a stack of rings, one a lane
# ---------------------------------------------------------------------------

def device_replay_init_lanes(lanes: int, capacity: int, state_dim: int,
                             device="cpu") -> DeviceReplay:
    """``lanes`` rings of ``capacity`` rows (and a trash row each)."""
    one = device_replay_init(capacity, state_dim, device)
    return DeviceReplay(
        *[f.expand(lanes, *f.shape).clone() for f in one[:5]],
        ptr=np.zeros(lanes, np.int64), size=np.zeros(lanes, np.int64))


def device_replay_rows_lanes(buf: DeviceReplay, valid: np.ndarray):
    """Where an episode's writes go, decided on the host from ``valid``
    [L, T]: lane l's transition of step t goes to its ring's ``ptr`` while
    its task is valid and to its trash row otherwise.  Returns the rows
    as indices into the flattened stack ([L, T], see
    :func:`device_replay_write_lanes`) and the ring with its counters
    after the episode."""
    cap = buf.capacity
    lanes = valid.shape[0]
    before = np.cumsum(valid, axis=1) - valid      # valid writes before t
    rows = np.where(valid, (buf.ptr[:, None] + before) % cap, cap)
    flat = rows + np.arange(lanes)[:, None] * (cap + 1)
    n = valid.sum(axis=1)
    return flat, buf._replace(ptr=(buf.ptr + n) % cap,
                              size=np.minimum(buf.size + n, cap))


def device_replay_write_lanes(buf: DeviceReplay, flat_rows: torch.Tensor,
                              s, a, r, s_next, done) -> None:
    """One transition a lane ([L] rows) written in place at ``flat_rows``
    ([L] indices into the flattened stack, on the ring's device)."""
    d = buf.s.shape[-1]
    buf.s.view(-1, d)[flat_rows] = s
    buf.a.view(-1)[flat_rows] = a.to(buf.a.dtype)
    buf.r.view(-1)[flat_rows] = r
    buf.s_next.view(-1, d)[flat_rows] = s_next
    buf.done.view(-1)[flat_rows] = done


def device_replay_flat_lanes(buf: DeviceReplay,
                             idx: torch.Tensor) -> torch.Tensor:
    """Lane l's ring rows ``idx[l, ...]`` as indices into the flattened
    stack."""
    lane = torch.arange(idx.shape[0], device=idx.device)
    return idx + lane.view(-1, *[1] * (idx.dim() - 1)) * (buf.capacity + 1)


def device_replay_sample_lanes(buf: DeviceReplay,
                               flat_idx: torch.Tensor) -> dict:
    """The rows ``flat_idx`` ([L, B] indices into the flattened stack) as
    a [L, B, ...] batch."""
    d = buf.s.shape[-1]
    return {"s": buf.s.view(-1, d)[flat_idx], "a": buf.a.view(-1)[flat_idx],
            "r": buf.r.view(-1)[flat_idx],
            "s_next": buf.s_next.view(-1, d)[flat_idx],
            "done": buf.done.view(-1)[flat_idx]}
