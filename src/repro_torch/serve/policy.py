"""Shared QoS policy object, the port of ``repro.serve.policy`` (numpy
only).

Both serving engines, the token ``ServeEngine`` and the placement
``QoSPlacementEngine`` (``serve.qos``), route every deadline formula
through :class:`QoSPolicy`: EDF sort keys over an aging-credited
effective deadline, per-wave aging bookkeeping, the timeout-shed
predicate, and resolved-request miss/slack stats.  ``power_of_two_bucket``
is the shape quantization every wave engine shares (the placement
service too).
"""
from __future__ import annotations

import dataclasses

import numpy as np

POLICIES = ("edf", "fifo")


def power_of_two_bucket(n: int, minimum: int) -> int:
    """Power-of-two length bucket >= max(n, minimum) — the shared shape
    quantization of every wave engine (lockstep cost is set by the
    longest member, so co-batching only makes sense within a bucket).

    ``minimum`` must be >= 1: doubling from 0 (or a negative) never
    reaches ``n``.
    """
    if minimum < 1:
        raise ValueError(
            f"power_of_two_bucket minimum must be >= 1, got {minimum}")
    b = minimum
    while b < n:
        b *= 2
    return b


def effective_deadline(deadline: float, waves_waited: int,
                       aging_credit: float) -> float:
    """EDF comparison key: the absolute deadline minus the aging credit
    earned per passed-over wave.  Co-submitted cohorts age together (the
    credit cancels within them); it is earned against *later* arrivals,
    which is what bounds cross-bucket starvation."""
    return deadline - aging_credit * waves_waited


@dataclasses.dataclass(frozen=True)
class QoSPolicy:
    """The deadline discipline of the serving engines: admission policy,
    aging credit, and whether timeout shedding is armed."""
    policy: str = "edf"
    aging_credit: float = 0.0
    shed: bool = True

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}")

    @property
    def is_edf(self) -> bool:
        return self.policy == "edf"

    def eff_deadline(self, deadline: float, waves_waited: int) -> float:
        return effective_deadline(deadline, waves_waited, self.aging_credit)

    def request_key(self, req):
        """Admission sort key for anything with ``deadline`` /
        ``waves_waited`` / ``submit_order`` attributes: EDF on the
        effective deadline (submit order breaks ties) under "edf",
        plain submit order under "fifo"."""
        if self.is_edf:
            return (self.eff_deadline(req.deadline, req.waves_waited),
                    req.submit_order)
        return (req.submit_order,)

    def should_shed(self, now: float, service_need: float,
                    deadline: float) -> bool:
        """Timeout-shed predicate: the request's remaining service no
        longer fits before its deadline."""
        return self.shed and now + service_need > deadline

    @staticmethod
    def age(waiters) -> None:
        """One admission round passed a set of waiters over: each earns
        one wave of aging credit."""
        for w in waiters:
            w.waves_waited += 1

    @staticmethod
    def miss_stats(slacks, n_shed: int) -> dict:
        """Resolved-request miss/slack summary; the denominator is
        resolved requests only (completed + shed)."""
        slacks = np.asarray([s for s in slacks if s is not None], np.float64)
        missed = int((slacks < 0.0).sum()) if slacks.size else 0
        resolved = int(slacks.size) + int(n_shed)
        return {
            "resolved": resolved,
            "completed": int(slacks.size),
            "shed": int(n_shed),
            "missed_deadline": missed,
            "miss_rate": ((missed + n_shed) / resolved) if resolved else 0.0,
            "p50_slack": float(np.percentile(slacks, 50)) if slacks.size
            else 0.0,
            "p99_slack": float(np.percentile(slacks, 99)) if slacks.size
            else 0.0,
        }
