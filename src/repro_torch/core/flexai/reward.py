"""Reward computation (paper §7.2): after executing the M-th task,

    reward = Gvalue_new - Gvalue + MS_new - MS

where Gvalue = (-E - T + R_Balance)/3 over the whole platform and MS is the
summed Matching Score across accelerators.  ``snapshot`` /
``compute_reward`` read the NumPy ``HMAIPlatform`` (the loop trainer);
``reward_from_states`` the tensor ``PlatformState`` batches (the engines).
"""
from __future__ import annotations

from repro_torch.core.hmai import HMAIPlatform
from repro_torch.core.platform import gvalue_state, seq_sum


def snapshot(platform: HMAIPlatform) -> dict:
    return {"gvalue": platform.gvalue(), "ms": platform.total_ms}


def compute_reward(before: dict, platform: HMAIPlatform) -> float:
    after = snapshot(platform)
    return (after["gvalue"] - before["gvalue"]) + (after["ms"] - before["ms"])


def reward_from_states(spec, before, after):
    """[R] dGvalue + dMS between two ``PlatformState`` batches."""
    return ((gvalue_state(spec, after) - gvalue_state(spec, before))
            + (seq_sum(after.MS) - seq_sum(before.MS)))
