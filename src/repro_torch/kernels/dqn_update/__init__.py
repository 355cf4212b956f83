"""Fused DQN TD update: CUDA kernel (kernel.py), plain version (ref.py)
and the device-routing entry points (ops.py)."""
from .ops import dqn_td_grads_fused, dqn_td_update_fused  # noqa: F401
from .ref import dqn_td_grads_ref, dqn_td_update_ref  # noqa: F401
