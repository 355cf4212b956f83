"""Fused DQN TD update: CUDA kernel (kernel.py), plain version (ref.py)
and the device-routing entry points (ops.py), one lane or L lanes."""
from .ops import (dqn_td_grads_fused, dqn_td_grads_lanes,  # noqa: F401
                  dqn_td_update_fused, dqn_td_update_lanes)
from .ref import (dqn_td_grads_lanes_ref, dqn_td_grads_ref,  # noqa: F401
                  dqn_td_update_lanes_ref, dqn_td_update_ref)
