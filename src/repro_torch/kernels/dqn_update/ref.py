"""Plain PyTorch version of the fused TD-update kernel.

As in the JAX package, the kernel's oracle is the trainer math itself:
:func:`repro_torch.core.flexai.dqn.dqn_td_grads` (autograd over the
Huber double-DQN loss + global-norm clip) and ``dqn_td_update`` (grads +
``adam_apply``).  ``ops`` sends CPU tensors here; ``chip_smoke.py`` holds
the CUDA kernel against these on the card.
"""
from repro_torch.core.flexai.dqn import dqn_td_grads, dqn_td_update

dqn_td_grads_ref = dqn_td_grads
dqn_td_update_ref = dqn_td_update
