"""FlexAI in PyTorch: Q-net and TD update, replay, reward, and the
step-loop engine (greedy placement and single-lane training)."""
from repro_torch.core.flexai.config import FlexAIConfig  # noqa: F401
from repro_torch.core.flexai.dqn import (DQNParams, load_dqn_npz,  # noqa: F401
                                         params_from_numpy, qnet_apply,
                                         save_dqn_npz)
from repro_torch.core.flexai.engine import (Draws, ScanFlexAI,  # noqa: F401
                                            TrainState, make_schedule_fn,
                                            make_train_fn, train_init)
