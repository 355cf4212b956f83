"""FlexAI in PyTorch: Q-net and TD update, replay, reward, the loop
trainer (``FlexAIAgent``) and the step-loop engine (greedy placement;
single-lane, population, data-parallel and sharded training)."""
from repro_torch.core.flexai.agent import FlexAIAgent  # noqa: F401
from repro_torch.core.flexai.config import FlexAIConfig  # noqa: F401
from repro_torch.core.flexai.dqn import (DQNLearner, DQNParams,  # noqa: F401
                                         load_dqn_npz, params_from_numpy,
                                         qnet_apply, save_dqn_npz)
from repro_torch.core.flexai.engine import (Draws, ScanFlexAI,  # noqa: F401
                                            TrainState, dp_train_init,
                                            make_dp_train_fn,
                                            make_schedule_fn,
                                            make_sharded_schedule_fn,
                                            make_sharded_train_fn,
                                            make_train_fn, train_init)
from repro_torch.core.flexai.replay import (DeviceReplay,  # noqa: F401
                                            ReplayBuffer)
from repro_torch.core.flexai.reward import compute_reward  # noqa: F401
