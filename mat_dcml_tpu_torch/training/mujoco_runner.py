"""Multi-agent MuJoCo (lite) training: the continuous MAT policy and its runner.

Port of ``mat_dcml_tpu/training/generic_runner.py::build_discrete_policy``
(the action family from the env's action space) and of the training loop of
``mat_dcml_tpu/training/mujoco_runner.py::MujocoRunner`` for the MAT
algorithm over :class:`~mat_dcml_tpu_torch.envs.mamujoco.MJLiteEnv`, with the
episodic runner's checkpoints, resume and graceful stop.  Not ported yet
(ROADMAP.md queue 1, item 10): fault injection and the faulty-node
evaluation sweep (``envs/mamujoco/fault.py``), per-episode agent-order
shuffling (``--random_order``), the real-MuJoCo gym backend, and evaluation.
"""

from __future__ import annotations

from typing import Optional

import torch

from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.mamujoco.lite import MJLiteConfig, MJLiteEnv
from mat_dcml_tpu_torch.envs.spaces import Box
from mat_dcml_tpu_torch.models.mat import CONTINUOUS, DISCRETE, MATConfig
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.runner import EpisodicRunner, check_run


def build_policy(run: RunConfig, env, device=None,
                 generator: Optional[torch.Generator] = None) -> TransformerPolicy:
    """MAT for a TimeStep env: continuous actions where the env declares a
    ``Box`` action space, else discrete (``transformer_policy.py:28-39``)."""
    check_run(run)
    continuous = isinstance(getattr(env, "action_space", None), Box)
    cfg = MATConfig(
        n_agent=env.n_agents, obs_dim=env.obs_dim, state_dim=env.share_obs_dim,
        action_dim=env.action_dim, n_block=run.n_block, n_embd=run.n_embd, n_head=run.n_head,
        action_type=CONTINUOUS if continuous else DISCRETE, dtype=run.model_dtype,
    )
    return TransformerPolicy(cfg, decode_mode=run.decode_mode, device=device, generator=generator)


class MujocoRunner(EpisodicRunner):
    """MAT on multi-agent MuJoCo lite, the episodic collect-then-train loop."""

    def __init__(self, run: RunConfig, ppo: PPOConfig, env_config: MJLiteConfig = MJLiteConfig(),
                 log_fn=print):
        if run.use_eval:
            raise NotImplementedError("use_eval: MuJoCo's evaluation is not ported yet "
                                      "(ROADMAP.md queue 1, item 10)")
        self.env_config = env_config
        super().__init__(run, ppo, log_fn)

    def make_env(self) -> MJLiteEnv:
        return MJLiteEnv(self.env_config, device=self.device)

    def make_policy(self, generator: torch.Generator) -> TransformerPolicy:
        return build_policy(self.run_cfg, self.env, device=self.device, generator=generator)
