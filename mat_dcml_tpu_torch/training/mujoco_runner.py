"""Multi-agent MuJoCo (lite) training: the continuous MAT policy and its runner.

Port of ``mat_dcml_tpu/training/generic_runner.py::build_discrete_policy``
(the action family from the env's action space) and of the training loop of
``mat_dcml_tpu/training/mujoco_runner.py::MujocoRunner`` for the MAT
algorithm over :class:`~mat_dcml_tpu_torch.envs.mamujoco.MJLiteEnv`, with the
episodic runner's checkpoints, resume and graceful stop, and per-episode
agent-order shuffling (``random_order``, ``envs/permute.py``).  Not ported
yet (ROADMAP.md queue 1, item 10): fault injection and the faulty-node
evaluation sweep (``envs/mamujoco/fault.py``), the real-MuJoCo gym backend,
and evaluation.
"""

from __future__ import annotations

from typing import Optional

import torch

from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.mamujoco.lite import MJLiteConfig, MJLiteEnv
from mat_dcml_tpu_torch.envs.permute import AgentPermutationWrapper
from mat_dcml_tpu_torch.envs.spaces import Box
from mat_dcml_tpu_torch.models.mat import CONTINUOUS, DISCRETE, MATConfig
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.runner import EpisodicRunner, check_run


def build_policy(run: RunConfig, env, device=None, generator: Optional[torch.Generator] = None,
                 algorithms=("mat",)) -> TransformerPolicy:
    """MAT for a TimeStep env: continuous actions where the env declares a
    ``Box`` action space, else discrete (``transformer_policy.py:28-39``),
    with the model fields of ``run`` as
    ``generic_runner.py::build_discrete_policy`` sets them (``mat_dec``:
    MAT-Dec's one MLP actor shared by all agents).  ``algorithms``: the
    ``algorithm_name`` values the caller trains."""
    check_run(run, algorithms)
    continuous = isinstance(getattr(env, "action_space", None), Box)
    mat_dec = run.algorithm_name == "mat_dec"
    cfg = MATConfig(
        n_agent=env.n_agents, obs_dim=env.obs_dim, state_dim=env.share_obs_dim,
        action_dim=env.action_dim, n_block=run.n_block, n_embd=run.n_embd, n_head=run.n_head,
        action_type=CONTINUOUS if continuous else DISCRETE, dtype=run.model_dtype,
        encode_state=run.encode_state, dec_actor=run.dec_actor or mat_dec,
        share_actor=run.share_actor or mat_dec, n_objective=run.n_objective,
    )
    return TransformerPolicy(cfg, decode_mode=run.decode_mode, device=device, generator=generator)


class MujocoRunner(EpisodicRunner):
    """MAT on multi-agent MuJoCo lite, the episodic collect-then-train loop."""

    def __init__(self, run: RunConfig, ppo: PPOConfig, env_config: MJLiteConfig = MJLiteConfig(),
                 log_fn=print, random_order: bool = False):
        if run.use_eval:
            raise NotImplementedError("use_eval: MuJoCo's evaluation is not ported yet "
                                      "(ROADMAP.md queue 1, item 10)")
        dcml_only = [name for name in ("encode_state", "dec_actor", "share_actor")
                     if getattr(run, name)] + (["n_objective"] if run.n_objective != 1 else [])
        if dcml_only:
            raise NotImplementedError(f"{', '.join(dcml_only)}: the port reads these on DCML "
                                      "only (ROADMAP.md queue 1, item 10)")
        self.env_config = env_config
        self.random_order = random_order
        super().__init__(run, ppo, log_fn)

    def make_env(self):
        env = MJLiteEnv(self.env_config, device=self.device)
        return AgentPermutationWrapper(env) if self.random_order else env

    def make_policy(self, generator: torch.Generator) -> TransformerPolicy:
        return build_policy(self.run_cfg, self.env, device=self.device, generator=generator)
