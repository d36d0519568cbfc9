"""Independent PPO: one policy an agent, decentralised value functions.

Port of ``mat_dcml_tpu/training/ippo.py`` (``ippo/ippo_policy.py`` +
``ippo_trainer.py``): each agent's actor and critic act on its own local
obs, and each agent is trained on its own slice of the shared rollout.  JAX
stacks the agents' parameters and ``vmap``s the MAPPO update over them; here
the policy holds one stack row an agent (``ActorCriticPolicy(n_stack=A)``)
and the MAPPO update runs on all rows at once (``training/mappo.py``): each
agent its own minibatch rows (its own epoch permutations, ``split(key, A)``
in JAX), its own targets and ValueNorm, its own gradient clip and its own
Adam moments and step count.  The importance weight is the product over the
action dims (``ippo_trainer.py:128``).
"""

from __future__ import annotations

import dataclasses

from mat_dcml_tpu_torch.models.actor_critic import ActorCriticPolicy
from mat_dcml_tpu_torch.training.ac_rollout import StackedRolloutCollector
from mat_dcml_tpu_torch.training.mappo import MAPPOConfig, MAPPOTrainer


class IPPORolloutCollector(StackedRolloutCollector):
    """Each agent's rows through its own policy, the critic on local obs
    (``use_local_value=True``; ``ippo.py:32-58``)."""

    def __init__(self, env, policy: ActorCriticPolicy, episode_length: int,
                 use_local_value: bool = True):
        super().__init__(env, policy, episode_length, use_local_value)


class IPPOTrainer(MAPPOTrainer):
    """The MAPPO update on every agent's stack row at once; the metrics are
    ``(A,)``, one an agent, as JAX's vmapped update returns them."""

    stacked = True

    def __init__(self, policy: ActorCriticPolicy, cfg: MAPPOConfig, n_agents: int):
        if policy.n_stack != n_agents:
            raise ValueError(f"IPPO needs one policy an agent: n_stack {policy.n_stack}, "
                             f"{n_agents} agents")
        super().__init__(policy, dataclasses.replace(cfg, importance_prod=True))
        self.n_agents = n_agents
