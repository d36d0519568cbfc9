"""The MLP actor-critic of the PPO / MAPPO / IPPO / HAPPO / HATRPO family.

Port of ``mat_dcml_tpu/models/actor_critic.py`` (``mat/algorithms/
actor_critic.py``), feed-forward:

- ``Actor``: ``MLPBase`` over local obs, then the ACT head
  (``actor_critic.py:11-116``); for the mixed DCML space the base's second
  stack is the head's full feature width;
- ``Critic``: ``MLPBase`` over the critic's obs, then a linear value head
  ``v_out`` (orthogonal gain 1), whose outputs live in the normalised-return
  space when the trainer keeps a ValueNorm or PopArt (``ops/popart.py``
  rescales its weights);
- :class:`ActorCriticPolicy`: the bundle, holding the weights as two flat
  tensors ``actor_flat`` and ``critic_flat`` of shape ``(S, P)``
  (``models/bases.py::ParamGroup``): ``S = 1`` for a policy shared by all
  agents (PPO, MAPPO), the agent count for one policy an agent (IPPO,
  HAPPO, HATRPO: JAX's stacked pytrees under ``vmap``).  Every method takes
  ``(S, N, ...)`` rows and optional flat tensors in place of the policy's
  own (a trainer's copies, or tensors that carry a gradient).

The recurrent hidden states are kept as in JAX (``init_hidden``,
``actor_h`` / ``critic_h`` in and out) so that the recurrent slice can fill
them; here they pass through unchanged (``use_recurrent_policy`` and
``CNNBase`` raise: ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mat_dcml_tpu_torch.device import resolve_device
from mat_dcml_tpu_torch.envs.spaces import DCMLActionSpace
from mat_dcml_tpu_torch.models.act_layer import ACNoise, ACTLayer
from mat_dcml_tpu_torch.models.bases import MLPBase, ParamGroup, dense, dense_spec
from mat_dcml_tpu_torch.ops.distributions import gumbel_noise


@dataclasses.dataclass(frozen=True)
class ACConfig:
    """Network settings (``config.py``'s network group defaults)."""

    hidden_size: int = 64
    layer_N: int = 1
    use_relu: bool = True
    use_feature_normalization: bool = True
    use_recurrent_policy: bool = False
    recurrent_N: int = 1
    std_x_coef: float = 1.0
    std_y_coef: float = 0.5
    image_obs: bool = False

    def __post_init__(self):
        if self.use_recurrent_policy or self.image_obs:
            raise NotImplementedError(
                "the recurrent actor-critic (GRULayer) and CNNBase are not ported yet "
                "(ROADMAP.md queue 1, item 9)")


class Actor:
    def __init__(self, cfg: ACConfig, space, obs_dim: int):
        out_dim = space.mixed_feature_dim if (
            isinstance(space, DCMLActionSpace) and space.mixed) else None
        self.base = MLPBase("actor/base", obs_dim, cfg.hidden_size, cfg.layer_N, cfg.use_relu,
                            cfg.use_feature_normalization, out_dim)
        self.act = ACTLayer("actor/act", space, self.base.d_out, cfg.std_x_coef, cfg.std_y_coef)

    def spec(self):
        return self.base.spec() + self.act.spec()


class Critic:
    def __init__(self, cfg: ACConfig, cent_obs_dim: int, n_objective: int = 1):
        self.base = MLPBase("critic/base", cent_obs_dim, cfg.hidden_size, cfg.layer_N,
                            cfg.use_relu, cfg.use_feature_normalization)
        self.n_objective = n_objective

    def spec(self):
        return self.base.spec() + dense_spec("critic/v_out", self.base.d_out, self.n_objective,
                                             1.0)

    def __call__(self, p, cent_obs):
        return dense(p, "critic/v_out", self.base(p, cent_obs))


class ACOutput(NamedTuple):
    value: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    actor_h: torch.Tensor
    critic_h: torch.Tensor


class ActorCriticPolicy:
    """The actor and critic weights of ``n_stack`` policies and the functions
    of them (module docstring).  The weights are drawn on the CPU from
    ``generator`` (the same on every device), actor first, then moved to
    ``device`` (default ``cuda``; raises when CUDA is absent)."""

    def __init__(self, cfg: ACConfig, obs_dim: int, cent_obs_dim: int, space,
                 n_objective: int = 1, n_stack: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.space = space
        self.obs_dim = obs_dim
        self.cent_obs_dim = cent_obs_dim
        self.n_stack = n_stack
        self.device = resolve_device(device)
        self.actor = Actor(cfg, space, obs_dim)
        self.critic = Critic(cfg, cent_obs_dim, n_objective)
        self.actor_group = ParamGroup(self.actor.spec())
        self.critic_group = ParamGroup(self.critic.spec())
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.actor_flat = self.actor_group.init(n_stack, gen).to(self.device)
        self.critic_flat = self.critic_group.init(n_stack, gen).to(self.device)

    # ------------------------------------------------------------- weights

    def actor_params(self, flat: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        return self.actor_group.views(self.actor_flat if flat is None else flat)

    def critic_params(self, flat: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        return self.critic_group.views(self.critic_flat if flat is None else flat)

    def load_tree(self, leaves: Dict[str, torch.Tensor]) -> None:
        """Load ``{flax path: value}`` (``actor/...`` and ``critic/...``, with
        or without the stack axis; ``bridge.py::ac_params_from_jax``)."""
        actor = {k: v for k, v in leaves.items() if k.startswith("actor/")}
        critic = {k: v for k, v in leaves.items() if k.startswith("critic/")}
        self.actor_flat.copy_(self.actor_group.from_tree(actor, self.n_stack))
        self.critic_flat.copy_(self.critic_group.from_tree(critic, self.n_stack))

    def tree(self) -> Dict[str, torch.Tensor]:
        """``{flax path: (S, *shape) view}`` of both groups."""
        return {**self.actor_params(), **self.critic_params()}

    def init_hidden(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        h = torch.zeros(n, self.cfg.recurrent_N, self.cfg.hidden_size, device=self.device)
        return h, h

    # ------------------------------------------------------------- noise

    def draw_noise(self, S: int, N: int, generator: Optional[torch.Generator],
                   lead: Tuple[int, ...] = ()) -> ACNoise:
        """A sample's noise for ``(S, N)`` rows (``lead`` axes in front, one a
        step of a chunk), drawn from ``generator`` on the policy's device:
        the Gumbel draws, then the normals."""
        g_shape, n_shape = self.actor.act.noise_shapes(S, N)
        gumbel = None if g_shape is None else gumbel_noise((*lead, *g_shape), generator,
                                                            self.device)
        normal = None if n_shape is None else torch.randn(
            (*lead, *n_shape), generator=generator, device=self.device)
        return ACNoise(gumbel, normal)

    # ------------------------------------------------------------- apply

    def act(self, obs, actor_h, masks, available_actions=None, deterministic: bool = False,
            noise: Optional[ACNoise] = None, actor_flat=None):
        """``(action, log_prob, actor_h)`` (``actor_critic.py:42-73``)."""
        p = self.actor_params(actor_flat)
        action, logp = self.actor.act.sample(p, self.actor.base(p, obs), available_actions,
                                             deterministic, noise)
        return action, logp, actor_h

    def get_values(self, cent_obs, critic_h, masks, critic_flat=None) -> torch.Tensor:
        return self.critic(self.critic_params(critic_flat), cent_obs)

    def get_actions(self, cent_obs, obs, actor_h, critic_h, masks, available_actions=None,
                    deterministic: bool = False, noise: Optional[ACNoise] = None,
                    actor_flat=None, critic_flat=None) -> ACOutput:
        action, logp, actor_h = self.act(obs, actor_h, masks, available_actions, deterministic,
                                         noise, actor_flat)
        value = self.get_values(cent_obs, critic_h, masks, critic_flat)
        return ACOutput(value, action, logp, actor_h, critic_h)

    def actor_evaluate(self, obs, actor_h, action, masks, available_actions=None,
                       active_masks=None, actor_flat=None):
        """``(log_prob, entropy (S,))`` of ``action`` (``actor_critic.py:75-117``)."""
        p = self.actor_params(actor_flat)
        return self.actor.act.evaluate(p, self.actor.base(p, obs), action, available_actions,
                                       active_masks)

    def evaluate_actions(self, cent_obs, obs, actor_h, critic_h, action, masks,
                         available_actions=None, active_masks=None, actor_flat=None,
                         critic_flat=None):
        """``(value, log_prob, entropy (S,))``."""
        logp, ent = self.actor_evaluate(obs, actor_h, action, masks, available_actions,
                                        active_masks, actor_flat)
        return self.get_values(cent_obs, critic_h, masks, critic_flat), logp, ent
