"""Action heads of the actor-critic family, over stacked parameters.

Port of ``mat_dcml_tpu/models/act_layer.py::ACTLayer`` (``sample``
``:145-232``, ``evaluate`` ``:233-``) for the four spaces DCML uses:

- the categorical worker (``Discrete``, or a plain ``DCMLActionSpace``):
  one linear head (gain 0.01), availability-masked logits;
- the ``extra`` Gaussian (``DCMLActionSpace(extra=True)``): a linear mean
  head and a learned ``log_std``, ``std = sigmoid(log_std / std_x) * std_y``;
- ``MixedRole``: both heads in one module, chosen per row by the role flag
  in the last ``available_actions`` column (``:165-178``);
- the joint mixed head (``DCMLActionSpace(mixed=True)``): no linear head;
  the features are sliced into ``n_sub`` groups of ``n`` logits and a
  Gaussian tail with ``std = sigmoid(log_std) * 0.5``, the log-probs summed
  over every part (``:210-232``), the entropies of both parts divided by
  0.98 (``act.py:195``).

Log-prob layouts follow the reference: categorical ``(.., 1)``, Gaussian
``(.., dim)`` per dim, ``MixedRole`` and mixed ``(.., 1)``.  Entropies are
the active-mask-weighted means of the reference, one a stack row ``(S,)``.
Every input is ``(S, N, ...)`` (``models/bases.py``).

Randomness is an input (:class:`ACNoise`): a categorical draw is
``argmax(logits + gumbel)``, the identity behind ``jax.random.categorical``,
and a Gaussian one ``mean + std * normal``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from mat_dcml_tpu_torch.envs.spaces import DCMLActionSpace, Discrete, MixedRole
from mat_dcml_tpu_torch.models.bases import ParamSpec, dense, dense_spec
from mat_dcml_tpu_torch.ops import distributions as D

GAIN_ACT_HEAD = 0.01


class ACNoise(NamedTuple):
    """A sample's noise, None where the space reads none: ``gumbel`` for the
    categorical parts, ``normal`` for the Gaussian ones."""

    gumbel: Optional[torch.Tensor]
    normal: Optional[torch.Tensor]


def _kind(space) -> str:
    if isinstance(space, MixedRole):
        if space.cont_dim != 1:
            raise NotImplementedError("MixedRole stores (B, 1) actions; cont_dim must be 1")
        return "role"
    if isinstance(space, Discrete):
        return "categorical"
    if isinstance(space, DCMLActionSpace):
        if space.mixed:
            return "mixed"
        if space.extra:
            return "gaussian"
        if space.multi_discrete:
            raise NotImplementedError(
                "DCMLActionSpace(multi_discrete=True) without mixed=True has no working "
                "reference semantics; use mixed=True")
        return "categorical"
    raise TypeError(f"unsupported action space: {space!r}")


def _masked_mean(x: torch.Tensor, active: Optional[torch.Tensor]) -> torch.Tensor:
    """``(x * active).sum() / active.sum()`` on each stack row (the
    reference's entropy weighting, ``act.py:171-176``), ``x (S, N, ...)``."""
    dims = tuple(range(1, x.dim()))
    if active is None:
        return x.mean(dims)
    while active.dim() < x.dim():
        active = active[..., None]
    while active.dim() > x.dim():
        active = active[..., 0]
    return (x * active).sum(dims) / active.sum(tuple(range(1, active.dim()))).clamp(min=1e-8)


class ACTLayer:
    """Samples and scores actions from actor features ``(S, N, d_in)``;
    ``prefix`` names its parameters (``actor/act``)."""

    def __init__(self, prefix: str, space, d_in: int, std_x_coef: float = 1.0,
                 std_y_coef: float = 0.5):
        self.prefix = prefix
        self.space = space
        self.kind = _kind(space)
        self.d_in = d_in
        self.std_x = std_x_coef
        self.std_y = std_y_coef

    def spec(self) -> List[ParamSpec]:
        sp, pre = self.space, self.prefix
        if self.kind == "categorical":
            return dense_spec(f"{pre}/action_head", self.d_in, sp.n, GAIN_ACT_HEAD)
        if self.kind == "gaussian":
            return dense_spec(f"{pre}/mean_head", self.d_in, sp.cont_dim, GAIN_ACT_HEAD) + [
                ParamSpec(f"{pre}/log_std", (sp.cont_dim,), "const", self.std_x)]
        if self.kind == "role":
            return (dense_spec(f"{pre}/action_head", self.d_in, sp.n, GAIN_ACT_HEAD)
                    + dense_spec(f"{pre}/mean_head", self.d_in, sp.cont_dim, GAIN_ACT_HEAD)
                    + [ParamSpec(f"{pre}/log_std", (sp.cont_dim,), "const", self.std_x)])
        return [ParamSpec(f"{pre}/log_std", (sp.cont_dim,), "const", 1.0)]

    def noise_shapes(self, S: int, N: int) -> Tuple[Optional[tuple], Optional[tuple]]:
        """``(gumbel, normal)`` shapes of one sample's noise (None: unread)."""
        sp = self.space
        if self.kind == "categorical":
            return (S, N, sp.n), None
        if self.kind == "gaussian":
            return None, (S, N, sp.cont_dim)
        if self.kind == "role":
            return (S, N, sp.n), (S, N, sp.cont_dim)
        return (S, N, sp.n_sub, sp.n), (S, N, sp.cont_dim)

    # ------------------------------------------------------------ parameters

    def _gauss_std(self, p) -> torch.Tensor:
        """``(S, 1, dim)``."""
        return (torch.sigmoid(p[f"{self.prefix}/log_std"] / self.std_x) * self.std_y)[:, None]

    def _mixed_std(self, p) -> torch.Tensor:
        return (torch.sigmoid(p[f"{self.prefix}/log_std"]) * 0.5)[:, None]

    def _role_split(self, avail, x):
        if avail is None:
            return torch.zeros(*x.shape[:-1], 1, device=x.device), None
        return avail[..., -1:], avail[..., :self.space.n]

    def _mixed_logits(self, x, avail):
        sp = self.space
        logits = x[..., :sp.n_sub * sp.n].reshape(*x.shape[:-1], sp.n_sub, sp.n)
        if avail is not None:
            logits = D.mask_logits(logits, avail[..., :sp.n_sub, :])
        return logits

    # ---------------------------------------------------------------- sample

    def sample(self, p, x, available_actions=None, deterministic: bool = False,
               noise: Optional[ACNoise] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(action (S, N, sample_dim) float, log_prob)``; ``noise`` is
        required unless ``deterministic``."""
        if not deterministic and noise is None:
            raise ValueError("stochastic sampling needs its noise")
        pre = self.prefix

        def draw_cat(logits):
            return (D.categorical_mode(logits) if deterministic
                    else D.categorical_sample_from_gumbel(logits, noise.gumbel))

        def draw_normal(mean, std):
            return mean if deterministic else D.normal_sample_from_noise(
                mean, std.expand_as(mean), noise.normal)

        if self.kind == "categorical":
            logits = D.mask_logits(dense(p, f"{pre}/action_head", x), available_actions)
            a = draw_cat(logits)
            return a[..., None].float(), D.categorical_log_prob(logits, a)[..., None]
        if self.kind == "gaussian":
            mean = dense(p, f"{pre}/mean_head", x)
            std = self._gauss_std(p)
            a = draw_normal(mean, std)
            return a, D.normal_log_prob(mean, std, a)
        if self.kind == "role":
            role, avail = self._role_split(available_actions, x)
            logits = D.mask_logits(dense(p, f"{pre}/action_head", x), avail)
            a_disc = draw_cat(logits)
            logp_disc = D.categorical_log_prob(logits, a_disc)[..., None]
            mean = dense(p, f"{pre}/mean_head", x)
            std = self._gauss_std(p)
            a_cont = draw_normal(mean, std)
            logp_cont = D.normal_log_prob(mean, std, a_cont).sum(-1, keepdim=True)
            master = role > 0.5
            return (torch.where(master, a_cont, a_disc[..., None].float()),
                    torch.where(master, logp_cont, logp_disc))
        sp = self.space
        logits = self._mixed_logits(x, available_actions)
        a_disc = draw_cat(logits)
        logp_disc = D.categorical_log_prob(logits, a_disc)              # (S, N, n_sub)
        mean = x[..., sp.n_sub * sp.n:]
        std = self._mixed_std(p)
        a_cont = draw_normal(mean, std)
        logp_cont = D.normal_log_prob(mean, std, a_cont)                # (S, N, cont)
        action = torch.cat([a_disc.float(), a_cont], -1)
        return action, torch.cat([logp_disc, logp_cont], -1).sum(-1, keepdim=True)

    # -------------------------------------------------------------- evaluate

    def evaluate(self, p, x, action, available_actions=None,
                 active_masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(log_prob, entropy (S,))`` of ``action`` (``act.py:144-226``)."""
        pre = self.prefix
        if self.kind == "categorical":
            logits = D.mask_logits(dense(p, f"{pre}/action_head", x), available_actions)
            logp = D.categorical_log_prob(logits, action[..., 0].long())[..., None]
            return logp, _masked_mean(D.categorical_entropy(logits), active_masks)
        if self.kind == "gaussian":
            mean = dense(p, f"{pre}/mean_head", x)
            std = self._gauss_std(p)
            ent = D.normal_entropy(mean, std).expand_as(mean)
            return D.normal_log_prob(mean, std, action), _masked_mean(ent, active_masks)
        if self.kind == "role":
            role, avail = self._role_split(available_actions, x)
            logits = D.mask_logits(dense(p, f"{pre}/action_head", x), avail)
            # a worker row's action is its index; the master row's float
            # ratio truncates (as JAX's int cast) and is clamped into range:
            # its categorical log-prob is discarded below
            idx = action[..., 0].long().clamp(0, self.space.n - 1)
            logp_disc = D.categorical_log_prob(logits, idx)[..., None]
            mean = dense(p, f"{pre}/mean_head", x)
            std = self._gauss_std(p)
            logp_cont = D.normal_log_prob(mean, std, action).sum(-1, keepdim=True)
            logp = torch.where(role > 0.5, logp_cont, logp_disc)
            ent_cont = D.normal_entropy(mean, std).expand_as(mean).sum(-1)
            ent_row = torch.where(role[..., 0] > 0.5, ent_cont, D.categorical_entropy(logits))
            return logp, _masked_mean(ent_row, active_masks)
        sp = self.space
        logits = self._mixed_logits(x, available_actions)
        logp_disc = D.categorical_log_prob(logits, action[..., :sp.n_sub].long())
        ent_disc = _masked_mean(D.categorical_entropy(logits).mean(-1), active_masks)
        mean = x[..., sp.n_sub * sp.n:]
        std = self._mixed_std(p)
        logp_cont = D.normal_log_prob(mean, std, action[..., sp.n_sub:])
        ent_cont = _masked_mean(D.normal_entropy(mean, std).expand_as(mean), active_masks)
        logp = torch.cat([logp_disc, logp_cont], -1).sum(-1, keepdim=True)
        return logp, ent_disc / 0.98 + ent_cont / 0.98
