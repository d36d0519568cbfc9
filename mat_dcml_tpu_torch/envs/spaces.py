"""Action space descriptors.

Port of ``mat_dcml_tpu/envs/spaces.py`` (``:24-150``) for the spaces the
port's policies read: ``Box``, which an env declares as ``env.action_space``
so that the runner builds a continuous-action MAT
(``training/mujoco_runner.py::build_policy``), and the three spaces of the
actor-critic family on DCML (``models/act_layer.py``):

- ``Discrete``: a categorical space with ``n`` choices;
- ``DCMLActionSpace``: the reference's duck-typed ``Action_Space``
  (``DCML_ActionSpace.py``): ``mixed`` is the centralised PPO's joint
  action, ``n_sub`` categorical heads of ``n`` choices sliced from one wide
  feature vector plus ``-semi_index`` Gaussian tail dims; ``extra`` the
  master's single Gaussian dim; neither a plain categorical (a worker);
- ``MixedRole``: one space for every DCML agent of a separated-policy
  algorithm (HAPPO, MAPPO, IPPO): both heads in one module, selected per
  row by a role flag that rides as the last column of ``available_actions``
  (1.0 for the continuous master); actions are ``(B, 1)`` floats.

``MultiDiscrete`` and ``MultiBinary`` wait for MPE (ROADMAP.md queue 1,
item 10).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Discrete:
    """Categorical space with ``n`` choices (gym.spaces.Discrete)."""

    n: int

    @property
    def sample_dim(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class Box:
    """Continuous space of ``dim`` flat dims (gym.spaces.Box)."""

    dim: int

    @property
    def sample_dim(self) -> int:
        return self.dim


@dataclasses.dataclass(frozen=True)
class DCMLActionSpace:
    """The reference's ``Action_Space`` (``DCML_ActionSpace.py``; module
    docstring).  ``multi_discrete`` without ``mixed`` has no working
    reference semantics and is refused by the action head."""

    n: int = 2
    n_sub: int = 100              # high - low in the reference
    semi_index: int = -1          # negated count of Gaussian tail dims
    mixed: bool = False
    extra: bool = False
    continuous: bool = False
    multi_discrete: bool = False

    @property
    def cont_dim(self) -> int:
        return -self.semi_index

    @property
    def mixed_feature_dim(self) -> int:
        """Width of the actor feature vector the mixed head slices
        (``mlp.py:51-56``): every sub-action's logits, then the tail means."""
        return self.n_sub * self.n + self.cont_dim

    @property
    def sample_dim(self) -> int:
        if self.mixed:
            return self.n_sub + self.cont_dim
        if self.extra:
            return self.cont_dim
        return 1


@dataclasses.dataclass(frozen=True)
class MixedRole:
    """Per-agent space of the separated-policy algorithms on DCML (module
    docstring): ``n`` categorical choices for a worker, ``cont_dim``
    Gaussian dims for the master; ``available_actions`` is ``n + 1`` wide,
    the role last."""

    n: int = 2
    cont_dim: int = 1

    @property
    def sample_dim(self) -> int:
        return max(1, self.cont_dim)


def space_sample_dim(space) -> int:
    """Width of a stored action sample for ``space``."""
    return space.sample_dim
