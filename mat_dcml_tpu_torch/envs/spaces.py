"""Action space descriptors.

Port of the ``Box`` of ``mat_dcml_tpu/envs/spaces.py``: a continuous space,
which an env declares as ``env.action_space`` so that the runner builds a
continuous-action policy (``training/mujoco_runner.py::build_policy``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Box:
    """Continuous space of ``dim`` flat dims (gym.spaces.Box)."""

    dim: int
