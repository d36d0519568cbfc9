"""The DCML dimensions the port's serving shapes need.

A copy of the fields of ``mat_dcml_tpu/envs/dcml/constants.py::DCMLConsts``
that fix the policy's shapes: 100 workers plus one extra (coding-ratio)
agent, each worker seeing 7 local features, a 102-wide shared state, and a
2-wide action.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DCMLConsts:
    worker_number_max: int = 100
    extra_agent: int = 1
    action_dim: int = 2
    local_obs_dim: int = 7
    sob_dim: int = 102

    @property
    def n_agents(self) -> int:
        return self.worker_number_max + self.extra_agent
