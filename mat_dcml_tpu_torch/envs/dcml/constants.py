"""DCML environment constants.

A copy of the fields of ``mat_dcml_tpu/envs/dcml/constants.py::DCMLConsts``
that the port's policy shapes and its env (``envs/dcml/env.py``: the
non-Shannon, ``DYNAMIC_PRICE = False`` recipe) read: 100 workers plus one
extra (coding-ratio) agent, each worker seeing 7 local features, a 102-wide
shared state, and a 2-wide action.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DCMLConsts:
    # DCML_Config.py
    worker_number_max: int = 100
    extra_agent: int = 1
    action_dim: int = 2
    local_obs_dim: int = 7
    sob_dim: int = 102
    local_workload_period: int = 20
    state_ratio: float = 1.0
    pr_min: float = 0.0
    pr_max: float = 0.95
    continue_probability: float = 0.8
    non_shannon_data_rate: float = 150.0 * (2**10) * (2**10)

    # DCML_Master.py
    r_min: int = 2**10
    r_max: int = 2**20
    c_min: int = 2**5
    c_max: int = 2**10

    # DCML_Worker_TIMESLOT_MultiProcess.py
    worker_frequency: float = 2e9
    bit_to_byte: float = 4.0
    second_to_centsec: float = 1.0

    # DCML_ENV_Functions.py
    reward_alpha: float = 99.0
    reward_beta: float = 1.0

    @property
    def n_agents(self) -> int:
        return self.worker_number_max + self.extra_agent
