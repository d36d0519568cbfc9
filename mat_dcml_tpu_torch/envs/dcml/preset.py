"""Preset (deterministic-eval) fixture tooling for the DCML env.

Port of ``mat_dcml_tpu/envs/dcml/preset.py``, plain numpy, copied so that the
port imports nothing of the JAX package.  The reference's closest thing to a
test harness (SURVEY.md §4): the env can snapshot its stochastic inputs to
``.npy`` fixtures and replay them, and ``modify_preset`` pins single factors
for controlled sweeps (``DCML_BID_FIRST_MA_ENV_SingleProcess.py:316-353``).
File format matches the shipped ``data/dcml_benchmark/Sample_*`` fixtures
exactly:

- ``<prefix>master_states.npy``: one save, ``(N, 3)`` float = (R, C, Pr)
- ``<prefix>worker_states.npy``: two stacked saves — worker failure probs
  ``(N, W)`` then disable rates ``(N,)``
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts


@dataclasses.dataclass
class PresetData:
    """In-memory preset fixture: the three arrays ``DCMLEnv`` replays."""

    master: np.ndarray          # (N, 3) = (R, C, Pr)
    worker_prs: np.ndarray      # (N, W)
    disable_rates: np.ndarray   # (N,)

    @property
    def n_episodes(self) -> int:
        return self.master.shape[0]


def generate_preset_data(
    rng: np.random.Generator,
    n_episodes: int,
    consts: DCMLConsts = DCMLConsts(),
    *,
    row: Optional[float] = None,
    col: Optional[float] = None,
    probability: Optional[float] = None,
    disable_rate: Optional[int] = None,
) -> PresetData:
    """Draw ``n_episodes`` of env randomness, optionally pinning factors
    (``generate_preset_data``, ``DCML_..._SingleProcess.py:316-343``).

    Distributions match ``Master.reset`` (R ~ randint[R_MIN, round(1.1*R_MAX)],
    C likewise, Pr ~ U[PR_MIN, PR_MAX]) and ``random.randint(1, 80)`` for the
    disable rate.
    """
    c = consts
    r = rng.integers(c.r_min, round(c.r_max * 1.1) + 1, n_episodes).astype(np.float64)
    cc = rng.integers(c.c_min, round(c.c_max * 1.1) + 1, n_episodes).astype(np.float64)
    pr = rng.uniform(c.pr_min, c.pr_max, n_episodes)
    if row is not None:
        r[:] = row
    if col is not None:
        cc[:] = col
    if probability is not None:
        pr[:] = probability
    if disable_rate is None:
        drs = rng.integers(1, 81, n_episodes)
    else:
        drs = np.full(n_episodes, disable_rate, np.int64)
    worker_prs = rng.uniform(c.pr_min, c.pr_max, (n_episodes, c.worker_number_max))
    return PresetData(
        master=np.stack([r, cc, pr], axis=1),
        worker_prs=worker_prs,
        disable_rates=drs,
    )


def modify_preset(
    data: PresetData,
    *,
    r: Optional[float] = None,
    c: Optional[float] = None,
    pr: Optional[float] = None,
    disable_rate: Optional[int] = None,
) -> PresetData:
    """Pin single factors across all episodes for a controlled sweep
    (``modify_preset``, ``DCML_..._SingleProcess.py:344-353``).  Returns a new
    ``PresetData``; the input is not mutated."""
    master = data.master.copy()
    worker_prs = data.worker_prs.copy()
    drs = data.disable_rates.copy()
    if r is not None:
        master[:, 0] = r
    if c is not None:
        master[:, 1] = c
    if pr is not None:
        worker_prs[:] = pr
    if disable_rate is not None:
        drs[:] = disable_rate
    return PresetData(master, worker_prs, drs)


def save_preset(data: PresetData, dir_name: str | Path, prefix: str = "") -> None:
    """Write the two-file fixture format the reference ships."""
    d = Path(dir_name)
    d.mkdir(parents=True, exist_ok=True)
    with open(d / f"{prefix}master_states.npy", "wb") as f:
        np.save(f, data.master)
    with open(d / f"{prefix}worker_states.npy", "wb") as f:
        np.save(f, data.worker_prs)
        np.save(f, data.disable_rates)


def load_preset_data(dir_name: str | Path, prefix: str = "") -> PresetData:
    d = Path(dir_name)
    with open(d / f"{prefix}master_states.npy", "rb") as f:
        master = np.load(f, allow_pickle=False)
    with open(d / f"{prefix}worker_states.npy", "rb") as f:
        worker_prs = np.load(f, allow_pickle=False)
        disable_rates = np.load(f, allow_pickle=False)
    return PresetData(np.asarray(master, np.float64), worker_prs, disable_rates)


def load_sample(bench_dir: str | Path, sample: int = 1) -> PresetData:
    """Load one of the 10 shipped ``Sample_<k>`` fixtures (1001 episodes)."""
    return load_preset_data(bench_dir, prefix=f"Sample_{sample}")
