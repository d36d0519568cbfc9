"""The DCML worker-selection environment, batched over E envs on one device.

Port of ``mat_dcml_tpu/envs/dcml/env.py::DCMLEnv`` with non-Shannon rates
and ``dynamic_price=False`` (the Shannon mode and dynamic prices change the
obs widths and are not ported: ROADMAP.md queue 1, item 5).  Three modes of
the JAX env's config are ported beside the training recipe:

- ``preset``: the benchmark protocol's deterministic replay.  Each reset
  takes R, C, the master's Pr, the workers' Prs and the disable rate from
  row ``episode_idx mod N`` of a fixture (:class:`~.preset.PresetData`,
  default ``data/dcml_benchmark/Sample_1``), where ``episode_idx`` is the
  cursor kept in the env state (``env.py:163-171``); the trace noise,
  arrival slot and availability order are still drawn;
- ``fixed``: the "select every available worker, K = floor(0.7 N)"
  baseline (``env.py:260``), which ignores the action;
- ``fixed_upload_retry``: one geometric upload-retry draw a worker instead
  of one per drained slot (``env.py:391``).  It reads its uniform from
  ``StepDraws.nb_u[..., 0]``.

The JAX env is a per-env function under ``vmap``; here every tensor carries a
leading E axis and one call steps all E envs.

Randomness is an input: ``reset`` takes a :class:`ResetDraws` and ``step`` a
:class:`StepDraws`, each holding exactly the values the JAX env draws from
its key chain (``env.py:147`` and ``:258``), so a test can replay JAX's draws
into the port.  ``DCMLEnv.draw_reset`` and ``DCMLEnv.draw_step`` make them
from a ``torch.Generator`` on the device.  As in the JAX env, ``step`` ends with an
auto-reset (``env.py:323``): the observation it returns is the next
episode's first.

The arithmetic is f32 in the JAX env's order of operations; integers that
come out of ``floor`` / ``ceil`` after a transcendental function (geometric
retry counts, drained slots) follow from the same f32 values.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from mat_dcml_tpu_torch.device import resolve_device
from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
from mat_dcml_tpu_torch.envs.dcml.preset import PresetData, load_sample

DATA_DIR = Path(__file__).resolve().parents[3] / "data"

# randint's exclusive upper ends of Master.reset (DCML_Master.py:46-56):
# round(R_MAX * 1.1) + 1 and round(C_MAX * 1.1) + 1 for the default consts
R_END = 1153435
C_END = 1127
DISABLE_RATE_END = 81   # random.randint(1, 80), inclusive
NB_DRAW_CAP = 64        # geometric draws summed per worker (env.py:552)
_TINY = float(np.finfo(np.float32).tiny)


class DCMLState(NamedTuple):
    """Per-env state the next ``step`` consumes; every field has a leading E."""

    r_rows: torch.Tensor        # (E,) f32, integral value
    c_cols: torch.Tensor        # (E,) f32
    master_pr: torch.Tensor     # (E,) f32
    worker_prs: torch.Tensor    # (E, W) f32
    trace: torch.Tensor         # (E, W, P) local workload in [0, 1]
    unavailable: torch.Tensor   # (E, W) bool
    arrive_time: torch.Tensor   # (E,) int64 in [0, P)
    disable_rate: torch.Tensor  # (E,) int64
    episode_idx: torch.Tensor   # (E,) int64, the preset replay cursor


class TimeStep(NamedTuple):
    obs: torch.Tensor                # (E, A, local_obs_dim)
    share_obs: torch.Tensor          # (E, A, sob_dim)
    available_actions: torch.Tensor  # (E, A, action_dim)
    reward: torch.Tensor             # (E, A, 1)
    done: torch.Tensor               # (E, A) bool
    delay: torch.Tensor              # (E,)
    payment: torch.Tensor            # (E,)
    # MO-MAT's objective vector (E, A, 2): (-delay * alpha, -payment * beta),
    # 1.5x on the standalone path as the reward; objectives.sum(-1) == reward
    objectives: torch.Tensor


class ResetDraws(NamedTuple):
    """The draws of one reset, per env (``env.py:147-180``)."""

    disable_rate: torch.Tensor   # (E,) int64, randint(1, 81)
    arrive_time: torch.Tensor    # (E,) int64, randint(0, P)
    r_rows: torch.Tensor         # (E,) int64, randint(r_min, R_END)
    c_cols: torch.Tensor         # (E,) int64, randint(c_min, C_END)
    master_pr: torch.Tensor      # (E,) f32, U(pr_min, pr_max)
    worker_prs: torch.Tensor     # (E, W) f32, U(pr_min, pr_max)
    trace_noise: torch.Tensor    # (E, W, P) f32, U(0.8, 1.2)
    avail_u: torch.Tensor        # (E, W) f32, U(0, 1): availability ranks


class StepDraws(NamedTuple):
    """The draws of one step, per env (``env.py:258``, ``:352``, ``:568``),
    then those of its auto-reset."""

    geom_u: torch.Tensor     # (E, W) U(tiny, 1): download retries
    nb_u: torch.Tensor       # (E, W, NB_DRAW_CAP) U(tiny, 1): upload retries
                             # (fixed_upload_retry reads [..., 0] only)
    nb_normal: torch.Tensor  # (E, W) N(0, 1): retries past the cap
    done_u: torch.Tensor     # (E,) U(0, 1)
    reset: ResetDraws


@dataclasses.dataclass(frozen=True)
class DCMLEnvConfig:
    consts: DCMLConsts = DCMLConsts()
    fixed: bool = False
    preset: bool = False
    fixed_upload_retry: bool = False
    max_drain_slots: float = 2**30
    shannon_enable: bool = False

    def __post_init__(self):
        if self.shannon_enable:
            raise NotImplementedError(
                "DCMLEnvConfig.shannon_enable changes the share_obs width and is not ported yet "
                "(ROADMAP.md queue 1, item 5)"
            )


def load_base_workloads(path: Path, consts: DCMLConsts) -> np.ndarray:
    """Read the stacked ``(P,)`` workload traces of the first
    ``worker_number_max`` workers (``DCML_..._SingleProcess.py:33-37``)."""
    traces = []
    with open(path, "rb") as reader:
        for _ in range(consts.worker_number_max):
            traces.append(np.load(reader, allow_pickle=False))
    return np.stack(traces).astype(np.float32)


def _uniform(shape, lo, hi, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp_min(u * (hi - lo) + lo, lo)


def _geom_inverse_cdf(u: torch.Tensor, p_fail: torch.Tensor) -> torch.Tensor:
    """Geometric failure count from a uniform: F = floor(log u / log p)."""
    safe_p = torch.clamp(p_fail, 1e-12, 1.0 - 1e-7)
    return torch.floor(torch.log(u) / torch.log(safe_p))


def _geometric_failures(u: torch.Tensor, p_fail: torch.Tensor) -> torch.Tensor:
    f = _geom_inverse_cdf(u, p_fail)
    return torch.where(p_fail <= 0.0, 0.0, f)


def _negative_binomial(u, z, n_draws, p_fail):
    """Sum of ``n_draws`` geometric failure counts: the masked sum of up to
    ``NB_DRAW_CAP`` draws ``u``, and a moment-matched normal ``z`` for the
    rest (``env.py:555-581``)."""
    f = _geom_inverse_cdf(u, p_fail[..., None])
    live = torch.arange(NB_DRAW_CAP, device=u.device) < torch.clamp(n_draws, max=NB_DRAW_CAP)[..., None]
    total = torch.where(live, f, 0.0).sum(-1)
    safe_p = torch.clamp(p_fail, 1e-12, 1.0 - 1e-7)
    rem = torch.clamp(n_draws - NB_DRAW_CAP, min=0.0)
    mean = safe_p / (1.0 - safe_p)
    var = safe_p / torch.square(1.0 - safe_p)
    tail = torch.clamp(torch.round(rem * mean + z * torch.sqrt(rem * var)), min=0.0)
    total = total + torch.where(rem > 0, tail, 0.0)
    return torch.where(p_fail <= 0.0, 0.0, total)


class DCMLEnv:
    """E DCML envs on ``device`` (default ``cuda``; raises when CUDA is
    absent).  ``reset`` and ``step`` are functions of the state, the action
    and the draws; nothing is kept between calls."""

    def __init__(self, config: DCMLEnvConfig = DCMLEnvConfig(),
                 base_workloads: Optional[np.ndarray] = None,
                 data_dir: str | Path = DATA_DIR, device=None,
                 preset: Optional[PresetData] = None):
        self.cfg = config
        c = config.consts
        if base_workloads is None:
            base_workloads = load_base_workloads(Path(data_dir) / "workloads.txt", c)
        if base_workloads.shape != (c.worker_number_max, c.local_workload_period):
            raise ValueError(f"base workloads {base_workloads.shape} do not fit the consts")
        self.device = resolve_device(device)
        self.base_workloads = torch.as_tensor(base_workloads, dtype=torch.float32,
                                              device=self.device)
        self.preset_master = self.preset_worker_prs = self.preset_disable_rates = None
        if config.preset:
            self.set_preset(preset if preset is not None
                            else load_sample(Path(data_dir) / "dcml_benchmark", 1))
        self.n_agents = c.n_agents
        self.obs_dim = c.local_obs_dim
        self.share_obs_dim = c.sob_dim
        self.action_dim = c.action_dim

    def set_preset(self, data: PresetData) -> None:
        """Replay ``data`` from now on (``preset`` mode): R, C and the
        master's Pr as f32, the workers' Prs as f32, the disable rates as
        integers, as the JAX env holds them."""
        if not self.cfg.preset:
            raise ValueError("set_preset needs DCMLEnvConfig(preset=True)")
        dev = self.device
        self.preset_master = torch.as_tensor(np.asarray(data.master, np.float32), device=dev)
        self.preset_worker_prs = torch.as_tensor(np.asarray(data.worker_prs, np.float32),
                                                 device=dev)
        self.preset_disable_rates = torch.as_tensor(np.asarray(data.disable_rates, np.int64),
                                                    device=dev)

    def draw_reset(self, n_envs: int, generator: Optional[torch.Generator] = None) -> ResetDraws:
        """A reset's draws for ``n_envs`` envs from ``generator``, on the env's device."""
        c = self.cfg.consts
        W, P, dev = c.worker_number_max, c.local_workload_period, self.device

        def randint(lo, hi):
            return torch.randint(lo, hi, (n_envs,), generator=generator, device=dev)

        return ResetDraws(
            disable_rate=randint(1, DISABLE_RATE_END),
            arrive_time=randint(0, P),
            r_rows=randint(c.r_min, R_END),
            c_cols=randint(c.c_min, C_END),
            master_pr=_uniform((n_envs,), c.pr_min, c.pr_max, generator, dev),
            worker_prs=_uniform((n_envs, W), c.pr_min, c.pr_max, generator, dev),
            trace_noise=_uniform((n_envs, W, P), 0.8, 1.2, generator, dev),
            avail_u=torch.rand((n_envs, W), generator=generator, device=dev),
        )

    def draw_step(self, n_envs: int, generator: Optional[torch.Generator] = None) -> StepDraws:
        """A step's draws, then its auto-reset's, for ``n_envs`` envs."""
        W, dev = self.cfg.consts.worker_number_max, self.device
        return StepDraws(
            geom_u=_uniform((n_envs, W), _TINY, 1.0, generator, dev),
            nb_u=_uniform((n_envs, W, NB_DRAW_CAP), _TINY, 1.0, generator, dev),
            nb_normal=torch.randn((n_envs, W), generator=generator, device=dev),
            done_u=torch.rand((n_envs,), generator=generator, device=dev),
            reset=self.draw_reset(n_envs, generator),
        )

    # ------------------------------------------------------------------ reset

    def reset(self, draws: ResetDraws, episode_idx: torch.Tensor | int = 0):
        """Fresh episodes; ``Env.reset`` (``DCML_..._SingleProcess.py:157-274``)."""
        c = self.cfg.consts
        E = draws.disable_rate.shape[0]
        dev = self.device
        episode_idx = torch.as_tensor(episode_idx, dtype=torch.int64, device=dev).expand(E)
        r_rows, c_cols, master_pr = draws.r_rows.float(), draws.c_cols.float(), draws.master_pr
        worker_prs, disable_rate = draws.worker_prs, draws.disable_rate
        if self.cfg.preset:
            # row episode_idx mod N of the fixture (env.py:163-171): wraps
            # past its end, as the JAX env does
            idx = torch.remainder(episode_idx, self.preset_master.shape[0])
            row = self.preset_master[idx]
            r_rows, c_cols, master_pr = row[:, 0], row[:, 1], row[:, 2]
            worker_prs = self.preset_worker_prs[idx]
            disable_rate = self.preset_disable_rates[idx]
        trace = torch.clamp(self.base_workloads * draws.trace_noise, 0.0, 1.0)
        # np.random.choice(W, disable_rate, replace=False): the first
        # disable_rate slots of a random permutation are unavailable
        perm_rank = torch.argsort(draws.avail_u, dim=-1, stable=True)
        unavailable = perm_rank < disable_rate[:, None]
        state = DCMLState(
            r_rows=r_rows,
            c_cols=c_cols,
            master_pr=master_pr,
            worker_prs=worker_prs,
            trace=trace,
            unavailable=unavailable,
            arrive_time=draws.arrive_time,
            disable_rate=disable_rate,
            episode_idx=episode_idx + 1,
        )
        obs, share_obs, ava = self._observe(state)
        A = c.n_agents
        ts = TimeStep(
            obs=obs, share_obs=share_obs, available_actions=ava,
            reward=torch.zeros(E, A, 1, device=dev),
            done=torch.zeros(E, A, dtype=torch.bool, device=dev),
            delay=torch.zeros(E, device=dev),
            payment=torch.zeros(E, device=dev),
            objectives=torch.zeros(E, A, 2, device=dev),
        )
        return state, ts

    # ------------------------------------------------------------------- step

    def step(self, state: DCMLState, action: torch.Tensor, draws: StepDraws):
        """One task round per env; ``Env.step`` (``DCML_..._SingleProcess.py:57-144``).

        ``action``: ``(E, A)`` or ``(E, A, 1)``: 100 select bits, then the
        coding ratio (the extra agent's continuous action).  The ``fixed``
        mode ignores it (it may be None): every available worker is
        selected and K = floor(0.7 N) (``env.py:260-264``).
        """
        c = self.cfg.consts
        W = c.worker_number_max
        E = state.r_rows.shape[0]
        if self.cfg.fixed:
            select = (~state.unavailable).float()
            n_raw = select.sum(-1)
            k_code = torch.floor(n_raw * 0.7)
        else:
            action = action.reshape(E, -1)
            select = action[:, :W]
            ratio = action[:, -1]
            n_raw = select.sum(-1)
            k_code = torch.ceil(n_raw * ratio)
        standalone = n_raw < 0.5
        # clamp N in [1, W], K in [1, N] (:96-103); no worker selected gives K = N = 1
        n_sel = torch.clamp(n_raw, 1.0, float(W))
        k_code = torch.minimum(torch.clamp(k_code, min=1.0), n_sel)

        r_wl = torch.ceil(state.r_rows / k_code)           # Master.get_workload (:39-40)
        c_wl = state.c_cols
        download = torch.full((E, W), c.non_shannon_data_rate, device=self.device)
        delays, p0, c20, cap_period, m_slots = self._process_workers(
            draws, r_wl, c_wl, state.worker_prs, state.trace, state.arrive_time, download)

        sel_mask = select > 0.5
        sorted_delays = torch.sort(torch.where(sel_mask, delays, torch.inf), dim=-1).values
        k_idx = k_code.long() - 1
        final_delay = sorted_delays.gather(1, k_idx[:, None])[:, 0]

        end_timeslot = torch.ceil(final_delay)
        final_costs = self._cost_at(p0, c20, cap_period, m_slots, end_timeslot)
        payment = torch.where(sel_mask, final_costs, 0.0).sum(-1)
        reward_main = -(final_delay * c.reward_alpha) - payment * c.reward_beta

        # standalone (:81-92): worker 0 alone, reward scaled 1.5x, its full
        # drained price
        cost0_full = p0[:, 0] + self._capacity(c20[:, 0], cap_period[:, 0], m_slots[:, 0])
        reward_alone = 1.5 * (-(delays[:, 0] * c.reward_alpha) - cost0_full * c.reward_beta)

        reward = torch.where(standalone, reward_alone, reward_main)
        delay_info = torch.where(standalone, delays[:, 0], final_delay)
        payment_info = torch.where(standalone, cost0_full, payment)
        # the objective channels (env.py:313-316); the standalone path keeps
        # its 1.5x scale
        obj_scale = torch.where(standalone, 1.5, 1.0)
        objectives = obj_scale[:, None] * torch.stack(
            [-delay_info * c.reward_alpha, -payment_info * c.reward_beta], dim=-1)
        done = draws.done_u < c.continue_probability   # (:141-142)

        new_state, reset_ts = self.reset(draws.reset, state.episode_idx)
        A = c.n_agents
        ts = reset_ts._replace(
            reward=reward[:, None, None].expand(E, A, 1).contiguous(),
            done=done[:, None].expand(E, A).contiguous(),
            delay=delay_info,
            payment=payment_info,
            objectives=objectives[:, None].expand(E, A, 2).contiguous(),
        )
        return new_state, ts

    # ---------------------------------------------------------------- workers

    def _process_workers(self, draws, r_wl, c_wl, prs, trace, arrive_time, download):
        """``Worker.process`` (``DCML_Worker...py:46-112``) for every worker
        of every env; returns ``(delay, p0, c20, cap_period, m_slots)``, each
        ``(E, W)`` but ``c20 (E, W, P)``."""
        c = self.cfg.consts
        P = trace.shape[-1]
        r_wl, c_wl = r_wl[:, None], c_wl[:, None]
        arrive_f = arrive_time[:, None].float()

        compute_workload = (9.0 * r_wl - 3.0) * c_wl
        cost0 = c.second_to_centsec * torch.ceil(compute_workload) / c.worker_frequency

        n_retry = 1.0 + _geometric_failures(draws.geom_u, prs)     # (:53-59)
        transmit_delay = (
            c.second_to_centsec
            * (torch.ceil((r_wl + 1.0) * c_wl) * 1.0 * c.bit_to_byte / download + 0.001)
            * n_retry
        )  # (:60)

        p0 = torch.floor(transmit_delay) * 0.1                      # (:65)
        arrive_ts = torch.floor(transmit_delay + arrive_f)          # (:66)
        ctp0 = torch.fmod(arrive_ts, P).long()                      # (:67-69)

        wl0 = trace.gather(2, ctp0[..., None])[..., 0]
        frac = transmit_delay - torch.floor(transmit_delay)
        cost = cost0 + torch.clamp(frac - wl0, min=0.0)             # (:85-86)

        # free capacity per slot from ctp0 on, one full period
        idx = torch.remainder(ctp0[..., None] + torch.arange(P, device=trace.device), P)
        c20 = torch.cumsum(1.0 - trace.gather(2, idx), dim=-1)
        cap_period = c20[..., -1]

        # smallest m >= 1 with cumulative capacity >= cost (:87-95); argmax
        # over an integer tensor gives the first true index
        cap_safe = torch.clamp(cap_period, min=1e-6)
        q_full = torch.clamp(torch.ceil(cost / cap_safe) - 1.0, min=0.0)
        rem = cost - q_full * cap_period
        t_part = 1 + torch.argmax((c20 >= rem[..., None] - 1e-9).to(torch.int32), dim=-1)
        m_slots = torch.clamp(q_full * P + t_part, max=self.cfg.max_drain_slots)
        drained = q_full * cap_period + c20.gather(2, (t_part - 1)[..., None])[..., 0]

        # upload retries: one geometric draw per drained timeslot (:99-106),
        # or one draw in all under fixed_upload_retry
        if self.cfg.fixed_upload_retry:
            extra_fails = _geometric_failures(draws.nb_u[..., 0], prs)
        else:
            extra_fails = _negative_binomial(draws.nb_u, draws.nb_normal, m_slots, prs)
        upload_delay = (
            c.second_to_centsec
            * (torch.ceil(r_wl) * 1.0 * c.bit_to_byte / download + 0.001)
            * (n_retry + extra_fails)
            + 0.02
        )  # (:106; divides by download, the reference's quirk)

        delay = (arrive_ts + m_slots) - arrive_f - (drained - cost) + upload_delay   # (:108)
        return delay, p0, c20, cap_period, m_slots

    def _capacity(self, c20, cap_period, j):
        """Cumulative free capacity over the first ``j`` drained slots;
        ``c20 (..., P)``, ``cap_period`` and ``j`` shaped as ``c20[..., 0]``."""
        P = c20.shape[-1]
        j = torch.clamp(j, 0, self.cfg.max_drain_slots)
        q2 = torch.floor(j / P)
        r2 = (j - q2 * P).long()
        partial = torch.where(r2 > 0, c20.gather(-1, torch.clamp(r2 - 1, min=0)[..., None])[..., 0], 0.0)
        return q2 * cap_period + partial

    def _cost_at(self, p0, c20, cap_period, m_slots, end_timeslot):
        """Per-worker accumulated price at ``end_timeslot`` (``(E,)``)
        (``DCML_..._SingleProcess.py:131-137``)."""
        j = torch.minimum(torch.clamp(end_timeslot, min=1.0)[:, None], m_slots)
        return p0 + self._capacity(c20, cap_period, j)

    # ------------------------------------------------------------------- obs

    def _observe(self, state: DCMLState):
        """``(obs, share_obs, available_actions)``; ``DCML_..._SingleProcess.py:162-274``
        (OBSERVER_WORKLOAD branch, HETEROGENEOUS, DYNAMIC_PRICE=False)."""
        c = self.cfg.consts
        W, P = c.worker_number_max, c.local_workload_period
        E = state.r_rows.shape[0]
        dev = self.device
        avail = ~state.unavailable

        r_norm = (state.r_rows - c.r_min) / (c.r_max - c.r_min)
        c_norm = (state.c_cols - c.c_min) / (c.c_max - c.c_min)

        slots = torch.remainder(state.arrive_time[:, None] + torch.arange(3, device=dev), P)
        wl3 = state.trace.gather(2, slots[:, None, :].expand(E, W, 3))      # (E, W, 3)

        n_avail = (W - state.disable_rate).float()
        unavail_f = state.unavailable.float()
        disabled_before = torch.cumsum(unavail_f, dim=-1) - unavail_f
        rank = (torch.arange(W, dtype=torch.float32, device=dev) - disabled_before) / n_avail[:, None]

        # feature 7 of a disabled worker: the rank of the last available
        # worker before it (the obs[-7] back-reference at :210-213), else 0
        iw = torch.arange(W, device=dev)
        last_avail = torch.cummax(torch.where(avail, iw, -1), dim=-1).values
        feat7 = torch.where(last_avail >= 0, rank.gather(1, torch.clamp(last_avail, min=0)), 0.0)

        head = torch.stack([r_norm * c.state_ratio, c_norm * c.state_ratio], dim=-1)   # (E, 2)
        head_w = head[:, None, :].expand(E, W, 2)
        worker_obs_avail = torch.cat(
            [head_w, wl3, state.worker_prs[..., None], rank[..., None]], dim=-1)
        worker_obs_unavail = torch.cat(
            [head_w, torch.ones(E, W, 4, device=dev), feat7[..., None]], dim=-1)
        worker_obs = torch.where(avail[..., None], worker_obs_avail, worker_obs_unavail)

        # master (extra) agent (:235-241): availability-masked means
        af = avail.float()
        denom = torch.clamp(af.sum(-1), min=1.0)
        mean_wl3 = (wl3 * af[..., None]).sum(1) / denom[:, None]
        mean_pr = (state.worker_prs * af).sum(-1) / denom
        master_obs = torch.cat(
            [head, mean_wl3, mean_pr[:, None], torch.full((E, 1), 1.1, device=dev)], dim=-1)
        obs = torch.cat([worker_obs, master_obs[:, None]], dim=1)

        share_row = torch.cat([head, state.worker_prs], dim=-1)        # (:181-182,252-253)
        share_obs = share_row[:, None, :].expand(E, c.n_agents, self.share_obs_dim).contiguous()

        # availability (:266-268): [1,1] available / [1,0] disabled; master [1,1]
        ava_workers = torch.stack([torch.ones(E, W, device=dev), af], dim=-1)
        ava = torch.cat([ava_workers, torch.ones(E, 1, 2, device=dev)], dim=1)
        return obs, share_obs, ava
