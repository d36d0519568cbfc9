"""Action decode for MAT: the serving entry, the cached decode, and the
teacher-forced evaluation of the PPO update.

Port of ``mat_dcml_tpu/models/decode.py`` for ``mode="cached"`` (the serving
and rollout default) and ``parallel_act``.  The JAX ``lax.scan`` over agents becomes a Python loop
over positions; the packed K/V cache is written in place.  Sampling noise is
an input (Gumbel for categorical draws, standard normals for the Gaussian
tail), drawn from the caller's ``torch.Generator`` when not given, so a test
can replay the JAX key chain exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mat_dcml_tpu_torch.device import resolve_device
from mat_dcml_tpu_torch.models.mat import (
    AVAILABLE_CONTINUOUS,
    CONTINUOUS,
    DISCRETE,
    SEMI_DISCRETE,
    MultiAgentTransformer,
)
from mat_dcml_tpu_torch.ops import distributions as D


class DecodeResult(NamedTuple):
    action: torch.Tensor      # (B, n_agent, act_out) float32
    log_prob: torch.Tensor    # (B, n_agent, act_prob) float32


DECODE_MODES = ("scan", "stride", "spec", "cached")


def serve_decode(
    model: MultiAgentTransformer,
    state,
    obs,
    available_actions=None,
    deterministic: bool = True,
    mode: str = "cached",
    *,
    device=None,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
    tail_noise: Optional[torch.Tensor] = None,
):
    """The full encode + decode forward that serving runs.

    ``state (B, A, state_dim)``, ``obs (B, A, obs_dim)`` and
    ``available_actions (B, A, action_dim)`` may be arrays or tensors; they
    are moved to ``device`` (default ``cuda``), where ``model`` must live.
    Only ``mode="cached"`` is ported.  Returns ``(values, DecodeResult)``.
    """
    if mode not in DECODE_MODES:
        raise ValueError(f"mode must be one of {DECODE_MODES}, got {mode!r}")
    if mode != "cached":
        raise NotImplementedError(
            f"decode mode {mode!r} is not ported yet (ROADMAP.md queue 1, item 4); "
            "use mode='cached'"
        )
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, not on {dev}")

    def put(x):
        return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=dev)

    with torch.inference_mode():
        v_loc, obs_rep = model.encode(put(state), put(obs))
        res = cached_decode(
            model, obs_rep, put(available_actions), deterministic,
            generator=generator, gumbel=gumbel, tail_noise=tail_noise,
        )
    return v_loc, res


def _discrete_branch(logits, ava_i, gumbel_i, deterministic, adim, in_dim):
    masked = D.mask_logits(logits, ava_i)
    if deterministic:
        idx = D.categorical_mode(masked)
    else:
        idx = D.categorical_sample_from_gumbel(masked, gumbel_i)
    logp = D.categorical_log_prob(masked, idx)
    nxt = torch.zeros(logits.shape[0], 1, in_dim, device=logits.device)
    # one-hot by scatter: F.one_hot checks its range on the host, a sync per step
    nxt[:, 0, 1:].scatter_(-1, idx[:, None], 1.0)
    return idx[:, None].float(), logp[:, None], nxt


def _sample_position(cfg, logits, ava_i, i, gumbel_i, noise_i, std, deterministic):
    """Sampling at position ``i`` from its ``(B, adim)`` logits; returns
    ``(act, logp, nxt)`` with ``nxt`` the next step's shifted-action feed
    ``(B, 1, action_input_dim)``."""
    adim, in_dim = cfg.action_dim, cfg.action_input_dim
    if cfg.action_type == DISCRETE:
        return _discrete_branch(logits, ava_i, gumbel_i, deterministic, adim, in_dim)
    if cfg.action_type == SEMI_DISCRETE:
        d_act, d_logp, nxt = _discrete_branch(logits, ava_i, gumbel_i, deterministic, adim, in_dim)
        if i < cfg.n_discrete_agents:
            return d_act, d_logp, nxt
        c_act = logits if deterministic else D.normal_sample_from_noise(logits, std, noise_i)
        c_logp = D.normal_log_prob(logits, std, c_act)
        # the continuous agents come last: their feed is the discrete branch's
        return c_act[:, -1:], c_logp[:, -1:], nxt
    raise NotImplementedError(
        f"sampling for action_type {cfg.action_type!r} is not ported yet "
        "(ROADMAP.md queue 1, item 4)"
    )


def cached_decode(
    model: MultiAgentTransformer,
    obs_rep: torch.Tensor,
    available_actions: Optional[torch.Tensor],
    deterministic: bool = False,
    *,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
    tail_noise: Optional[torch.Tensor] = None,
) -> DecodeResult:
    """Autoregressive decode with O(1) new work per position.

    K/V live pre-split in two stacked ``(2 * n_block, B, H, A, Dh)`` buffers
    (plane ``2b`` is block b's self-attention, ``2b + 1`` its
    cross-attention); each position writes one column per plane and attends
    under a ``position <= i`` mask.  Cross-attention queries for all A
    positions are projected once, before the loop.

    Noise for a stochastic decode: ``gumbel (B, A, adim)`` and, for the
    semi-discrete Gaussian tail, ``tail_noise (A, B, adim)`` (rows below
    ``n_discrete_agents`` unused).  Whichever is not given is drawn from
    ``generator``.  A deterministic decode takes modes and reads no noise.
    """
    cfg = model.cfg
    if cfg.action_type in (CONTINUOUS, AVAILABLE_CONTINUOUS):
        raise NotImplementedError(
            f"cached decode for action_type {cfg.action_type!r} is not ported yet "
            "(ROADMAP.md queue 1, item 4)"
        )
    dev = obs_rep.device
    B = obs_rep.shape[0]
    A, adim = cfg.n_agent, cfg.action_dim
    if available_actions is None:
        available_actions = torch.ones(B, A, adim, device=dev)
    std = model.action_std() if cfg.action_type != DISCRETE else None

    if not deterministic:
        if gumbel is None:
            gumbel = D.gumbel_noise((B, A, adim), generator, dev)
        if tail_noise is None and cfg.action_type == SEMI_DISCRETE:
            tail_noise = torch.randn((A, B, adim), generator=generator, device=dev)
        gumbel = gumbel.to(dev)
        if tail_noise is not None:
            tail_noise = tail_noise.to(dev)

    shifted = torch.zeros(B, 1, cfg.action_input_dim, device=dev)
    shifted[:, 0, 0] = 1.0   # start token
    kv = model.fresh_packed_cache(B)
    q2 = model.decode_queries(obs_rep)                       # (n_block, B, H, A, Dh)
    valid = torch.ones(A, A, dtype=torch.bool, device=dev).tril()   # row i: keys <= i

    acts, logps = [], []
    for i in range(A):
        logits = model.decode_step_cached(
            shifted, obs_rep[:, i:i + 1], q2[:, :, :, i:i + 1], kv, i, valid[i]
        )
        act, logp, shifted = _sample_position(
            cfg, logits[:, 0], available_actions[:, i], i,
            None if deterministic else gumbel[:, i],
            None if deterministic or tail_noise is None else tail_noise[i],
            std, deterministic,
        )
        acts.append(act)
        logps.append(logp)
    return DecodeResult(torch.stack(acts, dim=1), torch.stack(logps, dim=1))


# ---------------------------------------------------------------------------
# Teacher-forced parallel evaluation
# ---------------------------------------------------------------------------

def parallel_act(
    model: MultiAgentTransformer,
    obs_rep: torch.Tensor,
    action: torch.Tensor,
    available_actions: Optional[torch.Tensor],
):
    """Teacher-forced log-probs and entropies in one decoder pass
    (``mat_dcml_tpu/models/decode.py::parallel_act``; ``transformer_act.py``
    ``discrete_parallel_act`` and ``semi_discrete_parallel_act``).

    ``obs_rep (B, A, D)``, ``action (B, A, 1)``.  Returns ``(log_prob,
    entropy)``, each ``(B, A, 1)``.
    """
    cfg = model.cfg
    B, A, adim = obs_rep.shape[0], cfg.n_agent, cfg.action_dim
    if cfg.action_type == DISCRETE:
        idx = action[..., 0].long()
        onehot = torch.nn.functional.one_hot(idx, adim).float()
        logits = model.decoder(_shift_with_start(onehot, B, A, adim), obs_rep)
        logits = D.mask_logits(logits, available_actions)
        return (D.categorical_log_prob(logits, idx)[..., None],
                D.categorical_entropy(logits)[..., None])
    if cfg.action_type != SEMI_DISCRETE:
        raise NotImplementedError(
            f"parallel_act for action_type {cfg.action_type!r} is not ported yet "
            "(ROADMAP.md queue 1, item 4)"
        )
    nd = cfg.n_discrete_agents
    idx = action[:, :nd, 0].long()
    onehot = torch.nn.functional.one_hot(idx, adim).float()
    cont = action[:, nd:, :].expand(B, A - nd, adim)
    shifted = _shift_with_start(torch.cat([onehot, cont], dim=1), B, A, adim)
    logits = model.decoder(shifted, obs_rep)
    d_logits = logits[:, :nd]
    if available_actions is not None:
        d_logits = D.mask_logits(d_logits, available_actions[:, :nd])
    d_logp = D.categorical_log_prob(d_logits, idx)[..., None]
    d_ent = D.categorical_entropy(d_logits)[..., None]
    std = model.action_std()
    c_mean = logits[:, nd:]
    c_logp = D.normal_log_prob(c_mean, std, action[:, nd:, :].expand_as(c_mean))
    c_ent = D.normal_entropy(c_mean, std).expand_as(c_mean)
    return (torch.cat([d_logp, c_logp[:, :, -1:]], dim=1),
            torch.cat([d_ent, c_ent[:, :, -1:]], dim=1))


def _shift_with_start(action_all: torch.Tensor, B: int, A: int, adim: int) -> torch.Tensor:
    """Start token, then the actions shifted right by one agent
    (``transformer_act.py:108-110``)."""
    shifted = torch.zeros(B, A, adim + 1, device=action_all.device)
    shifted[:, 0, 0] = 1.0
    shifted[:, 1:, 1:] = action_all[:, :-1, :]
    return shifted
