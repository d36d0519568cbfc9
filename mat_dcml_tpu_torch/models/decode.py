"""Action decode for MAT: the serving entry, the exact decodes, the stride
decode and the teacher-forced evaluation of the PPO update.

Port of ``mat_dcml_tpu/models/decode.py`` for ``mode="cached"`` (the serving
and rollout default), ``mode="scan"`` (:func:`ar_decode`, the whole decode in
one launch of ``csrc/ar_decode.cu`` on the card), ``mode="stride"`` and
``parallel_act``.  In the cached decode the JAX ``lax.scan`` over agents
becomes a Python loop over positions; the packed K/V cache is written in
place.  Sampling noise is an input (Gumbel for categorical draws, standard
normals for the Gaussian tail), drawn from the caller's ``torch.Generator``
when not given, so a test can replay the JAX key chain exactly.
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
from mat_dcml_tpu_torch.ops.ar_decode import fused_ar_decode, pack_ar_decode_weights


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
    stride: int = 2,
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

    ``mode``: ``"cached"`` = :func:`cached_decode`; ``"scan"`` =
    :func:`ar_decode`, the same exact decode in one kernel launch on the
    card; ``"stride"`` = :func:`stride_decode`, the reference's block-commit
    approximation, deterministic only (``deterministic=False`` raises).
    ``"spec"`` is not ported yet.  Both exact modes read the same noise.
    Returns ``(values, DecodeResult)``.
    """
    if mode not in DECODE_MODES:
        raise ValueError(f"mode must be one of {DECODE_MODES}, got {mode!r}")
    if mode == "stride" and not deterministic:
        raise ValueError(
            "decode mode 'stride' is deterministic-only (the reference's "
            "block-commit approximation has no stochastic sampling path); "
            "use mode='scan' or mode='cached' for stochastic decode"
        )
    if mode == "spec":
        raise NotImplementedError(
            "decode mode 'spec' is not ported yet (ROADMAP.md queue 1, item 11); "
            "use mode='cached' or mode='scan'"
        )
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, not on {dev}")

    def put(x):
        return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=dev)

    with torch.inference_mode():
        v_loc, obs_rep = model.encode(put(state), put(obs))
        avail = put(available_actions)
        if mode == "stride":
            res = stride_decode(model, obs_rep, avail, stride=stride)
        else:
            decode = cached_decode if mode == "cached" else ar_decode
            res = decode(model, obs_rep, avail, deterministic,
                         generator=generator, gumbel=gumbel, tail_noise=tail_noise)
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
        gumbel, tail_noise = _draw_noise(cfg, B, dev, generator, gumbel, tail_noise)

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


def _draw_noise(cfg, B, dev, generator, gumbel, tail_noise):
    """``(gumbel (B, A, adim), tail_noise (A, B, adim) or None)`` on ``dev``:
    the given noise, or draws from ``generator``, Gumbel first."""
    A, adim = cfg.n_agent, cfg.action_dim
    if gumbel is None:
        gumbel = D.gumbel_noise((B, A, adim), generator, dev)
    if tail_noise is None and cfg.action_type == SEMI_DISCRETE:
        tail_noise = torch.randn((A, B, adim), generator=generator, device=dev)
    return gumbel.to(dev), None if tail_noise is None else tail_noise.to(dev)


# ---------------------------------------------------------------------------
# Exact decode in one launch (mode="scan")
# ---------------------------------------------------------------------------

def ar_decode(
    model: MultiAgentTransformer,
    obs_rep: torch.Tensor,
    available_actions: Optional[torch.Tensor],
    deterministic: bool = False,
    *,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
    tail_noise: Optional[torch.Tensor] = None,
) -> DecodeResult:
    """Exact autoregressive decode over the agent axis (JAX ``ar_decode``,
    ``mode="scan"``): the same decode as :func:`cached_decode`, run whole by
    :func:`_fused_ar_decode_path`.  It reads the same noise as
    :func:`cached_decode` (given, or drawn from ``generator`` in the same
    order).  The JAX signature's ``obs`` is left out, as in
    ``Decoder.forward``: only MAT-Dec's decoder reads it (``dec_actor``, not
    ported: ROADMAP.md queue 1, item 3)."""
    cfg = model.cfg
    if cfg.action_type not in (DISCRETE, SEMI_DISCRETE):
        raise NotImplementedError(
            f"ar_decode for action_type {cfg.action_type!r} is not ported yet: it needs "
            "fused_decode_step and continuous sampling (ROADMAP.md queue 2, item 2; "
            "queue 1, item 4)"
        )
    return _fused_ar_decode_path(model, obs_rep, available_actions, deterministic,
                                 generator=generator, gumbel=gumbel, tail_noise=tail_noise)


def _fused_ar_decode_path(model, obs_rep, available_actions, deterministic, *,
                          generator, gumbel, tail_noise) -> DecodeResult:
    """The whole decode through ``ops/ar_decode.fused_ar_decode``: the kernel
    on the card, its plain twin on the CPU.  Sampling noise becomes the
    kernel's inputs: the Gumbel tensor, and the tail noise of agents ``>=
    nd`` as ``(B, A - nd, adim)`` normal rows; a deterministic decode passes
    zeros (argmax of the masked logits, the tail's mean), as the JAX path
    does."""
    cfg = model.cfg
    dev = obs_rep.device
    B, A, adim = obs_rep.shape[0], cfg.n_agent, cfg.action_dim
    nd = cfg.n_discrete_agents if cfg.action_type == SEMI_DISCRETE else A
    n_rows = max(1, A - nd)
    normal = torch.zeros(B, n_rows, adim, device=dev)
    if deterministic:
        gumbel = torch.zeros(B, A, adim, device=dev)
    else:
        gumbel, tail_noise = _draw_noise(cfg, B, dev, generator, gumbel, tail_noise)
        if A > nd:
            normal = tail_noise[nd:].transpose(0, 1).contiguous()
    avail = None if available_actions is None else available_actions.float().contiguous()
    act, logp = fused_ar_decode(
        pack_ar_decode_weights(model), obs_rep.contiguous(), gumbel.contiguous(), normal, avail,
        n_head=cfg.n_head, adim=adim, nd=nd,
    )
    return DecodeResult(act[..., None], logp[..., None])


# ---------------------------------------------------------------------------
# Stride-batched deterministic decode (benchmark-protocol parity)
# ---------------------------------------------------------------------------

def stride_decode(
    model: MultiAgentTransformer,
    obs_rep: torch.Tensor,
    available_actions: Optional[torch.Tensor],
    stride: int = 2,
) -> DecodeResult:
    """The reference's deterministic block-commit decode
    (``transformer_act.py:37-75``; JAX ``stride_decode``): decode agent 0
    alone, then commit blocks of ``stride`` discrete agents per full decoder
    pass (agents inside a block do not see each other's actions), then the
    continuous tail one at a time.  Every pass is the teacher-forced decoder,
    whose attentions go through the attention kernel on the card."""
    cfg = model.cfg
    if cfg.action_type not in (DISCRETE, SEMI_DISCRETE):
        raise NotImplementedError(
            f"stride decode is discrete-family only, not {cfg.action_type!r}"
        )
    dev = obs_rep.device
    B, A, adim = obs_rep.shape[0], cfg.n_agent, cfg.action_dim
    nd = cfg.n_discrete_agents if cfg.action_type == SEMI_DISCRETE else A
    std = model.action_std() if cfg.action_type == SEMI_DISCRETE else None
    if available_actions is None:
        available_actions = torch.ones(B, A, adim, device=dev)

    shifted = torch.zeros(B, A, adim + 1, device=dev)
    shifted[:, 0, 0] = 1.0
    action = torch.zeros(B, A, 1, device=dev)
    log_prob = torch.zeros(B, A, 1, device=dev)
    # block boundaries: [0, 1), [1, 1 + stride), ... then the tail one by one
    bounds = [(0, 1)]
    s = 1
    while s < nd:
        bounds.append((s, min(s + stride, nd)))
        s = bounds[-1][1]
    bounds += [(t, t + 1) for t in range(s, A)]

    for s, e in bounds:
        logits = model.decoder(shifted, obs_rep)[:, s:e]
        if e <= nd:
            masked = D.mask_logits(logits, available_actions[:, s:e])
            idx = torch.argmax(masked, dim=-1)                          # (B, e - s)
            action[:, s:e, 0] = idx.float()
            log_prob[:, s:e, 0] = D.categorical_log_prob(masked, idx)
            upto = min(e + 1, A)
            onehot = torch.nn.functional.one_hot(idx[:, :upto - s - 1], adim).float()
            shifted[:, s + 1:upto, 1:] = onehot
        else:
            mean = logits[:, 0]
            action[:, s, 0] = mean[:, -1]
            log_prob[:, s, 0] = D.normal_log_prob(mean, std, mean)[:, -1]
    return DecodeResult(action, log_prob)


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
