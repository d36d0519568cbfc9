"""Action decode for MAT: the serving entry, the exact decodes, the stride
decode and the teacher-forced evaluation of the PPO update.

Port of ``mat_dcml_tpu/models/decode.py`` for ``mode="cached"`` (the serving
and rollout default), ``mode="scan"`` (:func:`ar_decode`: for the discrete
families the whole decode in one launch of ``csrc/ar_decode.cu`` on the card,
for the continuous ones one launch of ``csrc/decode_step.cu`` per position),
``mode="stride"`` and ``parallel_act``, for all four action families
(``stride`` for the discrete ones only, as in JAX).  In the cached decode the
JAX ``lax.scan`` over agents becomes a Python loop over positions; the packed
K/V cache is written in place.  Sampling noise is an input (Gumbel for
categorical draws, standard normals for the Gaussian parts), drawn from the
caller's ``torch.Generator`` when not given, so a test can replay the JAX key
chain exactly.

Noise per family (:func:`noise_shapes`): ``gumbel (B, A, adim)`` for the
discrete and semi-discrete draws, ``(B, A, discrete_dim)`` for the one-hot of
``available_continuous``; ``tail_noise (A, B, adim)`` for the semi-discrete
tail and for ``continuous``, ``(A, B, adim - discrete_dim)`` for the Gaussian
part of ``available_continuous``.  Row ``i`` of each is what JAX draws at
position ``i`` from ``k_d`` and ``k_c`` of ``key, k_d, k_c = split(key, 3)``,
at the same shapes.

MAT-Dec (``MATConfig(dec_actor=True)``) has no decoder trunk: its
``cached`` and ``scan`` decodes are one pass of the MLP actor over all
agents, then the sampling of every position at once
(:func:`dec_actor_decode`), the route the JAX package takes for it
(``mat_dcml_tpu/models/decode.py:77``: no trunk to fuse), so it launches no
decode kernel.  It reads the same noise as the other decodes.

With a bf16 trunk (``MATConfig(dtype="bfloat16")``) ``obs_rep``, the caches
and the decode kernels' inputs are bf16, as the JAX decode's are; values,
logits, log-probs and actions are f32.
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
from mat_dcml_tpu_torch.ops.decode_step import decode_caches, fused_decode_step, pack_decode_weights

CONTINUOUS_FAMILIES = (CONTINUOUS, AVAILABLE_CONTINUOUS)


class DecodeResult(NamedTuple):
    action: torch.Tensor      # (B, n_agent, act_out_dim) float32
    log_prob: torch.Tensor    # (B, n_agent, act_prob_dim) float32


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
    :func:`ar_decode`, the same exact decode through the decode kernels on
    the card; ``"stride"`` = :func:`stride_decode`, the reference's
    block-commit approximation, discrete families and deterministic only
    (``deterministic=False`` raises).
    ``"spec"`` is not ported yet.  Both exact modes read the same noise.
    Under ``dec_actor`` both exact modes are :func:`dec_actor_decode`.
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
            res = stride_decode(model, obs_rep, avail, stride=stride, obs=put(obs))
        elif model.cfg.dec_actor:
            res = dec_actor_decode(model, put(obs), avail, deterministic, generator=generator,
                                   gumbel=gumbel, tail_noise=tail_noise)
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
    """Sampling at position ``i`` from its ``(B, adim)`` logits (JAX
    ``_sample_position``); returns ``(act, logp, nxt)`` with ``nxt`` the next
    step's shifted-action feed ``(B, 1, action_input_dim)``.  ``gumbel_i`` and
    ``noise_i`` are row ``i`` of the family's noise (module docstring)."""
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
    if cfg.action_type == CONTINUOUS:
        act = logits if deterministic else D.normal_sample_from_noise(logits, std, noise_i)
        return act, D.normal_log_prob(logits, std, act), act[:, None, :]
    # AVAILABLE_CONTINUOUS (transformer_act.py:244-283): a one-hot over the
    # first dd dims, a Gaussian over the rest; the feed is [0, one-hot, c_act]
    dd = cfg.discrete_dim
    d_logits = D.mask_logits(logits[:, :dd], None if ava_i is None else ava_i[:, :dd])
    d_idx = (D.categorical_mode(d_logits) if deterministic
             else D.categorical_sample_from_gumbel(d_logits, gumbel_i))
    d_logp = D.categorical_log_prob(d_logits, d_idx)
    d_onehot = torch.zeros_like(d_logits).scatter_(-1, d_idx[:, None], 1.0)
    c_std, c_mean = std[dd:], logits[:, dd:]
    c_act = c_mean if deterministic else D.normal_sample_from_noise(c_mean, c_std, noise_i)
    c_logp = D.normal_log_prob(c_mean, c_std, c_act)
    act = torch.cat([d_onehot, c_act], dim=-1)
    nxt = torch.zeros(logits.shape[0], 1, in_dim, device=logits.device)
    nxt[:, 0, 1:] = act
    return act, torch.cat([d_logp[:, None], c_logp], dim=-1), nxt


def _start_token(cfg, B, dev) -> torch.Tensor:
    """The feed of position 0, ``(B, 1, action_input_dim)``: a set start flag
    for the families whose feed has one (``transformer_act.py:33``), zeros for
    ``continuous``."""
    start = torch.zeros(B, 1, cfg.action_input_dim, device=dev)
    if cfg.action_type != CONTINUOUS:
        start[:, 0, 0] = 1.0
    return start


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

    Noise for a stochastic decode: ``gumbel`` and ``tail_noise`` at the
    family's shapes (module docstring; the semi-discrete tail's rows below
    ``n_discrete_agents`` are unused).  Whichever is not given is drawn from
    ``generator``.  A deterministic decode takes modes and reads no noise.
    """
    cfg = model.cfg
    dev = obs_rep.device
    B = obs_rep.shape[0]
    A, adim = cfg.n_agent, cfg.action_dim
    if available_actions is None:
        available_actions = torch.ones(B, A, adim, device=dev)
    std = model.action_std() if cfg.action_type != DISCRETE else None

    if not deterministic:
        gumbel, tail_noise = _draw_noise(cfg, B, dev, generator, gumbel, tail_noise)

    shifted = _start_token(cfg, B, dev)
    kv = model.fresh_packed_cache(B)
    q2 = model.decode_queries(obs_rep)                       # (n_block, B, H, A, Dh)
    valid = torch.ones(A, A, dtype=torch.bool, device=dev).tril()   # row i: keys <= i

    acts, logps = [], []
    for i in range(A):
        logits = model.decode_step_cached(
            shifted, obs_rep[:, i:i + 1], q2[:, :, :, i:i + 1], kv, i, valid[i]
        )
        act, logp, shifted = _sample_position(
            cfg, logits[:, 0], available_actions[:, i], i, *_noise_at(gumbel, tail_noise, i),
            std, deterministic,
        )
        acts.append(act)
        logps.append(logp)
    return DecodeResult(torch.stack(acts, dim=1), torch.stack(logps, dim=1))


def noise_shapes(cfg, B: int):
    """``(gumbel shape, tail_noise shape)`` of one decode of ``B`` rows, None
    where the family reads no such noise (module docstring)."""
    A, adim, dd = cfg.n_agent, cfg.action_dim, cfg.discrete_dim
    return {
        DISCRETE: ((B, A, adim), None),
        SEMI_DISCRETE: ((B, A, adim), (A, B, adim)),
        CONTINUOUS: (None, (A, B, adim)),
        AVAILABLE_CONTINUOUS: ((B, A, dd), (A, B, adim - dd)),
    }[cfg.action_type]


def draw_noise(shapes, generator: Optional[torch.Generator], dev):
    """Draws at ``(gumbel shape, tail_noise shape)`` from ``generator``, the
    Gumbel first; None where a shape is None."""
    g_shape, n_shape = shapes
    gumbel = None if g_shape is None else D.gumbel_noise(g_shape, generator, dev)
    normal = None if n_shape is None else torch.randn(n_shape, generator=generator, device=dev)
    return gumbel, normal


def _draw_noise(cfg, B, dev, generator, gumbel, tail_noise):
    """``(gumbel, tail_noise)`` on ``dev`` at the family's shapes: the given
    noise, or draws from ``generator``, Gumbel first."""
    g_draw, n_draw = draw_noise(
        tuple(None if given is not None else shape
              for given, shape in zip((gumbel, tail_noise), noise_shapes(cfg, B))),
        generator, dev)
    gumbel = g_draw if gumbel is None else gumbel
    tail_noise = n_draw if tail_noise is None else tail_noise
    return (None if gumbel is None else gumbel.to(dev),
            None if tail_noise is None else tail_noise.to(dev))


def _noise_at(gumbel, tail_noise, i):
    """Position ``i``'s rows of the noise (None where absent)."""
    return (None if gumbel is None else gumbel[:, i],
            None if tail_noise is None else tail_noise[i])


def dec_actor_decode(
    model: MultiAgentTransformer,
    obs: torch.Tensor,
    available_actions: Optional[torch.Tensor],
    deterministic: bool = False,
    *,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
    tail_noise: Optional[torch.Tensor] = None,
) -> DecodeResult:
    """MAT-Dec's exact decode (JAX ``ar_decode`` with ``dec_actor``): no
    position reads another's action, so the MLP actor's logits of all agents
    come from one pass over ``obs (B, A, obs_dim)``, and every position is
    sampled at once from the same noise as :func:`cached_decode` (the
    Gumbel rows, and the Gaussian rows of the tail agents).  The discrete
    families only (``MATConfig`` checks)."""
    cfg = model.cfg
    logits = model.decoder.mlp(obs)                                 # (B, A, adim)
    if not deterministic:
        gumbel, tail_noise = _draw_noise(cfg, obs.shape[0], obs.device, generator, gumbel,
                                         tail_noise)
    normal = None if deterministic or tail_noise is None else tail_noise.transpose(0, 1)
    masked = D.mask_logits(logits, available_actions)
    idx = (D.categorical_mode(masked) if deterministic
           else D.categorical_sample_from_gumbel(masked, gumbel))
    act, logp = idx[..., None].float(), D.categorical_log_prob(masked, idx)[..., None]
    if cfg.action_type == SEMI_DISCRETE:
        nd, std = cfg.n_discrete_agents, model.action_std()
        mean = logits[:, nd:]
        c_act = mean if deterministic else D.normal_sample_from_noise(mean, std, normal[:, nd:])
        c_logp = D.normal_log_prob(mean, std, c_act)
        act = torch.cat([act[:, :nd], c_act[..., -1:]], dim=1)
        logp = torch.cat([logp[:, :nd], c_logp[..., -1:]], dim=1)
    return DecodeResult(act, logp)


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
    ``mode="scan"``): the same decode as :func:`cached_decode`, through the
    decode kernels.  The discrete families run whole in one launch
    (:func:`_fused_ar_decode_path`), the continuous ones one launch per
    position with sampling between (:func:`_decode_step_path`), as the JAX
    decode does on its Pallas path.  It reads the same noise as
    :func:`cached_decode` (given, or drawn from ``generator`` in the same
    order).  The JAX signature's ``obs`` is left out: only MAT-Dec's
    decoder reads it, and :func:`serve_decode` routes MAT-Dec to
    :func:`dec_actor_decode`."""
    path = (_decode_step_path if model.cfg.action_type in CONTINUOUS_FAMILIES
            else _fused_ar_decode_path)
    return path(model, obs_rep, available_actions, deterministic,
                generator=generator, gumbel=gumbel, tail_noise=tail_noise)


def _decode_step_path(model, obs_rep, available_actions, deterministic, *,
                      generator, gumbel, tail_noise) -> DecodeResult:
    """The continuous families' exact decode (JAX ``ar_decode`` with
    ``fused_decode_step``, ``decode.py:238-296``): one
    ``ops/decode_step.fused_decode_step`` per position (the kernel on the
    card, its plain twin on the CPU), its K/V caches in one workspace
    allocated here, and the position's sampling in PyTorch between
    launches.  The kernel takes its input in the trunk's dtype, as the
    embedding's Dense casts it."""
    cfg = model.cfg
    dev = obs_rep.device
    B, A, Dm = obs_rep.shape
    dt = cfg.trunk_dtype
    if available_actions is None:
        available_actions = torch.ones(B, A, cfg.action_dim, device=dev)
    if not deterministic:
        gumbel, tail_noise = _draw_noise(cfg, B, dev, generator, gumbel, tail_noise)
    std = model.action_std()
    weights = pack_decode_weights(model)
    caches = decode_caches(cfg.n_block, A, B, Dm, dev, dtype=dt)
    shifted = _start_token(cfg, B, dev)[:, 0]
    acts, logps = [], []
    for i in range(A):
        logits = fused_decode_step(weights, shifted.to(dt), obs_rep[:, i], caches, i,
                                   n_head=cfg.n_head, adim=cfg.action_dim)
        act, logp, nxt = _sample_position(
            cfg, logits, available_actions[:, i], i, *_noise_at(gumbel, tail_noise, i),
            std, deterministic,
        )
        shifted = nxt[:, 0]
        acts.append(act)
        logps.append(logp)
    return DecodeResult(torch.stack(acts, dim=1), torch.stack(logps, dim=1))


def _fused_ar_decode_path(model, obs_rep, available_actions, deterministic, *,
                          generator, gumbel, tail_noise) -> DecodeResult:
    """The whole decode through ``ops/ar_decode.fused_ar_decode``: the kernel
    on the card, its plain twin on the CPU.  Sampling noise becomes the
    kernel's inputs: the Gumbel tensor, and the tail noise of agents ``>=
    nd`` as ``(B, A - nd, adim)`` normal rows; a deterministic decode passes
    zeros (argmax of the masked logits, the tail's mean), as the JAX path
    does.  ``obs_rep`` goes in in the trunk's dtype."""
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
    obs: Optional[torch.Tensor] = None,
) -> DecodeResult:
    """The reference's deterministic block-commit decode
    (``transformer_act.py:37-75``; JAX ``stride_decode``): decode agent 0
    alone, then commit blocks of ``stride`` discrete agents per full decoder
    pass (agents inside a block do not see each other's actions), then the
    continuous tail one at a time.  Every pass is the teacher-forced decoder,
    whose attentions go through the attention kernel on the card (MAT-Dec's
    MLP actor on ``obs``)."""
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
        logits = model.decoder(shifted, obs_rep, obs)[:, s:e]
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
    obs: Optional[torch.Tensor] = None,
):
    """Teacher-forced log-probs and entropies in one decoder pass
    (``mat_dcml_tpu/models/decode.py::parallel_act``; ``transformer_act.py``
    ``*_parallel_act``).

    ``obs_rep (B, A, D)``, ``action (B, A, act_out_dim)``; ``obs (B, A,
    obs_dim)``, which only MAT-Dec's actor reads.  Returns ``(log_prob,
    entropy)``, each ``(B, A, act_prob_dim)``.
    """
    cfg = model.cfg
    B, A, adim = obs_rep.shape[0], cfg.n_agent, cfg.action_dim

    def decoder(shifted):
        return model.decoder(shifted, obs_rep, obs)

    if cfg.action_type == DISCRETE:
        idx = action[..., 0].long()
        onehot = torch.nn.functional.one_hot(idx, adim).float()
        logits = decoder(_shift_with_start(onehot, B, A, adim))
        logits = D.mask_logits(logits, available_actions)
        return (D.categorical_log_prob(logits, idx)[..., None],
                D.categorical_entropy(logits)[..., None])
    if cfg.action_type == CONTINUOUS:
        shifted = torch.zeros(B, A, adim, device=obs_rep.device)
        shifted[:, 1:] = action[:, :-1]
        mean = decoder(shifted)
        std = model.action_std()
        return (D.normal_log_prob(mean, std, action),
                D.normal_entropy(mean, std).expand_as(mean))
    if cfg.action_type == AVAILABLE_CONTINUOUS:
        dd = cfg.discrete_dim
        logits = decoder(_shift_with_start(action, B, A, adim))
        if available_actions is not None:
            # the reference masks the full logits, continuous means included
            # (transformer_act.py:295-296)
            logits = D.mask_logits(logits, available_actions)
        d_idx = torch.argmax(action[..., :dd], dim=-1)
        d_logp = D.categorical_log_prob(logits[..., :dd], d_idx)[..., None]
        d_ent = D.categorical_entropy(logits[..., :dd])[..., None]
        std = model.action_std()[dd:]
        c_mean = logits[..., dd:]
        c_logp = D.normal_log_prob(c_mean, std, action[..., dd:])
        c_ent = D.normal_entropy(c_mean, std).expand_as(c_mean)
        return torch.cat([d_logp, c_logp], dim=-1), torch.cat([d_ent, c_ent], dim=-1)
    nd = cfg.n_discrete_agents
    idx = action[:, :nd, 0].long()
    onehot = torch.nn.functional.one_hot(idx, adim).float()
    cont = action[:, nd:, :].expand(B, A - nd, adim)
    shifted = _shift_with_start(torch.cat([onehot, cont], dim=1), B, A, adim)
    logits = decoder(shifted)
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
