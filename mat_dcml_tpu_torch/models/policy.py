"""The MAT policy: rollout decode, teacher-forced evaluation, values.

Port of ``mat_dcml_tpu/models/policy.py::TransformerPolicy`` for the cached
and the scan decode, for all four action families, and ``act_stride``, the
benchmark protocol's deterministic stride decode (discrete families).  The
JAX policy is a bundle of pure functions over an explicit params tree; here
it holds the ``MultiAgentTransformer`` whose parameters the trainer updates
in place.  All methods keep the ``(batch, n_agent, dim)`` layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mat_dcml_tpu_torch.models.decode import (
    CONTINUOUS_FAMILIES,
    DECODE_MODES,
    draw_noise,
    noise_shapes,
    parallel_act,
    serve_decode,
)
from mat_dcml_tpu_torch.models.mat import MATConfig, MultiAgentTransformer


class PolicyOutput(NamedTuple):
    value: torch.Tensor      # (B, n_agent, 1)
    action: torch.Tensor     # (B, n_agent, act_out_dim)
    log_prob: torch.Tensor   # (B, n_agent, act_prob_dim)


class TransformerPolicy:
    """``get_actions`` / ``evaluate_actions`` / ``get_values``
    (``transformer_policy.py:116-241``) with the sampling noise as an input
    instead of a PRNG key.  The model is built on ``device`` (default
    ``cuda``) with weights from ``generator``.  ``decode_mode`` is the
    ``serve_decode`` mode of :meth:`get_actions`: ``"cached"`` or ``"scan"``
    (through the decode kernels on the card), or ``"stride"`` (discrete
    families, deterministic only).  ``act_out_dim`` and ``act_prob_dim`` are
    the widths of one agent's action and log-prob
    (``transformer_policy.py:43-57``)."""

    def __init__(self, cfg: MATConfig, decode_mode: str = "cached", device=None,
                 generator: Optional[torch.Generator] = None):
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode must be one of {DECODE_MODES}, got {decode_mode!r}")
        if decode_mode == "spec":
            raise NotImplementedError(
                "decode_mode 'spec' is not ported yet (ROADMAP.md queue 1, item 11)"
            )
        if decode_mode == "stride" and cfg.action_type in CONTINUOUS_FAMILIES:
            raise NotImplementedError(
                f"the stride decode is discrete-family only, not {cfg.action_type!r}"
            )
        self.cfg = cfg
        self.decode_mode = decode_mode
        self.act_out_dim = cfg.act_out_dim
        self.act_prob_dim = cfg.act_prob_dim
        self.model = MultiAgentTransformer(cfg, device=device, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def get_actions(self, state, obs, available_actions=None, deterministic: bool = False, *,
                    gumbel: Optional[torch.Tensor] = None,
                    tail_noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> PolicyOutput:
        """Autoregressive decode (``ma_transformer.py:298-329``) through the
        serving entry ``serve_decode(mode=decode_mode)``, so rollout and
        serving share one path.  Noise: ``gumbel`` and ``tail_noise`` at the
        family's shapes (``models/decode.py::noise_shapes``), drawn from
        ``generator`` where not given."""
        v_loc, res = serve_decode(
            self.model, state, obs, available_actions, deterministic, mode=self.decode_mode,
            device=self.device, generator=generator, gumbel=gumbel, tail_noise=tail_noise,
        )
        return PolicyOutput(v_loc, res.action, res.log_prob)

    def draw_noise(self, n_envs: int, steps: int, generator: Optional[torch.Generator]):
        """``(gumbel, tail_noise)`` for ``steps`` decodes of ``n_envs`` rows,
        each with a leading ``steps`` axis (None where the family reads
        none), from ``generator`` on the policy's device."""
        shapes = tuple(None if s is None else (steps,) + s
                       for s in noise_shapes(self.cfg, n_envs))
        return draw_noise(shapes, generator, self.device)

    def act_stride(self, state, obs, available_actions=None, stride: int = 2) -> PolicyOutput:
        """Deterministic stride-batched decode for benchmark-protocol parity
        (``transformer_policy.py:219-241`` with ``stride``): ``stride``
        agents committed a teacher-forced decoder pass, whose attentions go
        through the attention kernel on the card."""
        v_loc, res = serve_decode(self.model, state, obs, available_actions, True,
                                  mode="stride", stride=stride, device=self.device)
        return PolicyOutput(v_loc, res.action, res.log_prob)

    def evaluate_actions(self, state, obs, action, available_actions=None):
        """Teacher-forced ``(values, log_prob, entropy)``
        (``ma_transformer.py:257-295``); entropy un-reduced ``(B, A,
        act_prob_dim)``."""
        v_loc, obs_rep = self.model.encode(state, obs)
        logp, ent = parallel_act(self.model, obs_rep, action, available_actions)
        return v_loc, logp, ent

    def get_values(self, state, obs) -> torch.Tensor:
        """The encoder as critic (``ma_transformer.py:331-339``)."""
        return self.model.encode(state, obs)[0]
