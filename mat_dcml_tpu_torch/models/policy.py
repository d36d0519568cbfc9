"""The MAT policy: rollout decode, teacher-forced evaluation, values.

Port of ``mat_dcml_tpu/models/policy.py::TransformerPolicy`` for the cached
decode.  The JAX policy is a bundle of pure functions over an explicit
params tree; here it holds the ``MultiAgentTransformer`` whose parameters the
trainer updates in place.  All methods keep the ``(batch, n_agent, dim)``
layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mat_dcml_tpu_torch.models.decode import parallel_act, serve_decode
from mat_dcml_tpu_torch.models.mat import DISCRETE, SEMI_DISCRETE, MATConfig, MultiAgentTransformer


class PolicyOutput(NamedTuple):
    value: torch.Tensor      # (B, n_agent, 1)
    action: torch.Tensor     # (B, n_agent, 1)
    log_prob: torch.Tensor   # (B, n_agent, 1)


class TransformerPolicy:
    """``get_actions`` / ``evaluate_actions`` / ``get_values``
    (``transformer_policy.py:116-241``) with the sampling noise as an input
    instead of a PRNG key.  The model is built on ``device`` (default
    ``cuda``) with weights from ``generator``."""

    def __init__(self, cfg: MATConfig, decode_mode: str = "cached", device=None,
                 generator: Optional[torch.Generator] = None):
        if decode_mode != "cached":
            raise NotImplementedError(
                f"decode_mode {decode_mode!r} is not ported yet (ROADMAP.md queue 1, item 4); "
                "use 'cached'"
            )
        if cfg.action_type not in (DISCRETE, SEMI_DISCRETE):
            raise NotImplementedError(
                f"action_type {cfg.action_type!r} is not ported yet (ROADMAP.md queue 1, item 4)"
            )
        self.cfg = cfg
        self.decode_mode = decode_mode
        self.model = MultiAgentTransformer(cfg, device=device, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def get_actions(self, state, obs, available_actions=None, deterministic: bool = False, *,
                    gumbel: Optional[torch.Tensor] = None,
                    tail_noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> PolicyOutput:
        """Autoregressive decode (``ma_transformer.py:298-329``) through the
        serving entry ``serve_decode(mode="cached")``, so rollout and serving
        share one path.  Noise: ``gumbel (B, A, adim)`` and ``tail_noise (A,
        B, adim)``, drawn from ``generator`` where not given."""
        v_loc, res = serve_decode(
            self.model, state, obs, available_actions, deterministic, mode="cached",
            device=self.device, generator=generator, gumbel=gumbel, tail_noise=tail_noise,
        )
        return PolicyOutput(v_loc, res.action, res.log_prob)

    def evaluate_actions(self, state, obs, action, available_actions=None):
        """Teacher-forced ``(values, log_prob, entropy)``
        (``ma_transformer.py:257-295``); entropy un-reduced ``(B, A, 1)``."""
        v_loc, obs_rep = self.model.encode(state, obs)
        logp, ent = parallel_act(self.model, obs_rep, action, available_actions)
        return v_loc, logp, ent

    def get_values(self, state, obs) -> torch.Tensor:
        """The encoder as critic (``ma_transformer.py:331-339``)."""
        return self.model.encode(state, obs)[0]
