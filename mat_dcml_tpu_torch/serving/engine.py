"""Decode engine: a fixed ladder of batch buckets over ``serve_decode``.

Port of ``mat_dcml_tpu/serving/engine.py``.  The JAX engine compiles one
program per bucket ahead of time; PyTorch runs eagerly, so here a bucket is
only an admitted batch size, and the per-bucket compile count becomes a
per-bucket dispatch count (``dispatch_counts``).  A request is one joint
observation ``state (A, state_dim)``, ``obs (A, obs_dim)``,
``available_actions (A, action_dim)``; the engine takes host numpy stacked
to a bucket's size and returns host numpy actions ``(b, A, act_out_dim)`` and
log-probs ``(b, A, act_prob_dim)``, for any of the four action families.

``serve_dtype="bf16"`` serves a bf16 trunk as the JAX engine does: at install
every f32 parameter but the heads' and ``log_std`` is cast to bf16, and the
decode runs with ``MATConfig(dtype="bfloat16")`` (bf16 caches, the decode
kernels' bf16 legs on the card).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from mat_dcml_tpu_torch.device import resolve_device
from mat_dcml_tpu_torch.models.decode import DECODE_MODES, serve_decode
from mat_dcml_tpu_torch.models.mat import MATConfig, MultiAgentTransformer
from mat_dcml_tpu_torch.models.modules import packed_cache_bytes
from mat_dcml_tpu_torch.telemetry import Telemetry


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """``buckets`` is the batch-size ladder, ascending; the batcher pads each
    dispatch up to the smallest bucket that fits.  ``decode_mode``:
    ``"cached"`` (O(1)-per-step packed-KV decode), ``"scan"`` (the same exact
    decode through the decode kernels on the card: one launch a decode for
    the discrete families, one a position for the continuous ones) or
    ``"stride"`` (discrete families only; the reference's
    block-commit approximation, ``stride`` agents a pass; benchmark-protocol
    parity only).  ``serve_dtype``: ``"f32"``, or ``"bf16"`` for a bf16
    trunk (heads and ``log_std`` stay f32)."""

    buckets: Tuple[int, ...] = (1, 8, 32, 128)
    decode_mode: str = "cached"
    stride: int = 2
    serve_dtype: str = "f32"

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("EngineConfig.buckets must be non-empty")
        if list(self.buckets) != sorted(set(self.buckets)) or self.buckets[0] < 1:
            raise ValueError(f"buckets must be strictly ascending and positive, got {self.buckets}")
        if self.decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode must be one of {DECODE_MODES}, got {self.decode_mode!r}")
        if self.decode_mode == "spec":
            raise NotImplementedError(
                "decode_mode 'spec' is not ported yet (ROADMAP.md queue 1, item 11)"
            )
        if self.serve_dtype not in ("f32", "bf16"):
            raise ValueError(f"serve_dtype must be 'f32' or 'bf16', got {self.serve_dtype!r}")


def serve_cast(model: MultiAgentTransformer) -> MultiAgentTransformer:
    """The JAX engine's bf16 install cast (``serving/engine.py``
    ``_prepare_params``), in place: every f32 parameter becomes bf16 except
    those under a ``head`` and ``log_std``, which feed distributions and
    stay f32.  Returns ``model``."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if "head" not in parts and "log_std" not in parts and p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)
    return model


class DecodeEngine:
    """A ``state_dict`` and a ``MATConfig`` in, bucketed decodes out.

    Runs on ``device`` (default ``cuda``; raises when CUDA is absent).
    The decode is deterministic (the per-agent mode), as the JAX engine's
    is by default.
    """

    def __init__(
        self,
        params: Mapping[str, torch.Tensor],
        cfg: MATConfig,
        engine_cfg: EngineConfig = EngineConfig(),
        telemetry: Optional[Telemetry] = None,
        log_fn=print,
        device=None,
    ):
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.log = log_fn
        self.device = resolve_device(device)
        self._bf16 = engine_cfg.serve_dtype == "bf16"
        # the config the decode runs with: a bf16 trunk for serve_dtype "bf16"
        self.serve_cfg = dataclasses.replace(cfg, dtype="bfloat16") if self._bf16 else cfg
        self.dispatch_counts: Dict[int, int] = {b: 0 for b in engine_cfg.buckets}
        # the export's obs / act space metadata (set by from_export)
        self.space_meta: Dict = {}
        self._model = self._build_model(params)
        self._zero_batches: Dict[int, Tuple[np.ndarray, ...]] = {}
        self._steady = False

    @classmethod
    def from_export(cls, directory, engine_cfg: EngineConfig = EngineConfig(),
                    telemetry: Optional[Telemetry] = None, log_fn=print,
                    device=None) -> "DecodeEngine":
        """Build from a weights-only export (``training/checkpoint.py::export_policy``);
        ``space_meta`` is the export's."""
        from mat_dcml_tpu_torch.training.checkpoint import load_policy

        params, cfg, space_meta = load_policy(directory)
        eng = cls(params, cfg, engine_cfg, telemetry, log_fn, device=device)
        eng.space_meta = space_meta
        return eng

    def _build_model(self, params) -> MultiAgentTransformer:
        model = MultiAgentTransformer(self.serve_cfg, device=self.device)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        if self._bf16:
            serve_cast(model)
        return model.eval().requires_grad_(False)

    def _zero_batch(self, b: int):
        if b not in self._zero_batches:
            c = self.cfg
            self._zero_batches[b] = (
                np.zeros((b, c.n_agent, c.state_dim), np.float32),
                np.zeros((b, c.n_agent, c.obs_dim), np.float32),
                np.ones((b, c.n_agent, c.action_dim), np.float32),
            )
        return self._zero_batches[b]

    def _run(self, model, state, obs, avail):
        ecfg = self.engine_cfg
        _, res = serve_decode(model, state, obs, avail, deterministic=True,
                              mode=ecfg.decode_mode, stride=ecfg.stride, device=self.device)
        return res.action.cpu().numpy(), res.log_prob.cpu().numpy()

    # ------------------------------------------------------------- lifecycle

    def warmup(self) -> None:
        """Run every bucket once (the first CUDA call builds and loads the
        kernels), then start recording request latencies."""
        for b in self.engine_cfg.buckets:
            t0 = time.perf_counter()
            self._run(self._model, *self._zero_batch(b))
            self.log(f"[serving] bucket {b}: warm in {time.perf_counter() - t0:.2f}s")
        self._steady = True
        tel = self.telemetry
        tel.gauge("serving_buckets", float(len(self.engine_cfg.buckets)))
        tel.gauge("serving_dtype_bits", 16.0 if self._bf16 else 32.0)
        c = self.serve_cfg
        if self.engine_cfg.decode_mode == "stride":
            return   # teacher-forced passes: no K/V cache
        for b in self.engine_cfg.buckets:
            # the scan decode's workspace holds the same K/V as the packed cache
            tel.gauge(f"decode_cache_bytes_b{b}",
                      float(packed_cache_bytes(c.n_block, b, c.n_agent, c.n_embd,
                                               dtype=c.trunk_dtype)))

    def install_params(self, params, warm: bool = True) -> None:
        """Publish-then-swap: the new weights are loaded next to the live
        ones and (``warm=True``) run through every bucket while the old ones
        keep serving; then one attribute store swaps them.  A dispatch reads
        the model once at entry, so it never mixes weights."""
        model = self._build_model(params)
        if warm:
            for b in self.engine_cfg.buckets:
                self._run(model, *self._zero_batch(b))
        self._model = model
        self.telemetry.count("serving_weight_swaps")

    # --------------------------------------------------------------- serving

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` requests (largest bucket caps it)."""
        for b in self.engine_cfg.buckets:
            if n <= b:
                return b
        return self.engine_cfg.buckets[-1]

    @property
    def max_batch(self) -> int:
        return self.engine_cfg.buckets[-1]

    @property
    def min_bucket(self) -> int:
        return self.engine_cfg.buckets[0]

    def decode(self, state: np.ndarray, obs: np.ndarray,
               avail: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Decode one batch already padded to a bucket size (the batcher's
        job); any other batch size raises."""
        b = state.shape[0]
        if b not in self.engine_cfg.buckets:
            raise ValueError(f"batch {b} is not a bucket {self.engine_cfg.buckets}")
        t0 = time.perf_counter()
        model = self._model
        result = self._run(model, state, obs, avail)
        self.dispatch_counts[b] += 1
        if self._steady:
            self.telemetry.hist("serving_decode_ms", (time.perf_counter() - t0) * 1e3)
        return result
