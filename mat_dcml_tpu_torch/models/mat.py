"""The Multi-Agent Transformer as ``nn.Module``s.

Port of ``mat_dcml_tpu/models/mat.py``.  The encoder doubles as the critic:
its head emits per-agent values off the trunk that produces ``obs_rep``.  The
decoder maps previous agents' actions and ``obs_rep`` to the current agent's
logits.

Action types: ``discrete`` (one categorical head per agent);
``semi_discrete``, the DCML mode (agents ``[0, n_agent + semi_index)`` are
categorical, the tail agents Gaussian with ``std = sigmoid(log_std) * 0.5``);
``continuous`` (a Gaussian over all action dims, multi-agent MuJoCo) and
``available_continuous`` (a one-hot over the first ``discrete_dim`` dims, then
a Gaussian over the rest).

The configuration fields beyond the recipe's: ``n_objective`` widens the
encoder's value head to one value per objective (MO-MAT, DMO-MAT);
``encode_state`` makes the encoder read ``state`` through
``state_encoder`` instead of ``obs``; ``dec_actor`` replaces the decoder
trunk with a per-agent MLP actor on ``obs`` (the MAT-Dec ablation,
``ma_transformer.py:175-189``), one MLP for all agents with
``share_actor``, else one per agent with its weights stacked on a leading
``n_agent`` axis (JAX ``nn.vmap``), applied as one batched product.
Only the modules a configuration calls hold parameters, as in flax.

The trunk runs in ``MATConfig.dtype`` (``"float32"`` or ``"bfloat16"``, the
mixed-precision mode the JAX package's benchmark runs); the parameters, the
heads, attention scores and softmax and the distributions stay f32
(``modules.py``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mat_dcml_tpu_torch.device import resolve_device
from mat_dcml_tpu_torch.models.modules import (
    GAIN_ACT,
    GAIN_OUT,
    LN_EPS,
    DecodeBlock,
    Dense,
    EncodeBlock,
    gelu,
    init_packed_cache,
    layer_norm,
)

DISCRETE = "discrete"
SEMI_DISCRETE = "semi_discrete"
CONTINUOUS = "continuous"
AVAILABLE_CONTINUOUS = "available_continuous"
ACTION_TYPES = (DISCRETE, SEMI_DISCRETE, CONTINUOUS, AVAILABLE_CONTINUOUS)

NORMAL_STD = 0.5
TRUNK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class MATConfig:
    n_agent: int
    obs_dim: int
    state_dim: int
    action_dim: int
    n_block: int = 2
    n_embd: int = 64
    n_head: int = 2
    action_type: str = DISCRETE
    semi_index: int = -1          # number of trailing continuous agents, negated
    discrete_dim: int = 2         # available_continuous: leading one-hot dims
    encode_state: bool = False    # the encoder reads state, not obs
    dec_actor: bool = False       # MAT-Dec: an MLP actor instead of the decoder trunk
    share_actor: bool = False     # MAT-Dec: one MLP for all agents
    n_objective: int = 1          # > 1: MO-MAT's vector-valued critic
    # the trunk's computation dtype; params, heads and distributions stay f32
    dtype: str = "float32"

    def __post_init__(self):
        if self.action_type not in ACTION_TYPES:
            raise ValueError(f"action_type must be one of {ACTION_TYPES}, got {self.action_type!r}")
        if self.dtype not in TRUNK_DTYPES:
            raise ValueError(f"dtype must be one of {tuple(TRUNK_DTYPES)}, got {self.dtype!r}")
        if self.dec_actor and self.action_type not in (DISCRETE, SEMI_DISCRETE):
            raise NotImplementedError(
                f"dec_actor with {self.action_type!r} actions is not ported yet (MAT-Dec runs "
                "on DCML here; ROADMAP.md queue 1, item 10)")

    @property
    def trunk_dtype(self) -> torch.dtype:
        """The trunk's torch dtype: its activations, decode caches and the
        decode kernels' weights."""
        return TRUNK_DTYPES[self.dtype]

    @property
    def compute_dtype(self):
        """The modules' compute dtype: None (their f32 parameters' own) for
        an f32 trunk."""
        return None if self.dtype == "float32" else self.trunk_dtype

    @property
    def action_input_dim(self) -> int:
        # Discrete-style decoders consume one-hot + start-token slot.
        if self.action_type in (DISCRETE, SEMI_DISCRETE, AVAILABLE_CONTINUOUS):
            return self.action_dim + 1
        return self.action_dim

    @property
    def n_discrete_agents(self) -> int:
        """Agents with categorical heads in semi-discrete mode."""
        return self.n_agent + self.semi_index

    @property
    def act_out_dim(self) -> int:
        """Width of one agent's action (``transformer_policy.py:43-57``)."""
        return 1 if self.action_type in (DISCRETE, SEMI_DISCRETE) else self.action_dim

    @property
    def act_prob_dim(self) -> int:
        """Width of one agent's log-prob: one categorical, one per Gaussian
        dim, or the one-hot's plus the Gaussian tail's."""
        if self.action_type in (DISCRETE, SEMI_DISCRETE):
            return 1
        if self.action_type == AVAILABLE_CONTINUOUS:
            return self.action_dim - self.discrete_dim + 1
        return self.action_dim


class ObsEncoder(nn.Module):
    """LayerNorm -> Linear -> GELU embed."""

    def __init__(self, in_dim: int, n_embd: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.LayerNorm_0 = layer_norm(in_dim, dtype)
        self.Dense_0 = Dense(in_dim, n_embd, gain=GAIN_ACT, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(self.Dense_0(self.LayerNorm_0(x)))


class Head(nn.Module):
    """Linear-GELU-LN-Linear, always in f32: logits and values feed
    distributions and losses."""

    def __init__(self, n_embd: int, out_dim: int):
        super().__init__()
        self.Dense_0 = Dense(n_embd, n_embd, gain=GAIN_ACT)
        self.LayerNorm_0 = layer_norm(n_embd)
        self.Dense_1 = Dense(n_embd, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return self.Dense_1(self.LayerNorm_0(gelu(self.Dense_0(x))))


class Encoder(nn.Module):
    """Value head (``n_objective`` values an agent) plus the shared
    representation, from ``obs``, or from ``state`` under ``encode_state``."""

    def __init__(self, cfg: MATConfig):
        super().__init__()
        dt = cfg.compute_dtype
        self.encode_state = cfg.encode_state
        if cfg.encode_state:
            self.state_encoder = ObsEncoder(cfg.state_dim, cfg.n_embd, dt)
        else:
            self.obs_encoder = ObsEncoder(cfg.obs_dim, cfg.n_embd, dt)
        self.ln = layer_norm(cfg.n_embd, dt)
        self.blocks = nn.ModuleList(EncodeBlock(cfg.n_embd, cfg.n_head, dt)
                                    for _ in range(cfg.n_block))
        self.head = Head(cfg.n_embd, cfg.n_objective)

    def forward(self, state: torch.Tensor, obs: torch.Tensor):
        x = self.state_encoder(state) if self.encode_state else self.obs_encoder(obs)
        rep = self.ln(x)
        for blk in self.blocks:
            rep = blk(rep)
        return self.head(rep), rep


class DecActorMlp(nn.Module):
    """MAT-Dec's actor (``ma_transformer.py:175-189``), always f32:
    LN-Linear-GELU-LN-Linear-GELU-LN-Linear."""

    def __init__(self, in_dim: int, n_embd: int, action_dim: int):
        super().__init__()
        self.LayerNorm_0 = layer_norm(in_dim)
        self.Dense_0 = Dense(in_dim, n_embd, gain=GAIN_ACT)
        self.LayerNorm_1 = layer_norm(n_embd)
        self.Dense_1 = Dense(n_embd, n_embd, gain=GAIN_ACT)
        self.LayerNorm_2 = layer_norm(n_embd)
        self.Dense_2 = Dense(n_embd, action_dim)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = gelu(self.Dense_0(self.LayerNorm_0(obs)))
        x = gelu(self.Dense_1(self.LayerNorm_1(x)))
        return self.Dense_2(self.LayerNorm_2(x))


class StackedDense(nn.Module):
    """``n`` Dense layers, one an agent, as one batched product: ``kernel
    (n, in, out)`` (a flax kernel with ``nn.vmap``'s leading axis), ``bias
    (n, out)``; input ``(B, n, in)``, agent ``a`` through layer ``a``."""

    def __init__(self, n: int, in_features: int, out_features: int, gain: float = GAIN_OUT):
        super().__init__()
        self.gain = gain
        self.kernel = nn.Parameter(torch.empty(n, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features))
        self.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bni,nio->bno", x, self.kernel) + self.bias

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for k in self.kernel.data:   # each agent's (in, out) kernel its own orthogonal draw
            nn.init.orthogonal_(k, self.gain, generator=generator)
        nn.init.zeros_(self.bias)


class StackedLayerNorm(nn.Module):
    """``n`` LayerNorms (eps 1e-6), one an agent: ``scale``, ``bias (n, d)``."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, d))
        self.bias = nn.Parameter(torch.zeros(n, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], eps=LN_EPS) * self.scale + self.bias


class StackedDecActorMlp(nn.Module):
    """One :class:`DecActorMlp` an agent (JAX ``nn.vmap`` over stacked
    parameters), all agents in one pass: ``(B, n_agent, in) -> (B, n_agent,
    action_dim)``."""

    def __init__(self, n_agent: int, in_dim: int, n_embd: int, action_dim: int):
        super().__init__()
        self.LayerNorm_0 = StackedLayerNorm(n_agent, in_dim)
        self.Dense_0 = StackedDense(n_agent, in_dim, n_embd, gain=GAIN_ACT)
        self.LayerNorm_1 = StackedLayerNorm(n_agent, n_embd)
        self.Dense_1 = StackedDense(n_agent, n_embd, n_embd, gain=GAIN_ACT)
        self.LayerNorm_2 = StackedLayerNorm(n_agent, n_embd)
        self.Dense_2 = StackedDense(n_agent, n_embd, action_dim)

    forward = DecActorMlp.forward


class Decoder(nn.Module):
    """Action-conditioned decoder, or MAT-Dec's MLP actor (``dec_actor``)."""

    def __init__(self, cfg: MATConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        if cfg.action_type != DISCRETE:
            self.log_std = nn.Parameter(torch.ones(cfg.action_dim))
        if cfg.dec_actor:
            self.mlp = (DecActorMlp(cfg.obs_dim, cfg.n_embd, cfg.action_dim) if cfg.share_actor
                        else StackedDecActorMlp(cfg.n_agent, cfg.obs_dim, cfg.n_embd,
                                                cfg.action_dim))
            return
        if cfg.action_type in (DISCRETE, SEMI_DISCRETE):
            self.action_encoder_nobias = Dense(cfg.action_input_dim, cfg.n_embd, gain=GAIN_ACT,
                                               bias=False, dtype=dt)
        else:
            self.action_encoder_bias = Dense(cfg.action_input_dim, cfg.n_embd, gain=GAIN_ACT,
                                             dtype=dt)
        self.ln = layer_norm(cfg.n_embd, dt)
        self.blocks = nn.ModuleList(DecodeBlock(cfg.n_embd, cfg.n_head, dt)
                                    for _ in range(cfg.n_block))
        self.head = Head(cfg.n_embd, cfg.action_dim)

    def _embed_action(self, shifted_action: torch.Tensor) -> torch.Tensor:
        if self.cfg.action_type in (DISCRETE, SEMI_DISCRETE):
            return gelu(self.action_encoder_nobias(shifted_action))
        return gelu(self.action_encoder_bias(shifted_action))

    def forward(self, shifted_action: torch.Tensor, obs_rep: torch.Tensor,
                obs: torch.Tensor | None = None) -> torch.Tensor:
        """Teacher-forced pass -> ``(B, n_agent, action_dim)`` logits; under
        ``dec_actor`` the MLP actor's logits from ``obs`` alone."""
        if self.cfg.dec_actor:
            return self.mlp(obs)
        x = self.ln(self._embed_action(shifted_action))
        for blk in self.blocks:
            x = blk(x, obs_rep)
        return self.head(x)

    def decode_queries(self, obs_rep: torch.Tensor) -> torch.Tensor:
        """Cross-attention queries of every block for all A positions,
        ``(n_block, B, H, A, Dh)``: ``obs_rep`` is known before the decode
        loop starts, so these come out of it."""
        return torch.stack([blk.attn2.project_q_heads(obs_rep) for blk in self.blocks])

    def decode_step_cached(self, shifted_action_i: torch.Tensor, rep_i: torch.Tensor,
                           q2_i: torch.Tensor, kv, i: int, valid: torch.Tensor) -> torch.Tensor:
        """One decode position against the packed head-split cache, written in
        place.

        Args:
          shifted_action_i: ``(B, 1, action_input_dim)`` previous agent's
            one-hot action, or the start token at i = 0.
          rep_i: ``(B, 1, n_embd)`` encoder rep at position i.
          q2_i: ``(n_block, B, H, 1, Dh)`` cross-attention queries at i.
          kv: ``(k_buf, v_buf)`` packed cache pair.
          i: agent index.
          valid: ``(A,)`` bool, True at positions ``<= i``.

        Returns:
          ``(B, 1, action_dim)`` logits.
        """
        x = self.ln(self._embed_action(shifted_action_i))
        for bi, blk in enumerate(self.blocks):
            x = blk.decode_step_packed(x, rep_i, q2_i[bi], kv, 2 * bi, i, valid)
        return self.head(x)

    def std(self) -> torch.Tensor:
        return torch.sigmoid(self.log_std) * NORMAL_STD


class MultiAgentTransformer(nn.Module):
    """Encoder and decoder with the methods the decode paths call.

    Built on ``device`` (default ``cuda``; raises when CUDA is absent).
    Weights are initialised on the CPU from ``generator``, then moved, so one
    seed gives the same weights on every device.
    """

    def __init__(self, cfg: MATConfig, device=None, generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        for mod in self.modules():
            if isinstance(mod, (Dense, StackedDense)):
                mod.reset_parameters(generator)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.encoder.head.Dense_1.weight.device

    def forward(self, state: torch.Tensor, obs: torch.Tensor, shifted_action: torch.Tensor):
        v_loc, rep = self.encoder(state, obs)
        return v_loc, rep, self.decoder(shifted_action, rep, obs)

    def encode(self, state: torch.Tensor, obs: torch.Tensor):
        return self.encoder(state, obs)

    def decode_queries(self, obs_rep: torch.Tensor) -> torch.Tensor:
        return self.decoder.decode_queries(obs_rep)

    def decode_step_cached(self, shifted_action_i, rep_i, q2_i, kv, i, valid):
        return self.decoder.decode_step_cached(shifted_action_i, rep_i, q2_i, kv, i, valid)

    def action_std(self) -> torch.Tensor:
        return self.decoder.std()

    def fresh_packed_cache(self, batch: int):
        """The packed K/V caches of :meth:`decode_step_cached`, in the trunk's
        dtype."""
        c = self.cfg
        return init_packed_cache(c.n_block, batch, c.n_agent, c.n_embd, c.n_head,
                                 dtype=c.trunk_dtype, device=self.device)
