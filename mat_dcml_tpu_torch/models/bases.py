"""Feature extractors of the actor-critic family, over stacked parameters.

Port of ``MLPLayer`` and ``MLPBase`` of ``mat_dcml_tpu/models/bases.py``
(``:31-80``; ``mat/algorithms/utils/mlp.py``): an optional input LayerNorm,
then two ``MLPLayer`` stacks of (Dense, activation, LayerNorm) x
``1 + layer_N``; the second stack is ``out_dim`` wide when the mixed DCML
head slices its logits straight from the features (``mlp.py:51-56``).
``CNNBase`` and ``GRULayer`` wait for the recurrent slice (ROADMAP.md
queue 1, item 9).

The modules are functions of a parameter dict, not ``nn.Module``s: every
parameter carries a leading *stack* axis ``S`` (1 for a policy shared by all
agents, the agent count for IPPO's and HAPPO's one policy an agent), and
every input is ``(S, N, d)``, so all agents act through one batched product
(``torch.bmm``).  A module's ``spec()`` lists its parameters as flax names
them (``base/MLPLayer_0/Dense_0/kernel``, a kernel ``(in, out)``), with
their initialisation: orthogonal kernels with the ReLU gain sqrt(2) (tanh:
5/3), zero biases, unit LayerNorm scales.  :class:`ParamGroup` lays a spec
out in one flat ``(S, P)`` tensor, in sorted name order (``ravel_pytree``'s
order), and hands out views of it: an optimiser, a gradient clip or a
natural-gradient step then works on one tensor a stack row.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

ORTHO_GAIN_RELU = math.sqrt(2.0)         # nn.init.calculate_gain('relu')
ORTHO_GAIN_TANH = 5.0 / 3.0              # nn.init.calculate_gain('tanh')
LN_EPS = 1e-6                            # flax LayerNorm's epsilon


class ParamSpec(NamedTuple):
    name: str
    shape: Tuple[int, ...]     # one stack row's shape
    init: str                  # "orthogonal", "zeros", "ones" or "const"
    value: float = 0.0         # the gain (orthogonal) or the constant (const)


def dense_spec(prefix: str, d_in: int, d_out: int, gain: float) -> List[ParamSpec]:
    return [ParamSpec(f"{prefix}/kernel", (d_in, d_out), "orthogonal", gain),
            ParamSpec(f"{prefix}/bias", (d_out,), "zeros")]


def layer_norm_spec(prefix: str, d: int) -> List[ParamSpec]:
    return [ParamSpec(f"{prefix}/scale", (d,), "ones"),
            ParamSpec(f"{prefix}/bias", (d,), "zeros")]


def dense(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor) -> torch.Tensor:
    """flax ``Dense``: ``x @ kernel + bias`` on every stack row; ``x (S, N, in)``."""
    return torch.bmm(x, p[f"{prefix}/kernel"]) + p[f"{prefix}/bias"][:, None]


def layer_norm(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm`` (eps 1e-6) over the last axis; ``x (S, N, d)``."""
    y = F.layer_norm(x, x.shape[-1:], eps=LN_EPS)
    return y * p[f"{prefix}/scale"][:, None] + p[f"{prefix}/bias"][:, None]


class MLPLayer:
    """Dense, activation, LayerNorm, then ``layer_N`` repeats
    (``mlp.py:8-30``); every layer ``out_dim`` wide when it is set (the
    reference passes it as the layer's hidden size)."""

    def __init__(self, prefix: str, d_in: int, hidden_size: int, layer_N: int = 1,
                 use_relu: bool = True, out_dim: Optional[int] = None):
        self.prefix = prefix
        self.use_relu = use_relu
        self.widths = [hidden_size if out_dim is None else out_dim] * (1 + layer_N)
        self.d_in = d_in
        self.d_out = self.widths[-1]

    def spec(self) -> List[ParamSpec]:
        gain = ORTHO_GAIN_RELU if self.use_relu else ORTHO_GAIN_TANH
        out, d = [], self.d_in
        for j, w in enumerate(self.widths):
            out += dense_spec(f"{self.prefix}/Dense_{j}", d, w, gain)
            out += layer_norm_spec(f"{self.prefix}/LayerNorm_{j}", w)
            d = w
        return out

    def __call__(self, p, x):
        act = torch.relu if self.use_relu else torch.tanh
        for j in range(len(self.widths)):
            x = act(dense(p, f"{self.prefix}/Dense_{j}", x))
            x = layer_norm(p, f"{self.prefix}/LayerNorm_{j}", x)
        return x


class MLPBase:
    """The optional feature LayerNorm, then two :class:`MLPLayer` stacks
    (``mlp.py:33-67``)."""

    def __init__(self, prefix: str, d_in: int, hidden_size: int, layer_N: int = 1,
                 use_relu: bool = True, use_feature_normalization: bool = True,
                 out_dim: Optional[int] = None):
        self.prefix = prefix
        self.d_in = d_in
        self.use_feature_normalization = use_feature_normalization
        self.layers = (MLPLayer(f"{prefix}/MLPLayer_0", d_in, hidden_size, layer_N, use_relu),
                       MLPLayer(f"{prefix}/MLPLayer_1", hidden_size, hidden_size, layer_N,
                                use_relu, out_dim))
        self.d_out = self.layers[1].d_out

    def spec(self) -> List[ParamSpec]:
        out = layer_norm_spec(f"{self.prefix}/LayerNorm_0", self.d_in) \
            if self.use_feature_normalization else []
        return out + self.layers[0].spec() + self.layers[1].spec()

    def __call__(self, p, x):
        if self.use_feature_normalization:
            x = layer_norm(p, f"{self.prefix}/LayerNorm_0", x)
        return self.layers[1](p, self.layers[0](p, x))


class ParamGroup:
    """A spec laid out in one flat ``(S, P)`` tensor, sorted by name."""

    def __init__(self, spec: List[ParamSpec]):
        self.spec = sorted(spec, key=lambda s: s.name)
        names = [s.name for s in self.spec]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate parameter names in {names}")
        self.offsets: Dict[str, Tuple[int, int]] = {}
        self.sizes: List[int] = []
        off = 0
        for s in self.spec:
            n = math.prod(s.shape)
            self.offsets[s.name] = (off, n)
            self.sizes.append(n)
            off += n
        self.size = off

    def init(self, n_stack: int, generator: torch.Generator) -> torch.Tensor:
        """A fresh ``(n_stack, P)`` f32 tensor on the CPU: each stack row's
        kernels their own orthogonal draws from ``generator``."""
        flat = torch.zeros(n_stack, self.size)
        for row in range(n_stack):
            for s in self.spec:
                off, n = self.offsets[s.name]
                t = flat[row, off:off + n].view(s.shape)
                if s.init == "orthogonal":
                    w = torch.empty(s.shape)
                    nn.init.orthogonal_(w, s.value, generator=generator)
                    t.copy_(w)
                elif s.init == "ones":
                    t.fill_(1.0)
                elif s.init == "const":
                    t.fill_(s.value)
        return flat

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{name: (S, *shape) view of flat}``; gradients through the views
        land in ``flat``'s.  One ``split`` for all of them (its backward is one
        concatenation, where a slice a parameter would zero and copy the whole
        gradient each)."""
        S = flat.shape[0]
        parts = flat.split(self.sizes, dim=1)
        return {s.name: part.view(S, *s.shape) for s, part in zip(self.spec, parts)}

    def from_tree(self, leaves: Dict[str, torch.Tensor], n_stack: int) -> torch.Tensor:
        """The flat tensor of ``{name: (n_stack, *shape) or (*shape)}``
        values (a tree without a stack axis has one row)."""
        if set(leaves) != set(self.offsets):
            raise ValueError(f"parameters {sorted(set(leaves) ^ set(self.offsets))} do not "
                             "match the spec")
        flat = torch.empty(n_stack, self.size)
        for s in self.spec:
            off, n = self.offsets[s.name]
            v = torch.as_tensor(leaves[s.name], dtype=torch.float32)
            if v.dim() == len(s.shape):
                v = v.expand(n_stack, *s.shape)
            if tuple(v.shape) != (n_stack, *s.shape):
                raise ValueError(f"{s.name}: shape {tuple(v.shape)}, expected "
                                 f"{(n_stack, *s.shape)}")
            flat[:, off:off + n] = v.reshape(n_stack, n)
        return flat
