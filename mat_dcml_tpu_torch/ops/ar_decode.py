"""The whole autoregressive decode in one launch: weight packing, the CUDA
kernel's wrapper and its plain twin.

Port of ``mat_dcml_tpu/ops/pallas_decode.py::fused_ar_decode`` (and
``pack_ar_decode_weights``) for the discrete and semi-discrete families.  All
A positions of the decode run in one call, sampling included: embed the
previous action, ``n_block`` decoder blocks against per-block K/V caches, the
f32 head, availability masking, the Gumbel-argmax draw and its log-prob, and
for agents ``>= nd`` the Gaussian tail.  The Mosaic artifacts of the TPU
kernel (128-lane action padding, the padding-lane kill value, 8-position
chunks, batch tiles, the polynomial erf) have no counterpart here.

``fused_ar_decode`` takes the plain twin :func:`ar_decode_plain` for tensors
on the CPU and launches ``csrc/ar_decode.cu`` for tensors on a CUDA device;
it never falls back from the kernel.  ``launches`` counts kernel launches and
nothing else.  The kernel runs in f32 only: the port's trunk is f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mat_dcml_tpu_torch.models.modules import LN_EPS
from mat_dcml_tpu_torch.ops.cuda_attention import attention_plain
from mat_dcml_tpu_torch.ops.distributions import LOG_2PI, MASK_VALUE

launches = 0
_limits: dict = {}


class ARDecodeWeights(NamedTuple):
    """Decoder weights packed for the whole decode, dense kernels as
    ``(in, out)`` (the flax layout).  The kernel reads them as one flat f32
    buffer in this field order (``csrc/ar_decode.cu::weight_layout``)."""

    embed_start: torch.Tensor    # (1, D) embedding of the start token
    embed_act: torch.Tensor      # (adim, D) row a = embedding of one-hot action a
    ln0: torch.Tensor            # (2, D) scale; bias of the post-embed LN
    block_qkvp1_w: torch.Tensor  # (n_block, D, 4D) [q|k|v|proj] of the self-attention
    block_qkvp1_b: torch.Tensor  # (n_block, 4D)
    block_qkvp2_w: torch.Tensor  # (n_block, D, 4D) of the cross-attention
    block_qkvp2_b: torch.Tensor  # (n_block, 4D)
    block_mlp_w1: torch.Tensor   # (n_block, D, D)
    block_mlp_b1: torch.Tensor   # (n_block, D)
    block_mlp_w2: torch.Tensor   # (n_block, D, D)
    block_mlp_b2: torch.Tensor   # (n_block, D)
    block_lns: torch.Tensor      # (n_block, 6, D) ln1 s, b, ln2 s, b, ln3 s, b
    head_w1: torch.Tensor        # (D, D)
    head_b1: torch.Tensor        # (D,)
    head_ln: torch.Tensor        # (2, D)
    head_w2: torch.Tensor        # (D, adim)
    head_b2: torch.Tensor        # (adim,)
    std_row: torch.Tensor        # (1, adim) action std (ones when discrete)


def pack_ar_decode_weights(model) -> ARDecodeWeights:
    """The port's ``MultiAgentTransformer`` -> :class:`ARDecodeWeights`, on
    the model's device.  The action embedding is a no-bias dense over
    ``[start | one-hot]``: its first row is the start token's embedding and
    the rest the actions', so no shifted-action vector is ever built."""
    from mat_dcml_tpu_torch.models.mat import DISCRETE, SEMI_DISCRETE

    cfg = model.cfg
    if cfg.action_type not in (DISCRETE, SEMI_DISCRETE):
        raise NotImplementedError(
            f"the whole decode packs the discrete families only, not {cfg.action_type!r} "
            "(ROADMAP.md queue 2, item 2)"
        )
    dec = model.decoder

    def kernel(dense):                 # torch (out, in) -> (in, out)
        return dense.weight.t()

    def attn(a):
        parts = (a.query_p, a.key_p, a.value_p, a.proj)
        return (torch.cat([kernel(p) for p in parts], dim=1),
                torch.cat([p.bias for p in parts]))

    def ln(m):
        return torch.stack([m.weight, m.bias])

    with torch.no_grad():
        emb = kernel(dec.action_encoder_nobias)                    # (1 + adim, D)
        a1 = [attn(blk.attn1) for blk in dec.blocks]
        a2 = [attn(blk.attn2) for blk in dec.blocks]
        head = dec.head
        if cfg.action_type == DISCRETE:
            std = torch.ones(1, cfg.action_dim, device=emb.device)
        else:
            std = model.action_std().float()[None]
        packed = ARDecodeWeights(
            embed_start=emb[:1],
            embed_act=emb[1:],
            ln0=ln(dec.ln),
            block_qkvp1_w=torch.stack([w for w, _ in a1]),
            block_qkvp1_b=torch.stack([b for _, b in a1]),
            block_qkvp2_w=torch.stack([w for w, _ in a2]),
            block_qkvp2_b=torch.stack([b for _, b in a2]),
            block_mlp_w1=torch.stack([kernel(blk.mlp.Dense_0) for blk in dec.blocks]),
            block_mlp_b1=torch.stack([blk.mlp.Dense_0.bias for blk in dec.blocks]),
            block_mlp_w2=torch.stack([kernel(blk.mlp.Dense_1) for blk in dec.blocks]),
            block_mlp_b2=torch.stack([blk.mlp.Dense_1.bias for blk in dec.blocks]),
            block_lns=torch.stack([torch.cat([ln(blk.ln1), ln(blk.ln2), ln(blk.ln3)])
                                   for blk in dec.blocks]),
            head_w1=kernel(head.Dense_0),
            head_b1=head.Dense_0.bias,
            head_ln=ln(head.LayerNorm_0),
            head_w2=kernel(head.Dense_1),
            head_b2=head.Dense_1.bias,
            std_row=std,
        )
        return ARDecodeWeights(*(t.detach().contiguous() for t in packed))


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------

def _ln(x, scale_bias):
    return F.layer_norm(x, x.shape[-1:], scale_bias[0], scale_bias[1], eps=LN_EPS)


def _attend(q, k_cache, v_cache, k, v, i, valid, n_head):
    """Write ``k``, ``v`` (B, D) at position ``i`` of the head-split caches
    ``(B, H, A, Dh)``, then attend the query ``q`` (B, D) over positions
    ``<= i``; returns ``(B, D)``."""
    k_cache[:, :, i] = k.reshape(k.shape[0], n_head, -1)
    v_cache[:, :, i] = v.reshape(v.shape[0], n_head, -1)
    out = attention_plain(q.reshape(q.shape[0], n_head, 1, -1), k_cache, v_cache, kv_mask=valid)
    return out.reshape(q.shape)


def _block(w, b, x, rep, caches, i, valid, n_head):
    """One decoder block at position ``i`` (``DecodeBlock.decode_step``):
    causal self-attention over the action stream, cross-attention whose
    query is the encoder's ``rep`` and whose keys and values come from the
    post-LN1 stream, then the MLP."""
    D = x.shape[-1]
    w1, b1 = w.block_qkvp1_w[b], w.block_qkvp1_b[b]
    w2, b2 = w.block_qkvp2_w[b], w.block_qkvp2_b[b]
    lns = w.block_lns[b]
    qkv = torch.addmm(b1[:3 * D], x, w1[:, :3 * D])
    y = _attend(qkv[:, :D], caches[0], caches[1], qkv[:, D:2 * D], qkv[:, 2 * D:], i, valid,
                n_head)
    h = _ln(x + torch.addmm(b1[3 * D:], y, w1[:, 3 * D:]), lns[0:2])
    q2 = torch.addmm(b2[:D], rep, w2[:, :D])
    kv2 = torch.addmm(b2[D:3 * D], h, w2[:, D:3 * D])
    y2 = _attend(q2, caches[2], caches[3], kv2[:, :D], kv2[:, D:], i, valid, n_head)
    h2 = _ln(rep + torch.addmm(b2[3 * D:], y2, w2[:, 3 * D:]), lns[2:4])
    m = F.gelu(torch.addmm(w.block_mlp_b1[b], h2, w.block_mlp_w1[b]))
    m = torch.addmm(w.block_mlp_b2[b], m, w.block_mlp_w2[b])
    return _ln(h2 + m, lns[4:6])


def ar_decode_plain(
    weights: ARDecodeWeights,
    obs_rep: torch.Tensor,
    gumbel: torch.Tensor,
    normal_rows: torch.Tensor,
    avail: torch.Tensor | None,
    *,
    n_head: int,
    adim: int,
    nd: int,
    return_scores: bool = False,
):
    """The kernel's arithmetic in plain PyTorch, a Python loop over the A
    positions, batched over B.

    ``obs_rep (B, A, D)``; ``gumbel (B, A, adim)`` (zeros for a
    deterministic decode); ``normal_rows (B, n_rows, adim)``, row ``i - nd``
    the tail noise of agent ``i >= nd``; ``avail (B, A, adim)`` or None (all
    available).  Returns ``(action (B, A), log_prob (B, A))``, and with
    ``return_scores`` also the ``(B, A, adim)`` masked logits plus noise that
    each draw took the argmax of (for telling a near-tie from a fault).

    Per position: the start row (i = 0) or the previous one-hot action's row,
    exact-erf GELU and LN; the blocks; the f32 head; unavailable actions
    masked to -1e10; ``argmax(masked + gumbel)`` (lowest index on ties) and
    its log-softmax log-prob; for ``i >= nd`` the Gaussian tail (mean = the
    last logit, std = the last std entry) replaces both.  The next feed is
    the discrete one-hot even after a tail agent, as in the JAX decode.
    """
    w = weights
    B, A, D = obs_rep.shape
    dev = obs_rep.device
    n_block = w.block_qkvp1_w.shape[0]
    # per block: k1, v1, k2, v2, head-split (B, H, A, Dh); positions > i stay
    # masked, so zeros there are never weighted
    caches = torch.zeros(n_block, 4, B, n_head, A, D // n_head, device=dev)
    positions = torch.arange(A, device=dev)
    c_std = w.std_row[0, adim - 1]
    acts, logps, scores = [], [], []
    pre = w.embed_start.expand(B, D)
    for i in range(A):
        valid = positions <= i
        x = _ln(F.gelu(pre), w.ln0)
        rep = obs_rep[:, i]
        for b in range(n_block):
            x = _block(w, b, x, rep, caches[b], i, valid, n_head)
        t = _ln(F.gelu(torch.addmm(w.head_b1, x, w.head_w1)), w.head_ln)
        logits = torch.addmm(w.head_b2, t, w.head_w2)
        masked = logits if avail is None else torch.where(avail[:, i] == 0, MASK_VALUE, logits)
        score = masked + gumbel[:, i]
        idx = torch.argmax(score, dim=-1)
        logp = torch.log_softmax(masked, dim=-1).gather(-1, idx[:, None])[:, 0]
        act = idx.float()
        if i >= nd:
            mean = logits[:, adim - 1]
            act = mean + c_std * normal_rows[:, i - nd, adim - 1]
            logp = (-((act - mean) ** 2) / (2 * c_std * c_std) - torch.log(c_std)
                    - 0.5 * LOG_2PI)
        acts.append(act)
        logps.append(logp)
        scores.append(score)
        pre = w.embed_act[idx]
    out = (torch.stack(acts, dim=1), torch.stack(logps, dim=1))
    return out + (torch.stack(scores, dim=1),) if return_scores else out


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    from mat_dcml_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load("ar_decode")
    if getattr(lib, "_mat_typed", False):
        return lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mat_ar_decode.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
    lib.mat_ar_decode.restype = i32   # cudaError_t
    lib.mat_ar_decode_weight_count.argtypes = [i32] * 3
    lib.mat_ar_decode_weight_count.restype = ctypes.c_longlong
    for name in ("max_d", "max_a", "max_heads", "max_adim"):
        getattr(lib, f"mat_ar_decode_{name}").restype = i32
    lib._mat_typed = True
    return lib


def kernel_limits() -> dict:
    """``{"d", "a", "heads", "adim"}``: the largest n_embd, agent count, head
    count and action width the compiled kernel holds; building it if need be."""
    if not _limits:
        lib = _library()
        _limits.update({k: getattr(lib, f"mat_ar_decode_max_{k}")()
                        for k in ("d", "a", "heads", "adim")})
    return _limits


def _check_inputs(weights, obs_rep, gumbel, normal_rows, avail, n_head, adim, nd):
    """Shapes, dtype and device of one call; returns ``n_rows``."""
    if obs_rep.dim() != 3:
        raise ValueError(f"obs_rep must be (B, A, D), got {tuple(obs_rep.shape)}")
    B, A, D = obs_rep.shape
    dev = obs_rep.device
    tensors = [("obs_rep", obs_rep), ("gumbel", gumbel), ("normal_rows", normal_rows)]
    tensors += [] if avail is None else [("avail", avail)]
    tensors += list(zip(ARDecodeWeights._fields, weights))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, obs_rep on {dev}: one device for all")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: the whole decode runs in f32 only "
                             "(a bf16 trunk is ROADMAP.md queue 1, item 3)")
    if gumbel.shape != (B, A, adim):
        raise ValueError(f"gumbel must be {(B, A, adim)}, got {tuple(gumbel.shape)}")
    if avail is not None and avail.shape != (B, A, adim):
        raise ValueError(f"avail must be {(B, A, adim)}, got {tuple(avail.shape)}")
    if not 0 <= nd <= A:
        raise ValueError(f"nd must lie in [0, {A}], got {nd}")
    n_rows = normal_rows.shape[1] if normal_rows.dim() == 3 else 0
    if normal_rows.dim() != 3 or normal_rows.shape[::2] != (B, adim) or n_rows < max(1, A - nd):
        raise ValueError(f"normal_rows must be ({B}, >= {max(1, A - nd)}, {adim}), "
                         f"got {tuple(normal_rows.shape)}")
    if n_head < 1 or D % n_head:
        raise ValueError(f"n_embd {D} is not a multiple of n_head {n_head}")
    n_block = weights.block_qkvp1_w.shape[0]
    want = {"embed_start": (1, D), "embed_act": (adim, D), "block_qkvp1_w": (n_block, D, 4 * D),
            "head_w2": (D, adim), "std_row": (1, adim)}
    for name, shape in want.items():
        if getattr(weights, name).shape != shape:
            raise ValueError(f"weights.{name} must be {shape}, got "
                             f"{tuple(getattr(weights, name).shape)}")
    return n_rows


def fused_ar_decode(
    weights: ARDecodeWeights,
    obs_rep: torch.Tensor,
    gumbel: torch.Tensor,
    normal_rows: torch.Tensor,
    avail: torch.Tensor | None,
    *,
    n_head: int,
    adim: int,
    nd: int,
):
    """The whole decode: ``(action (B, A), log_prob (B, A))``, f32.

    Inputs as :func:`ar_decode_plain`.  On the CPU it is the plain twin; on a
    CUDA device it launches ``csrc/ar_decode.cu`` (one block per batch row,
    looping over the positions) or raises.  The K/V caches live in a
    device-memory workspace of ``B * n_block * 4 * A * D`` f32 that this call
    allocates.
    """
    global launches
    n_rows = _check_inputs(weights, obs_rep, gumbel, normal_rows, avail, n_head, adim, nd)
    if obs_rep.device.type == "cpu":
        return ar_decode_plain(weights, obs_rep, gumbel, normal_rows, avail,
                               n_head=n_head, adim=adim, nd=nd)
    if obs_rep.device.type != "cuda":
        raise ValueError(f"fused_ar_decode runs on cpu or cuda, got {obs_rep.device}")
    B, A, D = obs_rep.shape
    n_block = weights.block_qkvp1_w.shape[0]
    lim = kernel_limits()
    for what, value, most in (("n_embd", D, lim["d"]), ("agents", A, lim["a"]),
                              ("heads", n_head, lim["heads"]), ("action_dim", adim, lim["adim"])):
        if value > most:
            raise ValueError(f"ar_decode holds at most {most} {what}, got {value}")
    inputs = [obs_rep, gumbel, normal_rows] + ([] if avail is None else [avail])
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("obs_rep, gumbel, normal_rows and avail must be contiguous")
    lib = _library()
    flat = torch.cat([t.reshape(-1) for t in weights])
    if flat.numel() != lib.mat_ar_decode_weight_count(D, n_block, adim):
        raise ValueError(f"packed weights hold {flat.numel()} values, the kernel's layout "
                         f"{lib.mat_ar_decode_weight_count(D, n_block, adim)}")
    act = torch.empty(B, A, device=obs_rep.device)
    logp = torch.empty(B, A, device=obs_rep.device)
    cache = torch.zeros(B, n_block, 4, A, D, device=obs_rep.device)
    with torch.cuda.device(obs_rep.device):
        rc = lib.mat_ar_decode(
            obs_rep.data_ptr(), gumbel.data_ptr(), normal_rows.data_ptr(),
            None if avail is None else avail.data_ptr(), flat.data_ptr(), cache.data_ptr(),
            act.data_ptr(), logp.data_ptr(), B, A, D, n_head, n_block, adim, nd, n_rows,
            torch.cuda.current_stream(obs_rep.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ar_decode launch failed: cudaError {rc}")
    launches += 1
    return act, logp

