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

Two trunk types, as the TPU kernel computes in the dtype of the caches it is
given (``pallas_decode.py:429``): f32, and bf16 (``MATConfig(dtype=
"bfloat16")``).  In bf16 the trunk's matrices and ``obs_rep`` are bf16; the
biases, LayerNorm parameters, head, std, noise, avail and outputs stay f32.
The arithmetic is f32, rounded to bf16 where the TPU kernel rounds
(``_mm``, ``_gelu``, ``_layer_norm``; the bias rounded to bf16 and added
after the product's rounding; an attention's scores, softmax and P.V in f32,
its output rounded).

``fused_ar_decode`` takes the plain twin :func:`ar_decode_plain` for tensors
on the CPU and launches ``csrc/ar_decode.cu`` for tensors on a CUDA device,
its f32 or bf16 leg by the trunk's dtype; it never falls back from the
kernel and never casts.  ``launches`` counts kernel launches and nothing
else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mat_dcml_tpu_torch.models.modules import LN_EPS
from mat_dcml_tpu_torch.ops.cuda_attention import attention_plain
from mat_dcml_tpu_torch.ops.decode_plan import (
    DTYPE_CODE,
    ESIZE,
    TRUNK_FIELDS,
    Plan,
    bind,
    dtype_name,
    flat_of,
    launch_plan,
    pack_flat,
    units,
    weights_version,
    with_image,
)
from mat_dcml_tpu_torch.ops.distributions import LOG_2PI, MASK_VALUE

launches = 0
_limits: dict = {}


class ARDecodeWeights(NamedTuple):
    """Decoder weights packed for the whole decode, dense kernels as
    ``(in, out)`` (the flax layout): the trunk's matrices
    (``decode_plan.TRUNK_FIELDS``) in the trunk's dtype, every other field
    f32.  The kernel reads them as one flat buffer in this field order
    (``csrc/decode_layout.cuh::weight_layout``)."""

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
    the model's device, the trunk's matrices in its ``cfg.dtype`` (biases
    as they are, in f32: the kernel rounds them at use, as the TPU kernel
    does).  The action embedding is a no-bias dense over ``[start |
    one-hot]``: its first row is the start token's embedding and the rest
    the actions', so no shifted-action vector is ever built.  The fields
    are views into one flat buffer in the kernel's layout, so a launch
    reads them without a copy."""
    from mat_dcml_tpu_torch.models.mat import DISCRETE, SEMI_DISCRETE

    cfg = model.cfg
    if cfg.action_type not in (DISCRETE, SEMI_DISCRETE):
        raise NotImplementedError(
            f"the whole decode packs the discrete families only, not {cfg.action_type!r}; "
            "the continuous ones decode a position a launch (ops/decode_step.py)"
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
        return ARDecodeWeights(*pack_flat(packed, ARDecodeWeights._fields, cfg.trunk_dtype))


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------

def _rnd(x, dt):
    """``x`` rounded to the trunk type ``dt``, kept as f32 values (the
    identity in f32)."""
    return x if dt == torch.float32 else x.to(dt).float()


def _dense(x, w, b, dt):
    """``x . w + b`` as the TPU kernel's ``_mm(x, w) + b`` computes it: an
    f32 sum of the products, rounded to ``dt``, then the bias rounded to
    ``dt`` and added, rounded again.  ``x`` f32 values of ``dt``."""
    if dt == torch.float32:
        return torch.addmm(b, x, w)
    return _rnd(_rnd(x @ w.float(), dt) + _rnd(b, dt), dt)


def _ln(x, scale_bias, dt=torch.float32):
    return _rnd(F.layer_norm(x, x.shape[-1:], scale_bias[0], scale_bias[1], eps=LN_EPS), dt)


def _attend(q, k_cache, v_cache, k, v, i, valid, n_head, dt=torch.float32):
    """Write ``k``, ``v`` (B, D) at position ``i`` of the head-split caches
    ``(B, H, A, Dh)``, then attend the query ``q`` (B, D) over positions
    ``<= i``; returns ``(B, D)``.  Scores, softmax and P.V in f32 (on the
    caches widened), the output rounded to ``dt``, as the TPU kernel's
    ``_cached_attention`` does."""
    k_cache[:, :, i] = k.reshape(k.shape[0], n_head, -1)
    v_cache[:, :, i] = v.reshape(v.shape[0], n_head, -1)
    out = attention_plain(q.reshape(q.shape[0], n_head, 1, -1), k_cache.float(),
                          v_cache.float(), kv_mask=valid)
    return _rnd(out.reshape(q.shape), dt)


def _block(w, b, x, rep, caches, i, valid, n_head, dt=torch.float32):
    """One decoder block at position ``i`` (``DecodeBlock.decode_step``):
    causal self-attention over the action stream, cross-attention whose
    query is the encoder's ``rep`` and whose keys and values come from the
    post-LN1 stream, then the MLP; rounded to ``dt`` where the TPU kernel's
    ``_decoder_block_body`` rounds.  ``w``'s fields f32 values."""
    D = x.shape[-1]
    w1, b1 = w.block_qkvp1_w[b], w.block_qkvp1_b[b]
    w2, b2 = w.block_qkvp2_w[b], w.block_qkvp2_b[b]
    lns = w.block_lns[b]
    qkv = _dense(x, w1[:, :3 * D], b1[:3 * D], dt)
    y = _attend(qkv[:, :D], caches[0], caches[1], qkv[:, D:2 * D], qkv[:, 2 * D:], i, valid,
                n_head, dt)
    h = _ln(_rnd(x + _dense(y, w1[:, 3 * D:], b1[3 * D:], dt), dt), lns[0:2], dt)
    q2 = _dense(rep, w2[:, :D], b2[:D], dt)
    kv2 = _dense(h, w2[:, D:3 * D], b2[D:3 * D], dt)
    y2 = _attend(q2, caches[2], caches[3], kv2[:, :D], kv2[:, D:], i, valid, n_head, dt)
    h2 = _ln(_rnd(rep + _dense(y2, w2[:, 3 * D:], b2[3 * D:], dt), dt), lns[2:4], dt)
    m = _rnd(F.gelu(_dense(h2, w.block_mlp_w1[b], w.block_mlp_b1[b], dt)), dt)
    m = _dense(m, w.block_mlp_w2[b], w.block_mlp_b2[b], dt)
    return _ln(_rnd(h2 + m, dt), lns[4:6], dt)


def _head(w, x):
    """The f32 head: ``(B, D)`` -> ``(B, adim)`` logits."""
    t = _ln(F.gelu(torch.addmm(w.head_b1, x, w.head_w1)), w.head_ln)
    return torch.addmm(w.head_b2, t, w.head_w2)


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
    the discrete one-hot even after a tail agent, as in the JAX decode.  The
    trunk runs in ``obs_rep``'s dtype (f32 or bf16), rounded as the kernel
    rounds (module docstring).
    """
    dt = obs_rep.dtype
    w = ARDecodeWeights(*(t.float() for t in weights))   # bf16 widens exactly
    obs_rep = obs_rep.float()
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
        x = _ln(_rnd(F.gelu(pre), dt), w.ln0, dt)
        rep = obs_rep[:, i]
        for b in range(n_block):
            x = _block(w, b, x, rep, caches[b], i, valid, n_head, dt)
        logits = _head(w, x)
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

    return bind_library(kernel_lib.load("ar_decode"))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points of a library built from ``csrc/ar_decode.cu``
    (or a source that includes it); returns ``lib``."""
    if getattr(lib, "_mat_typed", False):
        return lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mat_ar_decode.argtypes = [ptr] * 8 + [i32] * 9 + [ptr]
    lib.mat_ar_decode.restype = i32   # cudaError_t
    bind(lib)
    for name in ("max_d", "max_a", "max_heads", "max_adim"):
        getattr(lib, f"mat_ar_decode_{name}").restype = i32
    lib._mat_typed = True
    return lib


def kernel_plan(B: int, A: int, *, n_embd: int, n_head: int, n_block: int, adim: int,
                dtype=torch.float32) -> Plan:
    """The launch plan the compiled kernel takes for a decode of B rows
    over A agents at these widths, with a trunk of ``dtype``; building it if
    need be."""
    return launch_plan(_library(), "ar_decode", B, n_embd=n_embd, n_head=n_head,
                       n_block=n_block, adim=adim, n_pos=A, esize=ESIZE[dtype_name(dtype)])


def kernel_limits() -> dict:
    """``{"d", "a", "heads", "adim"}``: the largest n_embd, agent count, head
    count and action width the compiled kernel holds; building it if need be."""
    if not _limits:
        lib = _library()
        _limits.update({k: getattr(lib, f"mat_ar_decode_max_{k}")()
                        for k in ("d", "a", "heads", "adim")})
    return _limits


def _check_inputs(weights, obs_rep, gumbel, normal_rows, avail, n_head, adim, nd):
    """Shapes, dtypes and device of one call; returns ``n_rows``.  The trunk
    is ``obs_rep``'s dtype, f32 or bf16: the trunk's matrices must share
    it, and every other tensor is f32."""
    if obs_rep.dim() != 3:
        raise ValueError(f"obs_rep must be (B, A, D), got {tuple(obs_rep.shape)}")
    B, A, D = obs_rep.shape
    dev = obs_rep.device
    trunk = obs_rep.dtype
    dtype_name(trunk)
    tensors = [("gumbel", gumbel), ("normal_rows", normal_rows)]
    tensors += [] if avail is None else [("avail", avail)]
    tensors += list(zip(ARDecodeWeights._fields, weights))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, obs_rep on {dev}: one device for all")
        want = trunk if name in TRUNK_FIELDS else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}, not {want}: with a {trunk} obs_rep the "
                             f"trunk's matrices are {trunk}, every other input f32")
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

    Inputs as :func:`ar_decode_plain`; the trunk is ``obs_rep``'s dtype (f32
    or bf16).  On the CPU it is the plain twin; on a CUDA device it launches
    the leg of ``csrc/ar_decode.cu`` of that dtype (a cluster of 4 CTAs per
    ``plan.rows`` batch rows, looping over the positions; the plan is
    :func:`kernel_plan`) or raises.
    """
    global launches
    n_rows = _check_inputs(weights, obs_rep, gumbel, normal_rows, avail, n_head, adim, nd)
    if obs_rep.device.type == "cpu":
        return ar_decode_plain(weights, obs_rep, gumbel, normal_rows, avail,
                               n_head=n_head, adim=adim, nd=nd)
    if obs_rep.device.type != "cuda":
        raise ValueError(f"fused_ar_decode runs on cpu or cuda, got {obs_rep.device}")
    B, A, D = obs_rep.shape
    lim = kernel_limits()
    for what, value, most in (("n_embd", D, lim["d"]), ("agents", A, lim["a"]),
                              ("heads", n_head, lim["heads"]), ("action_dim", adim, lim["adim"])):
        if value > most:
            raise ValueError(f"ar_decode holds at most {most} {what}, got {value}")
    inputs = [obs_rep, gumbel, normal_rows] + ([] if avail is None else [avail])
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("obs_rep, gumbel, normal_rows and avail must be contiguous")
    if obs_rep.dtype == torch.bfloat16 and D % 2:
        raise ValueError(f"the bf16 whole decode takes an even n_embd, got {D}")
    out = launch(_library(), weights, obs_rep, gumbel, normal_rows, avail, n_rows,
                 n_head=n_head, adim=adim, nd=nd)
    launches += 1
    return out


def launch(lib, weights, obs_rep, gumbel, normal_rows, avail, n_rows, *, n_head, adim, nd):
    """One launch of ``mat_ar_decode`` from ``lib`` on checked inputs: the
    flat weights (and on the on-chip path their image), the workspace, the
    outputs.  The workspace holds the cross-attention queries (``B *
    n_block * A * D`` f32) and the K/V caches (four times as many values of
    the trunk type); it is left unzeroed: the kernel writes every slot
    before it reads it."""
    B, A, D = obs_rep.shape
    dt = obs_rep.dtype
    esize = ESIZE[dtype_name(dt)]
    n_block = weights.block_qkvp1_w.shape[0]
    count = lib.mat_decode_weight_bytes(1, 0, D, n_block, adim, esize)
    flat = flat_of(weights, dt, count)
    plan = launch_plan(lib, "ar_decode", B, n_embd=D, n_head=n_head, n_block=n_block, adim=adim,
                       n_pos=A, esize=esize)
    if plan.on_chip:
        flat = with_image(units(flat, esize), lib, "ar_decode", plan, n_embd=D, n_block=n_block,
                          adim=adim, version=weights_version(weights))
    act = torch.empty(B, A, device=obs_rep.device)
    logp = torch.empty(B, A, device=obs_rep.device)
    # the (B, n_block, A, D) f32 cross queries, then the (B, n_block, 4, A,
    # D) caches; never read before the kernel writes it (csrc/ar_decode.cu)
    cells = B * n_block * A * D
    workspace = torch.empty(4 * cells + 4 * esize * cells, dtype=torch.uint8,
                            device=obs_rep.device)
    with torch.cuda.device(obs_rep.device):
        rc = lib.mat_ar_decode(
            obs_rep.data_ptr(), gumbel.data_ptr(), normal_rows.data_ptr(),
            None if avail is None else avail.data_ptr(), flat.data_ptr(), workspace.data_ptr(),
            act.data_ptr(), logp.data_ptr(), B, A, D, n_head, n_block, adim, nd, n_rows,
            DTYPE_CODE[dtype_name(dt)], torch.cuda.current_stream(obs_rep.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ar_decode launch failed: cudaError {rc}")
    return act, logp
