"""One decode position in one launch: weight packing, the CUDA kernel's
wrapper and its plain twin.

Port of ``mat_dcml_tpu/ops/pallas_decode.py::fused_decode_step`` (and
``pack_decode_weights``).  One position of the exact decode, forward only:
embed the position's input ``x_in`` (the previous agent's action, or the
start token), GELU, LN; ``n_block`` decoder blocks, each writing position
``i``'s self- and cross-attention K/V into its caches and attending over
positions ``0 .. i``; the f32 head.  Sampling happens outside, between
launches: the continuous action families' exact decode
(``models/decode.py::ar_decode``) calls it once per position.

Dropped from the TPU kernel: the Mosaic padding of the weights
(``in_dim_pad = max(8, in_dim)`` rows of the embedding, ``adim_pad = max(128,
adim)`` head columns), the batch tiling, and the copy-forward of every cache
tile that aliasing the caches in and out needs (``pallas_decode.py:285-288``):
here the caches are updated in place in one workspace that the caller
allocates once per decode (:func:`decode_caches`).

Two trunk types, as in ``ops/ar_decode.py``: f32 and bf16.  In bf16
``x_in``, ``rep_i``, the caches and the trunk's matrices are bf16; the biases,
LayerNorm parameters, head and logits stay f32, and the arithmetic rounds to
bf16 where the TPU kernel rounds.

``fused_decode_step`` takes the plain twin :func:`decode_step_plain` for
tensors on the CPU and launches ``csrc/decode_step.cu`` for tensors on a CUDA
device, its f32 or bf16 leg by the trunk's dtype; it never falls back from
the kernel and never casts.  ``launches`` counts kernel launches and nothing
else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mat_dcml_tpu_torch.ops.ar_decode import _block, _dense, _head, _ln, _rnd
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

launches = 0
_limits: dict = {}


class DecodeStepWeights(NamedTuple):
    """Decoder weights packed for one decode position, dense kernels as
    ``(in, out)`` (the flax layout), unpadded: the trunk's matrices
    (``decode_plan.TRUNK_FIELDS``) in the trunk's dtype, every other field
    f32.  The kernel reads them as one flat buffer in this field order
    (``csrc/decode_layout.cuh::weight_layout``)."""

    embed_w: torch.Tensor        # (in_dim, D) action embedding
    embed_b: torch.Tensor        # (D,) its bias
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


def pack_decode_weights(model) -> DecodeStepWeights:
    """The port's ``MultiAgentTransformer`` of a continuous family ->
    :class:`DecodeStepWeights` on the model's device (the embedding is its
    ``action_encoder_bias``), the trunk's matrices in its ``cfg.dtype``.  The
    fields are views into one flat buffer in the kernel's layout, so a
    launch reads them without a copy."""
    dec = model.decoder
    if not hasattr(dec, "action_encoder_bias"):
        raise NotImplementedError(
            f"the decode step packs the continuous families, not {model.cfg.action_type!r}: "
            "the discrete ones decode whole (ops/ar_decode.py)")

    def kernel(dense):                 # torch (out, in) -> (in, out)
        return dense.weight.t()

    def attn(a):
        parts = (a.query_p, a.key_p, a.value_p, a.proj)
        return (torch.cat([kernel(p) for p in parts], dim=1),
                torch.cat([p.bias for p in parts]))

    def ln(m):
        return torch.stack([m.weight, m.bias])

    with torch.no_grad():
        a1 = [attn(blk.attn1) for blk in dec.blocks]
        a2 = [attn(blk.attn2) for blk in dec.blocks]
        head = dec.head
        fields = (
            kernel(dec.action_encoder_bias), dec.action_encoder_bias.bias, ln(dec.ln),
            torch.stack([w for w, _ in a1]), torch.stack([b for _, b in a1]),
            torch.stack([w for w, _ in a2]), torch.stack([b for _, b in a2]),
            torch.stack([kernel(blk.mlp.Dense_0) for blk in dec.blocks]),
            torch.stack([blk.mlp.Dense_0.bias for blk in dec.blocks]),
            torch.stack([kernel(blk.mlp.Dense_1) for blk in dec.blocks]),
            torch.stack([blk.mlp.Dense_1.bias for blk in dec.blocks]),
            torch.stack([torch.cat([ln(blk.ln1), ln(blk.ln2), ln(blk.ln3)])
                         for blk in dec.blocks]),
            kernel(head.Dense_0), head.Dense_0.bias, ln(head.LayerNorm_0),
            kernel(head.Dense_1), head.Dense_1.bias,
        )
        return DecodeStepWeights(*pack_flat(fields, DecodeStepWeights._fields,
                                            model.cfg.trunk_dtype))


def decode_caches(n_block: int, length: int, batch: int, n_embd: int, device,
                  dtype=torch.float32) -> torch.Tensor:
    """The zeroed K/V workspace of one decode: ``(4 * n_block, L, B, D)`` of
    the trunk's ``dtype``, cache ``4 b + c`` being block b's k1, v1, k2, v2,
    indexed position-major as the TPU kernel's caches are.  It is stored
    batch-major (each row's positions contiguous), so a kernel block reads
    its row's keys as one run."""
    return torch.zeros(4 * n_block, batch, length, n_embd, device=device,
                       dtype=dtype).transpose(1, 2)


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------

def decode_step_plain(weights: DecodeStepWeights, x_in: torch.Tensor, rep_i: torch.Tensor,
                      caches: torch.Tensor, i: int, *, n_head: int, adim: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, batched over B.

    ``x_in (B, in_dim)``, ``rep_i (B, D)``, ``caches (4 * n_block, L, B, D)``
    (written in place at position ``i``), all of the trunk's dtype (f32 or
    bf16).  Returns the ``(B, adim)`` f32 logits (``adim``, the head's width,
    is checked by the wrapper).  The blocks are the whole decode's
    (``ar_decode._block``), on head-split views of the caches, rounded as
    the kernel rounds."""
    dt = rep_i.dtype
    w = DecodeStepWeights(*(t.float() for t in weights))   # bf16 widens exactly
    L, B, D = caches.shape[1:]
    n_block = w.block_qkvp1_w.shape[0]
    valid = torch.arange(L, device=caches.device) <= i
    # (4 n_block, L, B, D) -> per block (4, B, H, L, Dh) views of the same memory
    heads = caches.unflatten(-1, (n_head, D // n_head)).permute(0, 2, 3, 1, 4)
    x = _ln(_rnd(F.gelu(_dense(x_in.float(), w.embed_w, w.embed_b, dt)), dt), w.ln0, dt)
    rep = rep_i.float()
    for b in range(n_block):
        x = _block(w, b, x, rep, heads[4 * b:4 * b + 4], i, valid, n_head, dt)
    return _head(w, x)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    from mat_dcml_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load("decode_step")
    if getattr(lib, "_mat_typed", False):
        return lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mat_decode_step.argtypes = ([ptr, i64, ptr, i64, ptr, ptr, i64, i64, i64, ptr]
                                    + [i32] * 9 + [ptr])
    lib.mat_decode_step.restype = i32   # cudaError_t
    bind(lib)
    for name in ("d", "l", "heads", "in", "adim"):
        getattr(lib, f"mat_decode_step_max_{name}").restype = i32
    lib._mat_typed = True
    return lib


def kernel_plan(B: int, L: int, in_dim: int, *, n_embd: int, n_head: int, n_block: int,
                adim: int, dtype=torch.float32) -> Plan:
    """The launch plan the compiled kernel takes for B rows with caches of
    L positions at these widths, with a trunk of ``dtype``; building it if
    need be."""
    return launch_plan(_library(), "decode_step", B, n_embd=n_embd, n_head=n_head,
                       n_block=n_block, adim=adim, n_pos=L, in_dim=in_dim,
                       esize=ESIZE[dtype_name(dtype)])


def kernel_limits() -> dict:
    """``{"d", "l", "heads", "in", "adim"}``: the largest n_embd, cache
    length, head count, input width and action width the compiled kernel
    holds; building it if need be."""
    if not _limits:
        lib = _library()
        _limits.update({k: getattr(lib, f"mat_decode_step_max_{k}")()
                        for k in ("d", "l", "heads", "in", "adim")})
    return _limits


def _check_inputs(weights, x_in, rep_i, caches, i, n_head, adim):
    if x_in.dim() != 2 or rep_i.dim() != 2 or caches.dim() != 4:
        raise ValueError(f"x_in must be (B, in_dim), rep_i (B, D), caches (4 n_block, L, B, D); "
                         f"got {tuple(x_in.shape)}, {tuple(rep_i.shape)}, {tuple(caches.shape)}")
    B, D = rep_i.shape
    n_block = weights.block_qkvp1_w.shape[0]
    in_dim = x_in.shape[1]
    dev = rep_i.device
    trunk = rep_i.dtype
    dtype_name(trunk)
    for name, t in [("x_in", x_in), ("caches", caches)] + list(
            zip(DecodeStepWeights._fields, weights)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rep_i on {dev}: one device for all")
        want = trunk if name in TRUNK_FIELDS or name in ("x_in", "caches") else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}, not {want}: with a {trunk} rep_i, x_in, the "
                             f"caches and the trunk's matrices are {trunk}, the rest f32")
    if x_in.shape[0] != B or caches.shape[0] != 4 * n_block or caches.shape[2:] != (B, D):
        raise ValueError(f"x_in {tuple(x_in.shape)} and caches {tuple(caches.shape)} do not fit "
                         f"rep_i {tuple(rep_i.shape)} and {n_block} blocks")
    if not 0 <= i < caches.shape[1]:
        raise ValueError(f"position {i} is outside the caches' {caches.shape[1]} positions")
    if n_head < 1 or D % n_head:
        raise ValueError(f"n_embd {D} is not a multiple of n_head {n_head}")
    want = {"embed_w": (in_dim, D), "embed_b": (D,), "block_qkvp1_w": (n_block, D, 4 * D),
            "head_w2": (D, adim), "head_b2": (adim,)}
    for name, shape in want.items():
        if getattr(weights, name).shape != shape:
            raise ValueError(f"weights.{name} must be {shape}, got "
                             f"{tuple(getattr(weights, name).shape)}")


def fused_decode_step(weights: DecodeStepWeights, x_in: torch.Tensor, rep_i: torch.Tensor,
                      caches: torch.Tensor, i: int, *, n_head: int, adim: int) -> torch.Tensor:
    """One decode position: ``(B, adim)`` f32 logits, with position ``i``'s
    K/V written into ``caches`` in place.

    Inputs as :func:`decode_step_plain`; ``x_in``, ``rep_i`` and each cache's
    rows may be strided views whose last dim is contiguous.  On the CPU it
    is the plain twin; on a CUDA device it launches the leg of
    ``csrc/decode_step.cu`` of the trunk's dtype (a cluster of 4 CTAs per
    ``plan.rows`` batch rows, :func:`kernel_plan`) or raises."""
    global launches
    _check_inputs(weights, x_in, rep_i, caches, i, n_head, adim)
    if rep_i.device.type == "cpu":
        return decode_step_plain(weights, x_in, rep_i, caches, i, n_head=n_head, adim=adim)
    if rep_i.device.type != "cuda":
        raise ValueError(f"fused_decode_step runs on cpu or cuda, got {rep_i.device}")
    B, D = rep_i.shape
    L, in_dim = caches.shape[1], x_in.shape[1]
    n_block = weights.block_qkvp1_w.shape[0]
    lim = kernel_limits()
    for what, value, most in (("n_embd", D, lim["d"]), ("positions", L, lim["l"]),
                              ("heads", n_head, lim["heads"]), ("input width", in_dim, lim["in"]),
                              ("action_dim", adim, lim["adim"])):
        if value > most:
            raise ValueError(f"decode_step holds at most {most} {what}, got {value}")
    if x_in.stride(1) != 1 or rep_i.stride(1) != 1 or caches.stride(3) != 1:
        raise ValueError("x_in, rep_i and caches need a contiguous last dim")
    dt = rep_i.dtype
    if dt == torch.bfloat16 and (D % 2 or rep_i.stride(0) % 2 or rep_i.data_ptr() % 4):
        raise ValueError("the bf16 decode step takes an even n_embd and rep_i rows at even "
                         f"strides on 4-byte boundaries, got n_embd {D}, stride "
                         f"{rep_i.stride(0)}")
    lib = _library()
    esize = ESIZE[dtype_name(dt)]
    count = lib.mat_decode_weight_bytes(0, in_dim, D, n_block, adim, esize)
    flat = flat_of(weights, dt, count)
    plan = kernel_plan(B, L, in_dim, n_embd=D, n_head=n_head, n_block=n_block, adim=adim,
                       dtype=dt)
    if plan.on_chip:
        flat = with_image(units(flat, esize), lib, "decode_step", plan, n_embd=D, n_block=n_block,
                          adim=adim, in_dim=in_dim, version=weights_version(weights))
    logits = torch.empty(B, adim, device=rep_i.device)
    with torch.cuda.device(rep_i.device):
        rc = lib.mat_decode_step(
            x_in.data_ptr(), x_in.stride(0), rep_i.data_ptr(), rep_i.stride(0), flat.data_ptr(),
            caches.data_ptr(), caches.stride(0), caches.stride(1), caches.stride(2),
            logits.data_ptr(), B, L, in_dim, D, n_head, n_block, adim, i,
            DTYPE_CODE[dtype_name(dt)], torch.cuda.current_stream(rep_i.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode_step launch failed: cudaError {rc}")
    launches += 1
    return logits
