"""The launch plan of the two decode kernels (``csrc/ar_decode.cu``,
``csrc/decode_step.cu``), read from the compiled library, and the weight
image their on-chip path copies into shared memory.

The plan (the path, the rows a cluster decodes, the shared memory a CTA
takes, the matrices every CTA holds whole) and the image's layout are
computed by ``csrc/decode_layout.cuh`` alone; each decode library exports
them (``mat_decode_plan``, ``mat_decode_image``), and the CPU tests build the
same file with ``g++``.  This module only asks and gathers, and lays out the
flat weights (:func:`pack_flat`).

Two trunk types, by their element size ``esize``: f32 (4) and bf16 (2).  The
trunk's matrices take ``esize`` bytes an element, every other field 4; the
image is gathered in units of ``esize`` bytes (an f32 value of a bf16 layout
is two units).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

# the matrices a CTA may hold whole and compute redundantly ("local"), by
# their bit in the plan's mask (dec::Mat)
MATS = ("embed", "proj1", "proj2", "mlp1", "mlp2", "head1", "head2")
KERNELS = ("decode_step", "ar_decode")   # index: the plan's `whole` flag


class Plan(NamedTuple):
    on_chip: bool         # weights and parameters in shared memory
    rows: int             # batch rows a cluster decodes
    cluster: int          # CTAs a cluster
    clusters: int         # clusters of the launch
    smem_bytes: int       # shared memory a CTA
    barriers: int         # cluster barriers a position (ar_decode) or a launch (decode_step)
    local: tuple          # the matrices every CTA holds whole (MATS names)
    local_mask: int       # the same, bit m for MATS[m]
    recipe: bool          # the kernel compiled for the recipe's widths runs (else the generic one)


# the fields of ARDecodeWeights / DecodeStepWeights that hold the trunk's
# matrices, in the trunk type; every other field is f32
TRUNK_FIELDS = frozenset({"embed_start", "embed_act", "embed_w", "block_qkvp1_w",
                          "block_qkvp2_w", "block_mlp_w1", "block_mlp_w2"})
ESIZE = {"float32": 4, "bfloat16": 2}
DTYPE_CODE = {"float32": 0, "bfloat16": 1}      # the libraries' dtype argument


def dtype_name(dtype) -> str:
    """``"float32"`` or ``"bfloat16"`` for a torch dtype; raises on others."""
    name = str(dtype).split(".")[-1]
    if name not in ESIZE:
        raise ValueError(f"the decode kernels run an f32 or a bf16 trunk, not {dtype}")
    return name


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the plan entry points of a library holding
    ``csrc/decode_layout.cuh``; returns ``lib``."""
    i32, i64p = ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.mat_decode_plan.argtypes = [i32] * 9 + [ctypes.POINTER(i32)]
    lib.mat_decode_plan.restype = None
    lib.mat_decode_smem_bytes.argtypes = [i32] * 11
    lib.mat_decode_smem_bytes.restype = i32
    lib.mat_decode_image.argtypes = [i32] * 7 + [i64p]
    lib.mat_decode_image.restype = i32
    lib.mat_decode_weight_bytes.argtypes = [i32] * 6
    lib.mat_decode_weight_bytes.restype = ctypes.c_longlong
    return lib


def pack_flat(fields, names, dtype) -> list:
    """The fields (tensors, in the kernels' field order ``names``) copied as
    views into one new flat buffer: the trunk's matrices
    (:data:`TRUNK_FIELDS`) in ``dtype`` and every other field in f32, each
    starting at a multiple of 4 bytes (``decode_layout.cuh::weight_layout``).
    The views share the buffer's version counter."""
    import torch

    dts = [dtype if n in TRUNK_FIELDS else torch.float32 for n in names]
    sizes = [t.numel() * torch.empty((), dtype=dt).element_size() for t, dt in zip(fields, dts)]
    flat = torch.zeros(sum(n + (-n) % 4 for n in sizes), dtype=torch.uint8,
                       device=fields[0].device)
    views, at = [], 0
    for t, dt, n in zip(fields, dts, sizes):
        v = flat[at:at + n].view(dt).view(t.shape)
        v.copy_(t.detach())
        views.append(v)
        at += n + (-n) % 4
    return views


def flat_of(weights, dtype, count: int):
    """The flat buffer (bytes) the kernel reads: the one that packed weights
    (:func:`pack_flat`'s views, in field order) lie in, or a new one when
    they do not lie in one as the layout of ``count`` bytes has them.
    Raises where the fields' sizes do not make that layout."""
    import torch

    def span(ws):   # the bytes the fields take laid out, and whether they lie so
        first, at, laid_out = ws[0], 0, True
        for t in ws:
            n = t.numel() * t.element_size()
            laid_out = (laid_out and t.is_contiguous()
                        and t.untyped_storage().data_ptr() == first.untyped_storage().data_ptr()
                        and t.data_ptr() == first.data_ptr() + at)
            at += n + (-n) % 4
        return at, laid_out

    at, laid_out = span(weights)
    if not laid_out:
        weights = type(weights)(*pack_flat(weights, type(weights)._fields, dtype))
        at = span(weights)[0]
    if at != count:
        raise ValueError(f"packed weights take {at} bytes, the kernel's layout {count}")
    first = weights[0]
    storage = first.untyped_storage()
    flat = torch.empty(0, dtype=torch.uint8, device=first.device)
    return flat.set_(storage, first.data_ptr() - storage.data_ptr(), (count,))


def units(flat, esize: int):
    """``flat``'s bytes as the image's units: f32 values (esize 4), or
    2-byte units (esize 2, a bf16 trunk)."""
    import torch

    return flat.view(torch.float32 if esize == 4 else torch.int16)


_plans: dict = {}


def launch_plan(lib: ctypes.CDLL, kernel: str, batch: int, *, n_embd: int, n_head: int,
                n_block: int, adim: int, n_pos: int, in_dim: int = 0, esize: int = 4) -> Plan:
    """The plan of one launch of ``kernel`` (``"ar_decode"`` over ``n_pos``
    agents, or ``"decode_step"`` with caches of ``n_pos`` positions) with a
    trunk of ``esize``-byte elements, as the launcher in ``lib`` takes it."""
    key = (id(lib), kernel, batch, n_embd, n_head, n_block, adim, n_pos, in_dim, esize)
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_int * 7)()
        lib.mat_decode_plan(KERNELS.index(kernel), batch, n_pos, in_dim, n_embd, n_head,
                            n_block, adim, esize, out)
        local = tuple(m for k, m in enumerate(MATS) if out[5] >> k & 1)
        plan = Plan(bool(out[0]), out[1], out[2], -(-batch // out[1]), out[3], out[4], local,
                    out[5], bool(out[6]))
        _plans[key] = plan
    return plan


def image_index(lib: ctypes.CDLL, kernel: str, plan: Plan, *, n_embd: int, n_block: int,
                adim: int, in_dim: int = 0, esize: int = 4):
    """On the on-chip path: the index into the flat weights
    (``ARDecodeWeights`` or ``DecodeStepWeights``, in field order), in units
    of ``esize`` bytes, of every unit of the CTAs' weight regions,
    ``(cluster, region)`` with -1 for padding, in the order the kernel's
    shared memory holds them (``dec::weight_image``)."""
    import numpy as np

    args = (KERNELS.index(kernel), plan.local_mask, in_dim, n_embd, n_block, adim, esize)
    region = lib.mat_decode_image(*args, None)
    index = np.empty(plan.cluster * region, dtype=np.int64)
    lib.mat_decode_image(*args, index.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    return index.reshape(plan.cluster, region)


_image_index: dict = {}   # (kernel, local, widths, esize, device) -> LongTensor
_images: dict = {}        # the last weights' (flat buffer, weights with image)


def with_image(flat, lib: ctypes.CDLL, kernel: str, plan: Plan, *, n_embd: int, n_block: int,
               adim: int, in_dim: int = 0, version=None):
    """The buffer an on-chip launch reads: the flat weights ``flat``, a 1-D
    tensor of the image's units (f32 for an f32 trunk, 2-byte units for a
    bf16 one: :func:`units`), zeros to the next multiple of 16 bytes, then
    their image (:func:`image_index`; zeros where it is padding).  One
    gather, cached for the last weights (a decode step runs once a position
    with the same weights) and their ``version`` (default ``flat``'s: pass
    the packed fields' where ``flat`` is a new tensor over their buffer);
    the cache holds those weights' buffer, so no other buffer can take its
    address while it stands."""
    import torch

    esize = flat.element_size()
    if version is None:
        version = -1 if flat.is_inference() else flat._version
    widths = (n_embd, n_block, adim, in_dim, esize)
    key = (flat.data_ptr(), version, kernel, plan.local_mask) + widths
    entry = _images.get(key)
    if entry is None:
        ikey = key[2:] + (flat.device,)
        if ikey not in _image_index:
            index = image_index(lib, kernel, plan, n_embd=n_embd, n_block=n_block, adim=adim,
                                in_dim=in_dim, esize=esize)
            _image_index[ikey] = torch.as_tensor(index.reshape(-1), device=flat.device)
        padded = torch.cat([flat, flat.new_zeros(1 + (-flat.numel()) % (16 // esize))])
        image = padded[_image_index[ikey]]                # -1: the last zero
        entry = (flat, torch.cat([padded[:-1], image]))
        _images.clear()
        _images[key] = entry
    return entry[1]


def weights_version(weights) -> int:
    """The version of packed weights (the counter their buffer's views
    share), -1 for inference tensors, which have none."""
    first = weights[0]
    return -1 if first.is_inference() else first._version
