"""The launch plan of the two decode kernels (``csrc/ar_decode.cu``,
``csrc/decode_step.cu``), read from the compiled library, and the weight
image their on-chip path copies into shared memory.

The plan (the path, the rows a cluster decodes, the shared memory a CTA
takes, the matrices every CTA holds whole) and the image's layout are
computed by ``csrc/decode_layout.cuh`` alone; each decode library exports
them (``mat_decode_plan``, ``mat_decode_image``), and the CPU tests build the
same file with ``g++``.  This module only asks and gathers.
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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the plan entry points of a library holding
    ``csrc/decode_layout.cuh``; returns ``lib``."""
    i32, i64p = ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.mat_decode_plan.argtypes = [i32] * 8 + [ctypes.POINTER(i32)]
    lib.mat_decode_plan.restype = None
    lib.mat_decode_smem_bytes.argtypes = [i32] * 10
    lib.mat_decode_smem_bytes.restype = i32
    lib.mat_decode_image.argtypes = [i32] * 6 + [i64p]
    lib.mat_decode_image.restype = i32
    return lib


_plans: dict = {}


def launch_plan(lib: ctypes.CDLL, kernel: str, batch: int, *, n_embd: int, n_head: int,
                n_block: int, adim: int, n_pos: int, in_dim: int = 0) -> Plan:
    """The plan of one launch of ``kernel`` (``"ar_decode"`` over ``n_pos``
    agents, or ``"decode_step"`` with caches of ``n_pos`` positions), as the
    launcher in ``lib`` takes it."""
    key = (id(lib), kernel, batch, n_embd, n_head, n_block, adim, n_pos, in_dim)
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_int * 7)()
        lib.mat_decode_plan(KERNELS.index(kernel), batch, n_pos, in_dim, n_embd, n_head,
                            n_block, adim, out)
        local = tuple(m for k, m in enumerate(MATS) if out[5] >> k & 1)
        plan = Plan(bool(out[0]), out[1], out[2], -(-batch // out[1]), out[3], out[4], local,
                    out[5], bool(out[6]))
        _plans[key] = plan
    return plan


def image_index(lib: ctypes.CDLL, kernel: str, plan: Plan, *, n_embd: int, n_block: int,
                adim: int, in_dim: int = 0):
    """On the on-chip path: the flat weights' index (``ARDecodeWeights`` or
    ``DecodeStepWeights``, in field order) of every float of the CTAs'
    weight regions, ``(cluster, region)`` with -1 for padding, in the order
    the kernel's shared memory holds them (``dec::weight_image``)."""
    import numpy as np

    args = (KERNELS.index(kernel), plan.local_mask, in_dim, n_embd, n_block, adim)
    region = lib.mat_decode_image(*args, None)
    index = np.empty(plan.cluster * region, dtype=np.int64)
    lib.mat_decode_image(*args, index.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    return index.reshape(plan.cluster, region)


_image_index: dict = {}   # (kernel, local, widths, device) -> LongTensor
_images: dict = {}        # the last weights' (flat buffer, weights with image)


def with_image(flat, lib: ctypes.CDLL, kernel: str, plan: Plan, *, n_embd: int, n_block: int,
               adim: int, in_dim: int = 0):
    """The buffer an on-chip launch reads: the flat weights, zeros to the
    next multiple of 4 floats, then their image (:func:`image_index`; zeros
    where it is padding).  One gather, cached for the last weights (a decode
    step runs once a position with the same weights); the cache holds those
    weights' buffer, so no other buffer can take its address while it
    stands."""
    import torch

    version = -1 if flat.is_inference() else flat._version
    widths = (n_embd, n_block, adim, in_dim)
    key = (flat.data_ptr(), version, kernel, plan.local_mask) + widths
    entry = _images.get(key)
    if entry is None:
        ikey = key[2:] + (flat.device,)
        if ikey not in _image_index:
            index = image_index(lib, kernel, plan, n_embd=n_embd, n_block=n_block, adim=adim,
                                in_dim=in_dim)
            _image_index[ikey] = torch.as_tensor(index.reshape(-1), device=flat.device)
        padded = torch.cat([flat, flat.new_zeros(1 + (-flat.numel()) % 4)])
        image = padded[_image_index[ikey]]                # -1: the last zero
        entry = (flat, torch.cat([padded[:-1], image]))
        _images.clear()
        _images[key] = entry
    return entry[1]
