"""The decode kernels' launch plan and weight image, on the CPU.

``csrc/decode_layout.cuh`` alone decides the plan (the path: weights in
shared memory or in device memory; the rows a cluster of 4 CTAs decodes;
the matrices every CTA holds whole; the shared memory a CTA takes) and lays
out each CTA's weight image.  Each decode library exports it to its wrapper;
here ``g++`` builds the same file, and the tests hold it to what the kernels
rely on.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

from mat_dcml_tpu_torch.ops import decode_plan as dp

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")

HEADER = Path(dp.__file__).resolve().parents[1] / "csrc" / "decode_layout.cuh"
SMEM_LIMIT = 232_448      # bytes of shared memory a CTA may take on an H100
WAVE_CLUSTERS = 16        # 4-CTA clusters that run at once, one CTA an SM

# (kernel, widths): DCML MAT's whole decode, multi-agent MuJoCo lite's decode
# step (manyagent_ant 10x2, action 8, in_dim 8), the step at 101 agents
DCML = ("ar_decode", dict(n_embd=64, n_head=2, n_block=2, adim=2, n_pos=101))
MUJOCO = ("decode_step", dict(n_embd=64, n_head=2, n_block=2, adim=8, n_pos=10, in_dim=8))
STEP_101 = ("decode_step", dict(n_embd=64, n_head=2, n_block=2, adim=8, n_pos=101, in_dim=9))
# the wrappers' limits (csrc/*.cu kMax*)
AR_LIMITS = ("ar_decode", dict(n_embd=256, n_head=8, n_block=2, adim=64, n_pos=256))
STEP_LIMITS = ("decode_step", dict(n_embd=256, n_head=8, n_block=2, adim=256, n_pos=256,
                                   in_dim=257))
# the order in which each kernel makes matrices local while they fit
LOCAL_ORDER = {"ar_decode": ("head2", "proj1", "proj2", "mlp1", "mlp2", "head1"),
               "decode_step": ("embed", "proj1", "proj2", "mlp1", "mlp2", "head1")}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = tmp_path_factory.mktemp("decode_layout") / "libdecode_layout.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-o", str(so),
                    str(HEADER)], check=True, capture_output=True)
    lib = dp.bind(ctypes.CDLL(str(so)))
    lib.mat_decode_k_slices.argtypes = [ctypes.c_int]
    lib.mat_decode_slice_depth.argtypes = [ctypes.c_int] * 2
    return lib


def _plan(lib, case, B):
    kernel, widths = case
    return dp.launch_plan(lib, kernel, B, **widths)


def _smem_bytes(lib, case, on_chip, rows, local=()):
    kernel, w = case
    mask = sum(1 << dp.MATS.index(m) for m in local)
    return lib.mat_decode_smem_bytes(dp.KERNELS.index(kernel), on_chip, mask, rows, w["n_pos"],
                                     w.get("in_dim", 0), w["n_embd"], w["n_head"], w["n_block"],
                                     w["adim"])


def _image(lib, case, plan):
    kernel, w = case
    return dp.image_index(lib, kernel, plan, n_embd=w["n_embd"], n_block=w["n_block"],
                          adim=w["adim"], in_dim=w.get("in_dim", 0))


@pytest.mark.parametrize("B", [1, 3, 8, 9, 17, 128])
@pytest.mark.parametrize("case", [DCML, MUJOCO, AR_LIMITS], ids=["dcml", "mujoco", "ar_limits"])
def test_plan_covers_every_row_once(lib, case, B):
    plan = _plan(lib, case, B)
    # cluster c takes rows [c rows, min(B, (c + 1) rows)), as the kernels do
    parts = [range(c * plan.rows, min(B, (c + 1) * plan.rows)) for c in range(plan.clusters)]
    assert sorted(r for part in parts for r in part) == list(range(B))   # each row, once
    assert all(len(part) >= 1 for part in parts)
    assert plan.clusters == -(-B // plan.rows)


@pytest.mark.parametrize("case,barriers", [(DCML, 8), (MUJOCO, 10), (STEP_101, 10)],
                         ids=["dcml", "mujoco", "step_101"])
def test_recipe_widths_hold_their_weights_on_chip(lib, case, barriers):
    plan = _plan(lib, case, 8)
    assert plan.on_chip and plan.cluster == 4 and plan.recipe
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.rows == 2
    # 4 a block always (q/k/v, the self-attention, k2/v2, the cross-attention),
    # one more for each matrix left split
    assert plan.barriers == barriers


@pytest.mark.parametrize("case", [DCML, MUJOCO, STEP_101], ids=["dcml", "mujoco", "step_101"])
def test_local_matrices_follow_their_order_while_they_fit(lib, case):
    plan = _plan(lib, case, 8)
    local = ()
    for m in LOCAL_ORDER[case[0]]:
        fits = _smem_bytes(lib, case, True, plan.rows, local + (m,)) <= SMEM_LIMIT
        assert (m in plan.local) == fits
        local += (m,) if fits else ()
    assert set(plan.local) == set(local) and plan.local
    assert plan.smem_bytes == _smem_bytes(lib, case, True, plan.rows, local)
    assert plan.local_mask == sum(1 << dp.MATS.index(m) for m in local)


def test_dcml_whole_decode_shared_memory_by_hand(lib):
    # weights: per block the split q/k/v (48 cols x 68) and k2/v2 (32 x 72)
    # and four whole D x D matrices (64 x 68); the whole head (64 x 68 and
    # 2 x 64); the biases and LN parameters (16 D a block, 3 D + adim for
    # the head).  Two rows of 18 D stage buffers and a second rep; logits,
    # the embedded start and action rows, two buffers of sampling inputs and
    # of staged queries, draws; one pair's 101 scores and 256 partial sums
    weights = 2 * (48 * 68 + 32 * 72 + 4 * 64 * 68) + 64 * 68 + 2 * 64 + 2 * 16 * 64 + 3 * 64 + 2
    weights += -weights % 4                        # whole 16-byte words
    rows = 2 * 19 * 64 + 2 * 2 + 3 * 64 + 2 * 2 * 5 + 2 * 2 * 2 * 16 + 2
    floats = weights + rows + 101 + 256
    plan = _plan(lib, DCML, 8)
    assert plan.local == ("proj1", "proj2", "mlp1", "mlp2", "head1", "head2")
    assert plan.smem_bytes == 4 * floats == 223_244
    assert _image(lib, DCML, plan).shape == (4, weights)


@pytest.mark.parametrize("case", [AR_LIMITS, STEP_LIMITS,
                                  ("ar_decode", dict(AR_LIMITS[1], n_block=6)),
                                  ("decode_step", dict(STEP_LIMITS[1], n_block=6))],
                         ids=["ar", "step", "ar_6_blocks", "step_6_blocks"])
def test_wrapper_limits_take_device_memory_and_fit(lib, case):
    plan = _plan(lib, case, 128)
    assert not plan.on_chip and plan.local == () and not plan.recipe
    assert plan.rows == (4 if case[0] == "ar_decode" else 8)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.barriers == 8 * case[1]["n_block"] + (2 if case[0] == "ar_decode" else 3)


@pytest.mark.parametrize("case", [
    ("ar_decode", dict(n_embd=256, n_head=2, n_block=2, adim=2, n_pos=101)),   # weights
    ("ar_decode", dict(n_embd=128, n_head=2, n_block=2, adim=2, n_pos=101)),
    ("ar_decode", dict(n_embd=64, n_head=2, n_block=12, adim=2, n_pos=101)),   # many blocks
    ("decode_step", dict(n_embd=256, n_head=2, n_block=2, adim=8, n_pos=10, in_dim=9)),
    ("decode_step", dict(n_embd=128, n_head=2, n_block=2, adim=8, n_pos=10, in_dim=9)),
], ids=["ar_d256", "ar_d128", "ar_12_blocks", "step_d256", "step_d128"])
def test_device_memory_where_nothing_fits(lib, case):
    assert _smem_bytes(lib, case, True, 2) > SMEM_LIMIT      # every matrix split, 2 rows
    plan = _plan(lib, case, 8)
    assert not plan.on_chip and plan.smem_bytes <= SMEM_LIMIT
    assert plan.smem_bytes == _smem_bytes(lib, case, False, plan.rows)


@pytest.mark.parametrize("nc,ks", [(1, 32), (8, 32), (16, 16), (32, 8), (48, 4), (64, 4),
                                   (96, 2), (128, 2), (129, 1), (256, 1), (300, 1)])
def test_k_slices_fill_the_cta_within_a_warp(lib, nc, ks):
    assert lib.mat_decode_k_slices(nc) == ks
    # the padded depth makes the lanes (column jj, slice s) of a warp hit 32
    # distinct banks: jj * depth + s covers 0 .. 31 once (mod 32)
    depth = lib.mat_decode_slice_depth(64, nc)
    lanes = min(32, ks * max(1, 32 // ks))
    banks = {(jj * depth + s) % 32 for jj in range(lanes // ks) for s in range(ks)}
    assert len(banks) == lanes and 64 <= depth < 64 + 32


@pytest.mark.parametrize("B,rows", [(1, 2), (8, 2), (32, 2), (33, 8), (64, 8), (65, 8), (128, 8)])
@pytest.mark.parametrize("case", [DCML, MUJOCO], ids=["dcml", "mujoco"])
def test_more_rows_a_cluster_at_large_batches(lib, case, B, rows):
    # one wave: at most WAVE_CLUSTERS clusters of 4 CTAs up to 128 rows
    plan = _plan(lib, case, B)
    assert plan.on_chip and plan.rows == rows and plan.smem_bytes <= SMEM_LIMIT
    assert plan.clusters == -(-B // rows) <= WAVE_CLUSTERS
    assert plan.recipe


@pytest.mark.parametrize("B", [3, 40])
@pytest.mark.parametrize("kernel", ["ar_decode", "decode_step"])
def test_other_widths_take_the_generic_kernel(lib, kernel, B):
    # the kernel compiled for the recipe's widths runs only at n_embd 64 and
    # 2 heads; other widths whose weights fit take the generic on-chip one
    case = DCML if kernel == "ar_decode" else MUJOCO
    for width in (dict(n_head=4), dict(n_embd=32), dict(n_embd=48, n_head=3)):
        plan = _plan(lib, (kernel, dict(case[1], **width)), B)
        assert plan.on_chip and not plan.recipe and plan.rows == (2 if B <= 32 else 8)


@pytest.mark.parametrize("B", [1, 128])
@pytest.mark.parametrize("case", [DCML, MUJOCO, ("decode_step", dict(MUJOCO[1], in_dim=9))],
                         ids=["dcml", "mujoco", "mujoco_avail"])
def test_weight_image_is_each_ctas_shared_memory(lib, case, B):
    # every float of every CTA's weight region names a flat weight index (or
    # padding); split matrices' entries lie in exactly one CTA, local ones'
    # in all four, transposed (column j of a part at j * ld + k)
    import numpy as np

    kernel, widths = case
    plan = _plan(lib, case, B)
    D, nb, adim = widths["n_embd"], widths["n_block"], widths["adim"]
    in_dim = widths.get("in_dim", 0)
    image = _image(lib, case, plan)
    region = (plan.smem_bytes - _smem_bytes(lib, case, False, plan.rows)) // 4
    assert image.shape == (4, region) and region % 4 == 0
    embed = (D + adim * D + 2 * D) if kernel == "ar_decode" else (in_dim * D + 3 * D)
    total = embed + nb * (10 * D * D + 16 * D) + D * D + 3 * D + D * adim + adim
    total += adim if kernel == "ar_decode" else 0          # std_row
    counts = np.bincount(image[image >= 0], minlength=total)
    assert counts.shape == (total,)
    w1 = embed                                     # block 0's [q|k|v|p] of the self-attention
    qkv = (w1 + np.arange(D)[:, None] * 4 * D + np.arange(3 * D)[None, :]).ravel()
    proj1 = (w1 + np.arange(D)[:, None] * 4 * D + 3 * D + np.arange(D)[None, :]).ravel()
    assert (counts[qkv] == 1).all()                # split over the cluster
    assert (counts[proj1] == (4 if "proj1" in plan.local else 1)).all()
    # rank 1's q/k/v part (after a step's embedding part): its column j,
    # row k is W[k][48 + j] at j * 68 + k
    embed_cols = D if "embed" in plan.local else D // 4
    start = 0 if kernel == "ar_decode" else embed_cols * lib.mat_decode_slice_depth(
        in_dim, embed_cols)
    part = image[1, start:start + 48 * 68].reshape(48, 68)
    assert (part[:, :D] == w1 + np.arange(D)[None, :] * 4 * D + 48 + np.arange(48)[:, None]).all()
    assert (part[:, D:] == -1).all()


@pytest.mark.parametrize("case", [DCML, MUJOCO], ids=["dcml", "mujoco"])
def test_with_image_appends_the_gathered_image_to_the_weights(lib, case):
    import torch

    kernel, widths = case
    plan = _plan(lib, case, 8)
    kw = dict(n_embd=widths["n_embd"], n_block=widths["n_block"], adim=widths["adim"],
              in_dim=widths.get("in_dim", 0))
    index = torch.as_tensor(_image(lib, case, plan)).reshape(-1)
    n = int(index.max()) + 3                       # a count that is not a multiple of 4
    flat = torch.arange(1, n + 1, dtype=torch.float32)
    buf = dp.with_image(flat, lib, kernel, plan, **kw)
    start = n + (-n) % 4
    assert torch.equal(buf[:n], flat) and (buf[n:start] == 0).all()
    image = buf[start:]
    assert image.numel() == index.numel()
    assert torch.equal(image[index >= 0], flat[index[index >= 0]])
    assert (image[index < 0] == 0).all()
    assert dp.with_image(flat, lib, kernel, plan, **kw) is buf     # cached for the same weights


def test_with_image_follows_new_weights(lib):
    # the cache holds the last weights' buffer, so a new pack cannot reuse
    # its address; an in-place change (a new version) rebuilds the image
    import torch

    widths = dict(MUJOCO[1])
    plan = _plan(lib, MUJOCO, 8)
    kw = dict(n_embd=widths["n_embd"], n_block=widths["n_block"], adim=widths["adim"],
              in_dim=widths["in_dim"])
    n = int(_image(lib, MUJOCO, plan).max()) + 1
    flat = torch.zeros(n)
    first = dp.with_image(flat, lib, "decode_step", plan, **kw).clone()
    flat += 1.0
    second = dp.with_image(flat, lib, "decode_step", plan, **kw)
    assert not torch.equal(first, second) and second.max() == 1.0
    with torch.inference_mode():
        frozen = torch.ones(n)
        assert dp.with_image(frozen, lib, "decode_step", plan, **kw).max() == 1.0
