"""The decode kernels' launch plan and weight image, on the CPU.

``csrc/decode_layout.cuh`` alone decides the plan (the path: weights in
shared memory or in device memory; the rows a cluster of 4 CTAs decodes;
the matrices every CTA holds whole; the shared memory a CTA takes) and lays
out each CTA's weight image.  Each decode library exports it to its wrapper;
here ``g++`` builds the same file, and the tests hold it to what the kernels
rely on, for both trunk types by their element size (``esize`` 4: f32, 2:
bf16).  The f32 plan is pinned to the numbers it had before the bf16 leg.
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
# SMAC's whole decodes (discrete, no Gaussian tail): 8m (8 agents, 14
# actions) and the multi-map layout (27 agents, 36 actions)
SMAC_8M = ("ar_decode", dict(n_embd=64, n_head=2, n_block=2, adim=14, n_pos=8))
SMAC_MULTI = ("ar_decode", dict(n_embd=64, n_head=2, n_block=2, adim=36, n_pos=27))
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
    lib.mat_decode_slice_depth.argtypes = [ctypes.c_int] * 3
    return lib


def _plan(lib, case, B, esize=4):
    kernel, widths = case
    return dp.launch_plan(lib, kernel, B, esize=esize, **widths)


def _smem_bytes(lib, case, on_chip, rows, local=(), esize=4):
    kernel, w = case
    mask = sum(1 << dp.MATS.index(m) for m in local)
    return lib.mat_decode_smem_bytes(dp.KERNELS.index(kernel), on_chip, mask, rows, w["n_pos"],
                                     w.get("in_dim", 0), w["n_embd"], w["n_head"], w["n_block"],
                                     w["adim"], esize)


def _image(lib, case, plan, esize=4):
    kernel, w = case
    return dp.image_index(lib, kernel, plan, n_embd=w["n_embd"], n_block=w["n_block"],
                          adim=w["adim"], in_dim=w.get("in_dim", 0), esize=esize)


def _field_bytes(case, esize):
    """Byte offset of each field of the flat weights, in field order
    (``decode_layout.cuh::weight_layout``): the trunk's matrices take esize
    bytes an element, every other field 4, each starting at a multiple of
    4 bytes."""
    kernel, w = case
    D, nb, adim, in_dim = w["n_embd"], w["n_block"], w["adim"], w.get("in_dim", 0)
    sizes = ([("embed_start", D), ("embed_act", adim * D)] if kernel == "ar_decode"
             else [("embed_w", in_dim * D), ("embed_b", D)])
    sizes += [("ln0", 2 * D), ("block_qkvp1_w", nb * 4 * D * D), ("block_qkvp1_b", nb * 4 * D),
              ("block_qkvp2_w", nb * 4 * D * D), ("block_qkvp2_b", nb * 4 * D),
              ("block_mlp_w1", nb * D * D), ("block_mlp_b1", nb * D),
              ("block_mlp_w2", nb * D * D), ("block_mlp_b2", nb * D), ("block_lns", nb * 6 * D),
              ("head_w1", D * D), ("head_b1", D), ("head_ln", 2 * D), ("head_w2", D * adim),
              ("head_b2", adim)] + ([("std_row", adim)] if kernel == "ar_decode" else [])
    at, out = 0, {}
    for name, n in sizes:
        out[name] = at
        nbytes = n * (esize if name in dp.TRUNK_FIELDS else 4)
        at += nbytes + (-nbytes) % 4
    out["total"] = at
    return out


ESIZES = pytest.mark.parametrize("esize", [4, 2], ids=["f32", "bf16"])


@ESIZES
@pytest.mark.parametrize("B", [1, 3, 8, 9, 17, 128])
@pytest.mark.parametrize("case", [DCML, MUJOCO, AR_LIMITS], ids=["dcml", "mujoco", "ar_limits"])
def test_plan_covers_every_row_once(lib, case, B, esize):
    plan = _plan(lib, case, B, esize)
    # cluster c takes rows [c rows, min(B, (c + 1) rows)), as the kernels do
    parts = [range(c * plan.rows, min(B, (c + 1) * plan.rows)) for c in range(plan.clusters)]
    assert sorted(r for part in parts for r in part) == list(range(B))   # each row, once
    assert all(len(part) >= 1 for part in parts)
    assert plan.clusters == -(-B // plan.rows)


# (rows a cluster, the recipe's kernel, cluster barriers a position) of
# SMAC's whole decodes, f32 and bf16: at 36 actions the f32 head's first
# layer (and at 8 rows the MLP) no longer fits beside the rest, so the
# multi-map decode takes the generic kernel with those matrices split; 8m
# keeps every matrix whole, 7 KB over DCML's room for its wider action rows
SMAC_PLANS = {("8m", 32): ((2, True, 8), (2, True, 8)),
              ("8m", 1): ((2, True, 8), (2, True, 8)),
              ("multi", 36): ((8, False, 12), (8, True, 8)),
              ("multi", 8): ((2, False, 9), (2, True, 8))}


@pytest.mark.parametrize("esize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("key", list(SMAC_PLANS), ids=[f"{k}_b{b}" for k, b in SMAC_PLANS])
def test_smac_whole_decodes_fit_on_chip(lib, key, esize):
    """The rollout's batches (E 32 on 8m, 36 on the multi-map recipe) and
    serving's: weights on chip, each row once, 2 rows a cluster up to B 32
    and 8 from 33, as at DCML's widths, within the card's shared memory."""
    case = {"8m": SMAC_8M, "multi": SMAC_MULTI}[key[0]]
    B = key[1]
    plan = _plan(lib, case, B, esize)
    assert plan.on_chip and plan.cluster == 4 and plan.smem_bytes <= SMEM_LIMIT
    assert plan.clusters == -(-B // plan.rows)
    assert (plan.rows, plan.recipe, plan.barriers) == SMAC_PLANS[key][esize == 2]


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


@ESIZES
@pytest.mark.parametrize("B", [8, 128])
@pytest.mark.parametrize("case", [DCML, MUJOCO, STEP_101], ids=["dcml", "mujoco", "step_101"])
def test_local_matrices_follow_their_order_while_they_fit(lib, case, B, esize):
    plan = _plan(lib, case, B, esize)
    local = ()
    for m in LOCAL_ORDER[case[0]]:
        fits = _smem_bytes(lib, case, True, plan.rows, local + (m,), esize) <= SMEM_LIMIT
        assert (m in plan.local) == fits
        local += (m,) if fits else ()
    assert set(plan.local) == set(local) and plan.local
    assert plan.smem_bytes == _smem_bytes(lib, case, True, plan.rows, local, esize)
    assert plan.local_mask == sum(1 << dp.MATS.index(m) for m in local)


# (on chip, rows, shared-memory bytes, cluster barriers, local mask, recipe
# kernel) of the recipe's widths, as the f32 kernels had them before the bf16
# leg; the bf16 leg holds every optional matrix at both row counts
F32_PLANS = {("dcml", 8): (True, 2, 223_244, 8, 126, True),
             ("dcml", 128): (True, 8, 230_912, 10, 110, True),
             ("mujoco", 8): (True, 2, 229_000, 10, 31, True),
             ("mujoco", 128): (True, 8, 232_384, 12, 15, True)}
BF16_PLANS = {("dcml", 8): (True, 2, 126_604, 8, 126, True),
              ("dcml", 128): (True, 8, 145_792, 8, 126, True),
              ("mujoco", 8): (True, 2, 139_624, 9, 63, True),
              ("mujoco", 128): (True, 8, 155_200, 9, 63, True)}


@pytest.mark.parametrize("esize,plans", [(4, F32_PLANS), (2, BF16_PLANS)], ids=["f32", "bf16"])
@pytest.mark.parametrize("key", list(F32_PLANS), ids=[f"{k}_b{b}" for k, b in F32_PLANS])
def test_recipe_plans_pinned(lib, esize, plans, key):
    case = {"dcml": DCML, "mujoco": MUJOCO}[key[0]]
    plan = _plan(lib, case, key[1], esize)
    assert (plan.on_chip, plan.rows, plan.smem_bytes, plan.barriers, plan.local_mask,
            plan.recipe) == plans[key]
    if esize == 2:   # the bf16 trunk's matrices take half the room
        assert plan.smem_bytes < _plan(lib, case, key[1]).smem_bytes


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
@ESIZES
def test_wrapper_limits_take_device_memory_and_fit(lib, case, esize):
    plan = _plan(lib, case, 128, esize)
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


@pytest.mark.parametrize("case,on_chip", [
    (("ar_decode", dict(n_embd=256, n_head=2, n_block=2, adim=2, n_pos=101)), False),
    (("ar_decode", dict(n_embd=128, n_head=2, n_block=2, adim=2, n_pos=101)), True),
    (("decode_step", dict(n_embd=256, n_head=2, n_block=2, adim=8, n_pos=10, in_dim=9)), False),
    (("decode_step", dict(n_embd=128, n_head=2, n_block=2, adim=8, n_pos=10, in_dim=9)), True),
], ids=["ar_d256", "ar_d128", "step_d256", "step_d128"])
def test_bf16_halves_the_trunk_so_n_embd_128_fits(lib, case, on_chip):
    # in bf16 n_embd 128's split slices fit a CTA (its f32 kernels read device
    # memory); n_embd 256 still takes the device-memory path
    plan = _plan(lib, case, 8, esize=2)
    assert plan.on_chip == on_chip and plan.smem_bytes <= SMEM_LIMIT
    assert (_smem_bytes(lib, case, True, 2, esize=2) <= SMEM_LIMIT) == on_chip


@pytest.mark.parametrize("nc,ks", [(1, 32), (8, 32), (16, 16), (32, 8), (48, 4), (64, 4),
                                   (96, 2), (128, 2), (129, 1), (256, 1), (300, 1)])
def test_k_slices_fill_the_cta_within_a_warp(lib, nc, ks):
    assert lib.mat_decode_k_slices(nc) == ks
    # the padded depth makes the lanes (column jj, slice s) of a warp hit 32
    # distinct banks: jj * depth + s covers 0 .. 31 once (mod 32)
    depth = lib.mat_decode_slice_depth(64, nc, 4)
    lanes = min(32, ks * max(1, 32 // ks))
    banks = {(jj * depth + s) % 32 for jj in range(lanes // ks) for s in range(ks)}
    assert len(banks) == lanes and 64 <= depth < 64 + 32
    # bf16: two lanes a 4-byte word, and the words of a warp in distinct
    # banks: element jj * depth + s, word (element // 2) mod 32
    depth = lib.mat_decode_slice_depth(64, nc, 2)
    words = {(jj * depth + s) // 2 for jj in range(lanes // ks) for s in range(ks)}
    assert len({w % 32 for w in words}) == len(words) and 64 <= depth < 64 + 64


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


@ESIZES
@pytest.mark.parametrize("B", [1, 128])
@pytest.mark.parametrize("case", [DCML, MUJOCO, ("decode_step", dict(MUJOCO[1], in_dim=9))],
                         ids=["dcml", "mujoco", "mujoco_avail"])
def test_weight_image_is_each_ctas_shared_memory(lib, case, B, esize):
    # every unit (esize bytes) of every CTA's weight region names a unit of
    # the flat weights (or padding); split matrices' entries lie in exactly
    # one CTA, local ones' in all four, transposed (column j of a part at j *
    # ld + k); an f32 value of a bf16 layout is two consecutive units
    import numpy as np

    kernel, widths = case
    plan = _plan(lib, case, B, esize)
    D = widths["n_embd"]
    in_dim = widths.get("in_dim", 0)
    image = _image(lib, case, plan, esize)
    region = (plan.smem_bytes - _smem_bytes(lib, case, False, plan.rows, esize=esize)) // esize
    assert image.shape == (4, region) and (region * esize) % 16 == 0
    fields = _field_bytes(case, esize)
    counts = np.bincount(image[image >= 0], minlength=fields["total"] // esize)
    assert counts.shape == (fields["total"] // esize,)
    w1 = fields["block_qkvp1_w"] // esize          # block 0's [q|k|v|p] of the self-attention
    qkv = (w1 + np.arange(D)[:, None] * 4 * D + np.arange(3 * D)[None, :]).ravel()
    proj1 = (w1 + np.arange(D)[:, None] * 4 * D + 3 * D + np.arange(D)[None, :]).ravel()
    assert (counts[qkv] == 1).all()                # split over the cluster
    assert (counts[proj1] == (4 if "proj1" in plan.local else 1)).all()
    # rank 1's q/k/v part (after a step's embedding part): its column j,
    # row k is W[k][48 + j] at j * depth + k
    depth = lib.mat_decode_slice_depth(D, 48, esize)
    embed_cols = D if "embed" in plan.local else D // 4
    embed = embed_cols * lib.mat_decode_slice_depth(in_dim, embed_cols, esize)
    start = 0 if kernel == "ar_decode" else embed + (-embed) % (4 // esize)
    part = image[1, start:start + 48 * depth].reshape(48, depth)
    assert (part[:, :D] == w1 + np.arange(D)[None, :] * 4 * D + 48 + np.arange(48)[:, None]).all()
    assert (part[:, D:] == -1).all()
    # the head's LayerNorm (f32): its 2 D values, whole in every CTA
    ln = fields["head_ln"] // esize + np.arange(2 * D * 4 // esize)
    assert (counts[ln] == 4).all()
    per = 4 // esize
    at = np.flatnonzero(image[0] == ln[0])
    assert at.size == 1 and (image[0, at[0]:at[0] + ln.size] == ln).all() and at[0] % per == 0


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


def test_with_image_gathers_bf16_units(lib):
    # a bf16 trunk's image is gathered in 2-byte units: the flat bytes as
    # int16, zeros to the next 16 bytes, then each CTA's region
    import torch

    kernel, widths = DCML
    plan = _plan(lib, DCML, 8, esize=2)
    kw = dict(n_embd=widths["n_embd"], n_block=widths["n_block"], adim=widths["adim"])
    index = torch.as_tensor(_image(lib, DCML, plan, esize=2)).reshape(-1)
    n = _field_bytes(DCML, 2)["total"] // 2
    assert int(index.max()) < n
    flat = torch.randint(-2**15, 2**15, (n,), dtype=torch.int16,
                         generator=torch.Generator().manual_seed(0))
    buf = dp.with_image(flat, lib, kernel, plan, **kw)
    start = n + (-n) % 8
    assert torch.equal(buf[:n], flat) and (buf[n:start] == 0).all()
    image = buf[start:]
    assert torch.equal(image[index >= 0], flat[index[index >= 0]])
    assert (image[index < 0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_flat_lays_out_the_fields_as_the_kernels_read_them(lib, dtype):
    # the packed fields are views into one buffer of the layout's bytes, each
    # at its offset, the trunk's matrices in the trunk's dtype, the rest f32;
    # flat_of finds that buffer, and repacks anything else
    import torch

    from mat_dcml_tpu_torch.ops.ar_decode import ARDecodeWeights

    kernel, w = DCML
    D, nb, adim = w["n_embd"], w["n_block"], w["adim"]
    shapes = dict(embed_start=(1, D), embed_act=(adim, D), ln0=(2, D),
                  block_qkvp1_w=(nb, D, 4 * D), block_qkvp1_b=(nb, 4 * D),
                  block_qkvp2_w=(nb, D, 4 * D), block_qkvp2_b=(nb, 4 * D),
                  block_mlp_w1=(nb, D, D), block_mlp_b1=(nb, D), block_mlp_w2=(nb, D, D),
                  block_mlp_b2=(nb, D), block_lns=(nb, 6, D), head_w1=(D, D), head_b1=(D,),
                  head_ln=(2, D), head_w2=(D, adim), head_b2=(adim,), std_row=(1, adim))
    g = torch.Generator().manual_seed(1)
    fields = [torch.randn(shapes[f], generator=g) for f in ARDecodeWeights._fields]
    dt = getattr(torch, dtype)
    esize = 4 if dtype == "float32" else 2
    count = lib.mat_decode_weight_bytes(1, 0, D, nb, adim, esize)
    packed = ARDecodeWeights(*dp.pack_flat(fields, ARDecodeWeights._fields, dt))
    offsets = _field_bytes(DCML, esize)
    assert count == offsets["total"]
    flat = dp.flat_of(packed, dt, count)
    assert flat.dtype == torch.uint8 and flat.numel() == count
    assert flat.data_ptr() == packed[0].data_ptr()
    for name, t, src in zip(ARDecodeWeights._fields, packed, fields):
        assert t.dtype == (dt if name in dp.TRUNK_FIELDS else torch.float32)
        assert t.data_ptr() == flat.data_ptr() + offsets[name]
        assert torch.equal(t, src.to(t.dtype))
    loose = ARDecodeWeights(*(t.clone() for t in packed))
    again = dp.flat_of(loose, dt, count)
    assert again.data_ptr() != flat.data_ptr() and torch.equal(again, flat)
