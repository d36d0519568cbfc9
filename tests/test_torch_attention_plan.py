"""The attention kernels' launch plan and shared-memory layout, on the CPU;
and the row statistics the bf16 backward reads, against JAX's XLA path.

``csrc/attention_plan.cuh`` alone decides how the forward cuts a launch
into (row n, query tile) CTAs and how much shared memory each kernel's CTA
takes; both attention libraries launch by it.  Here ``g++`` builds the same
file, once alone (its exported entry points, as the wrappers call them) and
once under a small scan harness that walks every shape the kernels accept,
and the tests hold it to what the kernels rely on: every (row, query tile)
covered exactly once, shared memory within an H100's opt-in at every Lq, Lk
and Dh up to 128 in both dtypes (the plans do not depend on the causal
flag: a causal launch allocates what a full one does), row strides that
keep ldmatrix conflict-free, and enough CTAs at the rollout's small N.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.ops.attention import multi_head_attention as jax_mha
from mat_dcml_tpu_torch.ops import cuda_attention as ca

HEADER = Path(ca.__file__).resolve().parents[1] / "csrc" / "attention_plan.cuh"
SMEM_OPTIN = 232_448      # bytes of shared memory a CTA may opt in to on an H100
SMS = 132                 # an H100's SMs
L_MAX = DH_MAX = 128
ESIZES = {"f32": 4, "bf16": 2}

SCAN = r"""
#include "HEADER"
// every (Lq, Lk, Dh) in [1, 128]^3, index ((Lq - 1) * 128 + Lk - 1) * 128 + Dh - 1
extern "C" void scan_fwd(long long N, int esize, int sms, long long* smem, int* warps) {
  for (int lq = 1; lq <= 128; ++lq)
    for (int lk = 1; lk <= 128; ++lk)
      for (int dh = 1; dh <= 128; ++dh) {
        const attn_plan::FwdPlan p = attn_plan::fwd_plan(N, lq, lk, dh, esize, sms);
        const long i = ((lq - 1) * 128L + lk - 1) * 128 + dh - 1;
        smem[i] = p.smem;
        warps[i] = p.warps;
      }
}
extern "C" void scan_bwd(int esize, long long limit, long long* smem, int* planes) {
  for (int lq = 1; lq <= 128; ++lq)
    for (int lk = 1; lk <= 128; ++lk)
      for (int dh = 1; dh <= 128; ++dh) {
        const attn_plan::BwdPlan p = attn_plan::bwd_plan(lq, lk, dh, esize, limit);
        const long i = ((lq - 1) * 128L + lk - 1) * 128 + dh - 1;
        smem[i] = p.smem;
        planes[i] = p.planes;
      }
}
"""

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")


def _build(tmp, name, source_path):
    so = tmp / f"lib{name}.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-o", str(so),
                    str(source_path)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("attention_plan")
    plan = ca.bind_plan(_build(tmp, "attention_plan", HEADER))
    src = tmp / "scan.cpp"
    src.write_text(SCAN.replace("HEADER", str(HEADER)))
    scan = _build(tmp, "attention_plan_scan", src)
    i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    scan.scan_fwd.argtypes = [i64, i32, i32, ptr, ptr]
    scan.scan_bwd.argtypes = [i32, i64, ptr, ptr]
    return plan, scan


def _scan(fn, *args):
    shape = (L_MAX, L_MAX, DH_MAX)
    smem, other = np.zeros(shape, np.int64), np.zeros(shape, np.int32)
    fn(*args, smem.ctypes.data, other.ctypes.data)
    return smem, other


@pytest.mark.parametrize("N", [1, 16, 64, 200, 256, 70_000])
@pytest.mark.parametrize("dtype", ESIZES)
def test_every_row_and_query_tile_is_covered_once(libs, dtype, N):
    plan_lib, _ = libs
    for Lq in list(range(1, L_MAX + 1)) + [129, 200, 1000]:
        p = ca.fwd_plan(plan_lib, N, Lq, 101, 32, ESIZES[dtype], SMS)
        assert 1 <= p["warps"] <= 8 and p["rows"] == 16 * p["warps"], p
        assert p["ctas"] == N * p["tiles"]
        # CTA y owns rows [y * rows, min(Lq, y * rows + rows)), a warp each 16
        owned = np.zeros(Lq, np.int64)
        for y in range(p["tiles"]):
            q0 = y * p["rows"]
            rows = min(p["rows"], Lq - q0)
            assert rows >= 1, (Lq, p)
            assert -(-rows // 16) <= p["warps"]
            owned[q0:q0 + rows] += 1
        assert (owned == 1).all(), (Lq, p)


@pytest.mark.parametrize("dtype", ESIZES)
def test_forward_fills_the_card_at_small_n(libs, dtype):
    plan_lib, _ = libs
    esize = ESIZES[dtype]
    rollout = ca.fwd_plan(plan_lib, 16, 101, 101, 32, esize, SMS)   # (8, 2, 101, 32)
    assert rollout["ctas"] >= 100 and rollout["warps"] == 1, rollout
    # the encoder at bucket 128 and the update's minibatch: one CTA a row
    for N in (200, 256):
        p = ca.fwd_plan(plan_lib, N, 101, 101, 32, esize, SMS)
        assert p["tiles"] == 1 and p["warps"] == 7, p
    # between the two, the largest CTA whose grid still covers the SMs
    mid = ca.fwd_plan(plan_lib, 40, 101, 101, 32, esize, SMS)
    assert mid["ctas"] >= SMS and mid["warps"] == 2, mid
    # SMAC's short rows stay in one CTA a row whatever N: 8 agents one warp,
    # 27 agents two
    for N, L, warps, tiles in ((64, 8, 1, 1), (6400, 8, 1, 1), (72, 27, 2, 1),
                               (7200, 27, 2, 1)):
        p = ca.fwd_plan(plan_lib, N, L, L, 32, esize, SMS)
        assert (p["warps"], p["tiles"]) == (warps, tiles), (N, L, p)


@pytest.mark.parametrize("N", [1, 16, 256])
@pytest.mark.parametrize("dtype", ESIZES)
def test_forward_shared_memory_fits_at_every_shape(libs, dtype, N):
    plan_lib, scan = libs
    esize = ESIZES[dtype]
    static = plan_lib.mat_attention_static_smem()
    smem, warps = _scan(scan.scan_fwd, N, esize, SMS)
    assert smem.max() + static <= SMEM_OPTIN, smem.max()
    assert warps.min() >= 1 and warps.max() <= 8
    # Q rows of the CTA, then K and V planes of whole 16-key pairs
    lq, lk, dh = np.meshgrid(np.arange(1, 129), np.arange(1, 129), np.arange(1, 129),
                             indexing="ij")
    depth = 8 if esize == 4 else 16
    ld = -(-dh // depth) * depth + 16 // esize
    want = esize * (16 * warps + 2 * (-(-lk // 16) * 16)) * ld
    assert (smem == want).all()


@pytest.mark.parametrize("dtype", ESIZES)
def test_backward_shared_memory_fits_at_every_shape(libs, dtype):
    plan_lib, scan = libs
    esize = ESIZES[dtype]
    static = plan_lib.mat_attention_static_smem()
    limit = SMEM_OPTIN - static
    smem, planes = _scan(scan.scan_bwd, esize, limit)
    assert smem.max() <= limit, smem.max()
    assert set(np.unique(planes)) <= {2, 4}
    # two planes only where four do not fit: the largest L and Dh
    four = _scan(scan.scan_bwd, esize, 1 << 40)[0]
    assert ((planes == 2) == (four > limit)).all()
    if esize == 2:
        lq, lk, dh = (int(x) + 1 for x in np.argwhere(planes == 2).min(axis=0))
        assert min(lq, lk, dh) > 100, (lq, lk, dh)
    # the update's shape keeps four planes
    assert planes[100, 100, 31] == 4


@pytest.mark.parametrize("dtype", ESIZES)
@pytest.mark.parametrize("Lq,Lk,Dh", [(101, 101, 32), (8, 8, 32), (27, 27, 32), (128, 128, 128),
                                      (113, 128, 128), (1, 101, 32), (17, 5, 8)])
def test_backward_layout_adds_up_and_rows_avoid_bank_conflicts(libs, dtype, Lq, Lk, Dh):
    plan_lib, _ = libs
    esize = ESIZES[dtype]
    p = ca.bwd_plan(plan_lib, Lq, Lk, Dh, esize, SMEM_OPTIN - plan_lib.mat_attention_static_smem())
    depth = 8 if esize == 4 else 16
    lq, lk = -(-Lq // depth) * depth, -(-Lk // depth) * depth
    rows = max(lq, lk) if p["planes"] == 2 else lq + lk
    planes = esize * 2 * rows * p["ld"]
    if esize == 4:
        want = 4 * 3 * (-(-Lq // 32) * 32) + planes
    else:
        # P, dS's high and low halves: query rows (padded to 8) by key
        # columns (+ 8 pad); two CTAs an SM at the update's shape
        assert p["ldp"] == lk + 8
        want = planes + 3 * 2 * (-(-Lq // 8) * 8) * p["ldp"]
        if (Lq, Lk, Dh) == (101, 101, 32):
            assert 2 * (p["smem"] + 1024 + plan_lib.mat_attention_static_smem()) <= 228 * 1024
    assert p["smem"] == want, p
    assert p["warps"] == min(8, max(-(-Lq // 16), -(-Lk // 16)))
    # a row of an odd number of 16-byte units: the 8 rows of an ldmatrix
    # (or a quad's scalar loads) fall on distinct banks
    assert (p["ld"] * esize) % 32 == 16
    assert (p["ldp"] * 2) % 32 == 16


@pytest.mark.parametrize("causal,kind", [(False, None), (True, None), (False, "per_batch"),
                                         (True, "per_batch"), (True, "no_visible_key")])
def test_plain_row_statistics_are_the_xla_softmax_max_and_sum(causal, kind):
    """The row statistics of the plain path (what the forward kernel writes
    and the bf16 backward reads) against the f32 softmax of JAX's XLA path:
    the max of its masked scores and the sum of exp(score - max), which
    give back the XLA path's probabilities (read through v = identity)."""
    B, H, L, Dh = 3, 2, 12, 8
    rng = np.random.default_rng(11 + causal)
    q, k = (rng.normal(size=(B, H, L, Dh)).astype(np.float32) for _ in range(2))
    mask = None
    if kind == "per_batch":
        mask = rng.uniform(size=(B, L)) > 0.4
        mask[:, 0] = True
    elif kind == "no_visible_key":
        mask = np.ones((B, L), bool)
        mask[0, :5] = False    # batch 0's rows 0-4 see no valid key
        mask[2] = False        # batch 2 has none at all
    tm = None if mask is None else torch.from_numpy(mask)
    stats = ca.attention_stats_plain(torch.from_numpy(q), torch.from_numpy(k), causal=causal,
                                     kv_mask=tm).numpy().reshape(2, B, H, L)
    jm = None if mask is None else jnp.asarray(mask)
    # JAX's masked f32 scores, as multi_head_attention's XLA path forms them
    att = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32) * (
        1.0 / jnp.sqrt(jnp.asarray(Dh, jnp.float32)))
    if causal:
        att = jnp.where(jnp.tril(jnp.ones((L, L), bool))[None, None], att, -1e9)
    if jm is not None:
        att = jnp.where(jm[:, None, None, :], att, -1e9)
    mx = np.asarray(att.max(-1))
    total = np.asarray(jnp.exp(att - att.max(-1, keepdims=True)).sum(-1))
    # f32 summation order only (the scores' dot products)
    np.testing.assert_allclose(stats[0], mx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(stats[1], total, rtol=1e-5)
    # exp(score - max) / sum from these statistics is the XLA path's softmax
    eye = jnp.broadcast_to(jnp.eye(L, dtype=jnp.float32), (B, H, L, L))
    probs = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), eye, causal=causal, kv_mask=jm,
                               impl="xla"))
    ours = np.exp(np.asarray(att) - stats[0][..., None]) / stats[1][..., None]
    np.testing.assert_allclose(ours, probs, atol=1e-6)
    if kind == "no_visible_key":
        assert (stats[0][2] == np.float32(-1e9)).all() and (stats[1][2] == L).all()
