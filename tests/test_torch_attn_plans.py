"""Launch plans of K6 (`msda_rows_kernel`, `rows_plan`) and K8
(`msda_proj_kernel`, `proj_plan`) on the CPU: the kernels' index arithmetic
mirrored in numpy over the whole grid, at the paths' shapes and at ragged
ones. Every (b, q, m, channel) is written by exactly one thread and every
(tap, channel) of it is taken exactly once; the plans raise where nothing
fits. The kernels and this mirror change together."""
import numpy as np
import pytest
import torch

from devis_torch.ops import _build
from devis_torch.ops import ms_deform_attn_cuda as K

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _k6(name):
    return _build.source_define("ms_deform_attn_rows", name)


def _k8(name):
    return _build.source_define("ms_deform_attn_proj", name)


def _vn(dtype):
    return 16 // (torch.finfo(dtype).bits // 8)


def _chunk(plan, dtype):
    """Channels a thread: 16 bytes, or one where the plan is not `vec`."""
    return _vn(dtype) if plan.vec else 1


def _rows_units(plan, B, Q, M, blk, u):
    """`rows_unit` of the kernel: (item, slice) of unit u of block blk, item
    -1 past the edge."""
    gu = blk * plan.units + u
    n_units = B * Q * M * plan.slices
    item = np.where((u < plan.units) & (gu < n_units), gu // plan.slices, -1)
    return item, gu % plan.slices


def _step2(plan, B, Q, M, D, dtype):
    """Step 2's threads over the grid: (item, chunk, group, live)."""
    cw = _chunk(plan, dtype)
    per_unit = plan.groups * plan.lanes
    blocks = -(-B * Q * M * plan.slices // plan.units)
    tid = np.tile(np.arange(plan.threads, dtype=np.int64), blocks)
    blk = np.repeat(np.arange(blocks, dtype=np.int64), plan.threads)
    u, r = tid // per_unit, tid % per_unit
    g, c = r // plan.lanes, r % plan.lanes
    item, slc = _rows_units(plan, B, Q, M, blk, u)
    ch = slc * plan.chunks + c
    return item, ch, g, (item >= 0) & (c < plan.chunks) & (ch * cw < D)


def _group_taps(plan, taps):
    """(groups, taps) counts of the taps each group takes in the kernel's
    loop of K6_UNROLL taps a step (K6_UNROLL_ONE where a unit is one
    thread)."""
    unroll = _k6("K6_UNROLL_ONE" if plan.groups * plan.lanes == 1 else "K6_UNROLL")
    takes = np.zeros((plan.groups, taps), int)
    for grp in range(plan.groups):
        for k0 in range(0, taps, unroll * plan.groups):
            for j in range(unroll):
                if k0 + grp + j * plan.groups < taps:
                    takes[grp, k0 + grp + j * plan.groups] += 1
    return takes


def _check_rows_plan(plan, B, Q, M, D, L, P, dtype, per_channel=True):
    """Mirrors `msda_rows_kernel` over the grid: step 1 computes each tap
    of each unit once (in K6_UNROLL-deep batches of the block's threads); in
    step 2 each live (item, chunk, group) is one thread, the groups' taps
    partition the L*P taps, and group 0 writes the chunk, so each (item,
    channel) is written once and each of its taps taken once. Where not
    `per_channel` (the paths' large shapes) the writes are counted a chunk."""
    cw, taps = _chunk(plan, dtype), L * P
    n_chunks = -(-D // cw)
    per_unit = plan.groups * plan.lanes
    assert plan.units * per_unit <= plan.threads <= _k6("K6_MAX_THREADS")
    assert plan.threads % 32 == 0 and plan.chunks <= plan.lanes
    assert plan.slices * plan.chunks >= n_chunks and plan.chunks <= _k6("K6_MAX_CHUNKS")
    assert plan.groups == 1 or 32 % per_unit == 0      # a unit of groups in one warp
    n_items = B * Q * M
    blocks = -(-n_items * plan.slices // plan.units)
    if per_unit == 1:     # a unit of one thread computes its own taps (step 2)
        assert plan.smem == 0 and plan.groups == 1
    else:
        # step 1: entry i0 + j * threads of each block, j < K6_UNROLL a step
        assert plan.smem == plan.units * taps * 16 <= _k6("K6_SMEM")
        unroll, n_geo = _k6("K6_UNROLL"), plan.units * taps
        entries = np.zeros(n_geo, int)
        for t in range(plan.threads):
            for i0 in range(t, n_geo, unroll * plan.threads):
                for j in range(unroll):
                    if i0 + j * plan.threads < n_geo:
                        entries[i0 + j * plan.threads] += 1
        assert (entries == 1).all()
        i = np.arange(n_geo)
        blk = np.repeat(np.arange(blocks), n_geo)
        item, _ = _rows_units(plan, B, Q, M, blk, np.tile(i // taps, blocks))
        k = np.tile(i % taps, blocks)
        live_taps = np.bincount((item * taps + k)[item >= 0], minlength=n_items * taps)
        assert (live_taps == plan.slices).all()          # once a slice

    # step 2
    item, ch, g, live = _step2(plan, B, Q, M, D, dtype)
    for grp in range(plan.groups):
        sel = live & (g == grp)
        seen = np.bincount(item[sel] * n_chunks + ch[sel], minlength=n_items * n_chunks)
        assert (seen == 1).all(), f"group {grp}: (item, chunk) counts {np.unique(seen)}"
    assert (g[live] < plan.groups).all()
    assert (_group_taps(plan, taps).sum(0) == 1).all()
    if per_channel:   # group 0 writes channels [ch * cw, min(D, ch * cw + cw))
        wrote = np.zeros((n_items, D), int)
        for it, cc in zip(item[live & (g == 0)], ch[live & (g == 0)]):
            wrote[it, cc * cw:min(D, cc * cw + cw)] += 1
        assert (wrote == 1).all()


# (D, dtype, aligned, M, L, P, B, Q)
RAGGED = [
    (1, torch.bfloat16, True, 1, 9, 1, 2, 13 * 21),       # D 1: one channel a thread
    (5, torch.float32, True, 1, 9, 1, 3, 7 * 5),          # D 5: one channel a thread
    (5, torch.bfloat16, True, 2, 3, 2, 2, 33),
    (16, torch.bfloat16, True, 1, 9, 1, 1, 19 * 23),
    (16, torch.float32, False, 1, 9, 1, 1, 37),           # unaligned rows
    (33, torch.bfloat16, True, 1, 9, 1, 2, 11 * 9),
    (33, torch.float32, True, 2, 3, 2, 2, 40),
    (264, torch.bfloat16, True, 1, 9, 1, 1, 12 * 20),
    (264, torch.float32, False, 1, 9, 1, 2, 7),           # 264 channels one a thread: 2 slices
    (72, torch.float32, True, 1, 3, 2, 2, 40),
    (32, torch.bfloat16, True, 8, 4, 4, 1, 301),          # image decoder, Q ragged
    (32, torch.float32, True, 8, 4, 4, 2, 299),
    (2200, torch.bfloat16, True, 1, 2, 1, 1, 5),          # 275 chunks: two slices
    (4104, torch.float32, True, 2, 1, 3, 1, 3),           # 1026 chunks: five slices
    (8, torch.bfloat16, True, 1, 16, 7, 1, 9),            # 112 taps a unit
]


@pytest.mark.parametrize("D,dtype,aligned,M,L,P,B,Q", RAGGED)
def test_rows_plan_writes_every_channel_once(D, dtype, aligned, M, L, P, B, Q):
    plan = K.rows_plan(D, dtype, aligned, M, L, P, B * Q)
    assert plan.vec == (aligned and D % _vn(dtype) == 0)
    _check_rows_plan(plan, B, Q, M, D, L, P, dtype)


def _value_head(item, M, G, Q):
    """`msda_rows_kernel`'s decode of a unit's item (b * Q + q) * M * G + mg
    into its batch entry and value head."""
    return item // (M * G * Q), (item % (M * G)) // G


@pytest.mark.parametrize("G,M,D,P", [(2, 1, 32, 2), (4, 1, 16, 1), (4, 2, 264, 1),
                                     (2, 8, 32, 4)])
def test_rows_plan_with_grouped_heads(G, M, D, P):
    """Grouped heads (MG = G * M query heads): the plan and the write
    coverage are those of MG heads; each unit reads value head mg // G of
    its own batch entry, as the plain version's repeated heads do."""
    B, Q, Lv = 2, 23, 3
    plan = K.rows_plan(D, torch.bfloat16, True, M * G, Lv, P, B * Q)
    _check_rows_plan(plan, B, Q, M * G, D, Lv, P, torch.bfloat16)
    item = np.arange(B * Q * M * G)
    b, m = _value_head(item, M, G, Q)
    bq, mg = item // (M * G), item % (M * G)
    assert (b == bq // Q).all() and (m == mg // G).all() and (m < M).all()
    plain = torch.arange(M).repeat_interleave(G)           # ms_deform_attn's repeat
    assert (plain[torch.from_numpy(mg)].numpy() == m).all()


CLIP_DCN = (("lay1", 264, 12, 20), ("lay2", 128, 12, 20), ("lay3", 64, 24, 40),
            ("lay4", 32, 48, 80), ("lay5", 16, 96, 160), ("out_lay", 1, 96, 160))
COCO_DCN = (("lay1", 264, 26, 42), ("lay2", 128, 26, 42), ("lay3", 64, 52, 84),
            ("lay4", 32, 104, 168), ("lay5", 16, 208, 336), ("out_lay", 1, 208, 336))


@pytest.mark.parametrize("B,layers", [(60, CLIP_DCN), (50, COCO_DCN)], ids=["clip", "image"])
def test_rows_plan_at_the_mask_heads(B, layers):
    """The DCN route's six layers (M 1, 9 one-point levels) at the clip's
    60 masks and the image's 50, in bf16: no idle lane at D 264 (33
    chunks, one group), enough threads for the card, every chunk of every
    pixel written once."""
    for name, D, h, w in layers:
        plan = K.rows_plan(D, torch.bfloat16, True, 1, 9, 1, B * h * w)
        if D == 264:
            assert (plan.lanes, plan.groups, plan.slices) == (33, 1, 1)
        assert B * h * w * plan.groups * plan.lanes >= _k6("K6_FILL_THREADS"), name
        _check_rows_plan(plan, B, h * w, 1, D, 9, 1, torch.bfloat16, per_channel=False)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_plan_at_the_image_decoder(B, dtype):
    """The image decoder (M 8, D 32, L 4, P 4, Q 300, 1 or 2 images): too few
    queries to fill the card a thread a chunk, so a unit's 16 taps spread
    over the whole warp."""
    plan = K.rows_plan(32, dtype, True, 8, 4, 4, B * 300)
    assert plan.groups * plan.lanes == 32 and plan.groups > 1 and plan.vec
    _check_rows_plan(plan, B, 300, 8, 32, 4, 4, dtype)


def test_rows_plan_raises_where_nothing_fits():
    """One unit's taps must fit the kernel's shared memory where a unit
    takes several threads; a unit of one thread keeps its taps in
    registers."""
    most = _k6("K6_SMEM") // 16
    K.rows_plan(8, torch.float32, True, 1, 16, most // 16, 10)
    with pytest.raises(ValueError, match="no shared memory"):
        K.rows_plan(8, torch.float32, True, 1, 16, most // 16 + 1, 10)
    one = K.rows_plan(1, torch.float32, True, 1, 16, most // 16 + 1, 10 ** 6)
    assert one.groups * one.lanes == 1 and one.smem == 0


def _check_proj_plan(plan, B, Q, M, D, L, P, dtype):
    """Mirrors `msda_proj_kernel`: warps of K8_THREADS-thread blocks, one
    (b, q, m) each; lane t owns tap base + t; group grp takes every
    (32 / lanes)-th tap of a run of 32 in K8_UNROLL steps; group 0 writes."""
    vn, n = _chunk(plan, dtype), L * P
    threads, unroll = _k8("K8_THREADS"), _k8("K8_UNROLL")
    items = B * Q * M
    blocks = -(-items * 32 // threads)
    warp = (np.arange(blocks)[:, None] * threads + np.arange(threads)[None, :]) >> 5
    warps = np.unique(warp[warp < items])
    assert (warps == np.arange(items)).all()       # each item one whole warp
    assert plan.lanes * vn >= D and 32 % plan.lanes == 0
    tpw = 32 // plan.lanes
    n_chunks = -(-D // vn)
    took = np.zeros((n, n_chunks), int)
    owned = np.zeros(n, int)
    wrote = np.zeros(D, int)
    for lane in range(32):
        grp, c0 = lane // plan.lanes, lane % plan.lanes * vn
        for base in range(0, n, 32):
            if base + lane < n:
                owned[base + lane] += 1
            cnt = min(32, n - base)
            for j0 in range(0, cnt, unroll * tpw):
                for u in range(unroll):
                    j = j0 + grp + u * tpw
                    if j < cnt and c0 < D:
                        took[base + j, c0 // vn] += 1
        if grp == 0 and c0 < D:
            wrote[c0:min(D, c0 + vn)] += 1
    assert (owned == 1).all() and (took == 1).all() and (wrote == 1).all()


@pytest.mark.parametrize("D,dtype,aligned,M,L,P,B,Q", [
    (32, torch.bfloat16, True, 8, 4, 4, 1, 23205),    # the image encoder, one image
    (32, torch.bfloat16, True, 8, 4, 4, 2, 23205),    # the image train step's two
    (32, torch.bfloat16, True, 8, 4, 4, 1, 300),      # decoder layer 0
    (32, torch.float32, True, 8, 4, 4, 1, 37),        # Q not a multiple of the block
    (5, torch.float32, True, 1, 3, 3, 2, 9),          # scalar path
    (16, torch.bfloat16, False, 2, 3, 2, 2, 150),     # unaligned value: scalar path
    (1, torch.bfloat16, True, 3, 16, 3, 1, 5),        # 48 taps: two runs of 32
    (24, torch.bfloat16, True, 4, 1, 1, 1, 3),        # 3 chunks in 4 lanes
])
def test_proj_plan_takes_every_tap_once(D, dtype, aligned, M, L, P, B, Q):
    plan = K.proj_plan(D, dtype, aligned)
    assert plan.vec == (aligned and D % _vn(dtype) == 0)
    _check_proj_plan(plan, B, Q, M, D, L, P, dtype)


def test_proj_plan_raises_past_one_warp():
    K.proj_plan(256, torch.bfloat16, True)
    with pytest.raises(ValueError, match="one warp"):
        K.proj_plan(264, torch.bfloat16, True)
