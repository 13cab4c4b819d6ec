"""Plain versions of the port's temporal deformable-attention kernels (K1-K3)
and its plain MSDA against the JAX package: the Pallas kernels in interpret
mode, and the dense numpy oracle. f32 throughout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_tpu.ops.ms_deform_attn import ms_deform_attn_dense_reference
from devis_tpu.ops.ms_deform_attn_pallas import (
    S_TILE, _row_ranges_proj, ms_deform_attn_temporal,
    ms_deform_attn_temporal_proj)
from devis_torch.ops import _build
from devis_torch.ops import ms_deform_attn_cuda as K
from devis_torch.ops.ms_deform_attn import (ms_deform_attn, rule_window,
                                            temporal_frame_table)

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = ((12, 16), (6, 8), (3, 4))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)
RULES = [("all",), ("window", (-1, 1))]


@pytest.fixture(autouse=True)
def _no_tf32():
    # references run in full f32 (cuDNN convolutions default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _proj_inputs(rng, rule, T=3, Q=40, M=2, D=16, P=2):
    """q-major K1 inputs: offsets in pixels (std 3, so taps land off the grid
    and some outside the map), logits N(0, 1)."""
    W = rule_window(rule, T)
    return dict(
        value=rng.rand(T, S, M, D).astype(np.float32),
        ref=rng.rand(T, Q, L, 2).astype(np.float32),
        c_off=(rng.randn(T, Q, M * L * P * 2) * 3).astype(np.float32),
        t_off=(rng.randn(T, Q, M * W * L * P * 2) * 3).astype(np.float32),
        c_logit=rng.randn(T, Q, M * L * P).astype(np.float32),
        t_logit=rng.randn(T, Q, M * W * L * P).astype(np.float32))


def _tiled(x, q_pad, q_tile=128, fill=0.0):
    """q-major (T, Q, C) → the JAX op's pre-tiled (T, nqt, C, q_tile), with
    padded queries set to `fill`."""
    T, Q, C = x.shape
    x = np.concatenate([x, np.full((T, q_pad - Q, C), fill, x.dtype)], 1)
    return jnp.asarray(x.reshape(T, q_pad // q_tile, q_tile, C).transpose(0, 1, 3, 2))


def _jax_proj_args(a, q_pad):
    """Port inputs → (rx, ry, cx, cy, tx, ty, ca, ta) of the JAX op; padded
    queries carry reference -10, as the JAX encoder pads them."""
    ref = a["ref"]
    return (_tiled(ref[..., 0], q_pad, fill=-10.0), _tiled(ref[..., 1], q_pad, fill=-10.0),
            _tiled(a["c_off"][..., 0::2], q_pad), _tiled(a["c_off"][..., 1::2], q_pad),
            _tiled(a["t_off"][..., 0::2], q_pad), _tiled(a["t_off"][..., 1::2], q_pad),
            _tiled(a["c_logit"], q_pad), _tiled(a["t_logit"], q_pad))


def _t(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


@pytest.mark.parametrize("rule", RULES)
def test_temporal_proj_plain_matches_pallas(rng, rule):
    a = _proj_inputs(rng, rule)
    Q = a["ref"].shape[1]
    want = ms_deform_attn_temporal_proj(jnp.asarray(a["value"]), SHAPES,
                                        *_jax_proj_args(a, 128), Q, rule)
    t = _t(a)
    got = K.msda_temporal_proj_plain(t["value"], SHAPES, t["ref"], t["c_off"], t["t_off"],
                                     t["c_logit"], t["t_logit"], rule)
    # f32, same location arithmetic; summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_temporal_proj_wrapper_runs_plain_on_cpu(rng):
    t = _t(_proj_inputs(rng, ("all",)))
    before = (K.msda_temporal_proj.plain_calls, K.msda_temporal_proj.launches)
    out = K.msda_temporal_proj(t["value"], SHAPES, t["ref"], t["c_off"], t["t_off"],
                               t["c_logit"], t["t_logit"], ("all",))
    want = K.msda_temporal_proj_plain(t["value"], SHAPES, t["ref"], t["c_off"],
                                      t["t_off"], t["c_logit"], t["t_logit"], ("all",))
    assert torch.equal(out, want)
    assert (K.msda_temporal_proj.plain_calls, K.msda_temporal_proj.launches) == \
        (before[0] + 1, before[1])


# the decoder's head geometry: M 8, D 32, P 4, T 6; four levels (Lf 24 under
# the rule "all")
DEC_SHAPES = ((12, 16), (6, 8), (3, 4), (2, 2))


@pytest.mark.parametrize("geometry", ["small", "decoder"])
@pytest.mark.parametrize("rule", RULES)
def test_temporal_plain_matches_pallas(rng, rule, geometry):
    shapes, (T, Q, M, D, P) = ((SHAPES, (3, 10, 2, 16, 2)) if geometry == "small"
                               else (DEC_SHAPES, (6, 3, 8, 32, 4)))
    n_rows = sum(h * w for h, w in shapes)
    Lf = (1 + rule_window(rule, T)) * len(shapes)
    value = rng.rand(T, n_rows, M, D).astype(np.float32)
    loc = (rng.rand(T, Q, M, Lf, P, 2) * 1.2 - 0.1).astype(np.float32)
    att = rng.rand(T, Q, M, Lf, P).astype(np.float32)
    want = ms_deform_attn_temporal(jnp.asarray(value), shapes, jnp.asarray(loc),
                                   jnp.asarray(att), rule)
    got = K.msda_temporal(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                          torch.from_numpy(att), rule)
    # f32; summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_msda_matches_dense_oracle(rng):
    B, Q, M, D, P = 2, 30, 4, 8, 3
    value = rng.rand(B, S, M, D).astype(np.float32)
    loc = (rng.rand(B, Q, M, L, P, 2) * 1.2 - 0.1).astype(np.float32)
    att = rng.rand(B, Q, M, L, P).astype(np.float32)
    want = ms_deform_attn_dense_reference(value, SHAPES, loc, att)
    got = ms_deform_attn(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                         torch.from_numpy(att))
    # f32 against a float64 oracle
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rule", RULES)
def test_tap_window_covers_live_taps_tightly(rng, rule):
    """Brute force: every in-bounds bilinear corner of every live tap of a
    q-block, per level; the window is exactly its first and last row."""
    a = _proj_inputs(rng, rule, Q=150)
    t = _t(a)
    M = 2
    got = K.msda_tap_window(SHAPES, t["ref"], t["c_off"], t["t_off"], M).numpy()
    loc = K.temporal_proj_locations(SHAPES, t["ref"], t["c_off"], t["t_off"], M).numpy()
    T, Q, _, Lf, P, _ = loc.shape
    nqb = got.shape[2]
    assert got.shape == (T, M, -(-Q // K.Q_BLOCK), Lf, 2)
    n_live = 0
    for lvl in range(Lf):
        h, w = SHAPES[lvl % L]
        x = loc[:, :, :, lvl, :, 0] * np.float32(w) - np.float32(0.5)
        y = loc[:, :, :, lvl, :, 1] * np.float32(h) - np.float32(0.5)
        x0, y0 = np.floor(x), np.floor(y)
        for tt in range(T):
            for m in range(M):
                for b in range(nqb):
                    sl = slice(b * K.Q_BLOCK, (b + 1) * K.Q_BLOCK)
                    rows = []
                    for oy in (0, 1):
                        for ox in (0, 1):
                            yi, xi = y0[tt, sl, m] + oy, x0[tt, sl, m] + ox
                            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                            rows.append((yi * w + xi)[ok])
                    rows = np.concatenate(rows)
                    first, last = got[tt, m, b, lvl]
                    if rows.size == 0:
                        assert (first, last) == (0, -1)
                    else:
                        n_live += 1
                        assert (first, last) == (rows.min(), rows.max())
    assert n_live > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", RULES)
def test_tap_window_matches_pallas_ranges(rng, rule, dtype):
    """Against `_row_ranges_proj` at the shared q-block of 128: JAX's windows
    are in parity-packed rows (row // 2), 8-aligned, counted in S_TILE
    tiles; the port's rows converted the same way must agree. bf16: the
    offsets as the clip path feeds K2, the same bf16 values to both."""
    a = _proj_inputs(rng, rule, Q=150)
    t = _t(a)
    for k in ("c_off", "t_off"):
        t[k] = t[k].to(dtype)
        a[k] = t[k].float().numpy()
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    T, Q = a["ref"].shape[:2]
    M, P = 2, 2
    W = rule_window(rule, T)
    q_pad = 256

    def rows(x, n):                          # (T, Q, M*n*P) → (T*M, n*P, q_pad)
        x = x.reshape(T, Q, M, n * P).transpose(0, 2, 3, 1).reshape(T * M, n * P, Q)
        return jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, q_pad - Q)))).astype(jdtype)

    def refs(x):
        return jnp.asarray(np.pad(x.transpose(0, 2, 1), ((0, 0), (0, 0), (0, q_pad - Q)),
                                  constant_values=-10.0))

    want = np.asarray(_row_ranges_proj(
        refs(a["ref"][..., 0]), refs(a["ref"][..., 1]),
        rows(a["c_off"][..., 0::2], L), rows(a["c_off"][..., 1::2], L),
        rows(a["t_off"][..., 0::2], W * L), rows(a["t_off"][..., 1::2], W * L),
        SHAPES, 1 + W, 128, S_TILE))
    got = K.msda_tap_window(SHAPES, t["ref"], t["c_off"], t["t_off"], M).numpy()
    first, last = got[..., 0], got[..., 1]
    base = (first // 2 // 8) * 8
    count = (last // 2 - base) // S_TILE + 1
    live = last >= 0
    port = np.stack([np.where(live, base, 0), np.where(live, count, 0)], -1)
    np.testing.assert_array_equal(port.reshape(want.shape), want)
    assert live.any()


def _k2_reads(Q, M, W, L, P, plan, q_block=K.Q_BLOCK):
    """The offset pairs K2's threads read under `plan`, by the kernel's index
    arithmetic (`msda_tap_window_kernel`): per (query, pair of a c_off row)
    and (query, pair of a t_off row) the number of reads. Asserts that each
    read's (head, stage) key, which decides where the thread reduces it, is
    the pair's own and the same for all pairs of a load (the kernel keeps
    the first pair's)."""
    G, threads, VP = plan
    LP = L * P
    nc = G * LP
    vq = (1 + W) * nc // VP
    span = min(vq, threads)
    qpp = threads // span
    c_reads = np.zeros((Q, M * LP), int)
    t_reads = np.zeros((Q, M * W * LP), int)
    tid = np.arange(threads)
    for qb in range(-(-Q // q_block)):
        q0 = qb * q_block
        nq = min(q_block, Q - q0)
        for g in range(M // G):
            for p0 in range(0, vq, span):
                pos, ql0 = p0 + tid % span, tid // span
                act = (pos < vq) & (ql0 < qpp)
                pos, ql0 = pos[act], ql0[act]
                pr = pos * VP
                cur = pr < nc
                keys = []
                for s in range(VP):
                    e = pr + s
                    et = np.where(cur, 0, e - nc)
                    gm_t = et // max(W * LP, 1)
                    r = et - gm_t * W * LP
                    jj = r // LP
                    gm = np.where(cur, e // LP, gm_t)
                    lv = np.where(cur, (e - (e // LP) * LP) // P, (r - jj * LP) // P)
                    st = np.where(cur, lv, (1 + jj) * L + lv)
                    # what lies at the element the kernel reads
                    col = np.where(cur, g * G * LP + e, g * G * W * LP + et)
                    m_true = np.where(cur, col // LP, col // max(W * LP, 1))
                    j_true = np.where(cur, 0, 1 + (col % max(W * LP, 1)) // LP)
                    l_true = (col % LP) // P
                    assert (m_true == g * G + gm).all()
                    assert (st == j_true * L + l_true).all()
                    keys.append(gm * (1 + W) * L + st)
                    for k in range(-(-q_block // qpp) + 1):   # the unrolled loop's queries
                        qq = ql0 + k * qpp
                        ok = qq < nq
                        np.add.at(c_reads, (q0 + qq[ok & cur], col[ok & cur]), 1)
                        np.add.at(t_reads, (q0 + qq[ok & ~cur], col[ok & ~cur]), 1)
                # the kernel keeps the first pair's key for all pairs of a load
                assert all((k == keys[0]).all() for k in keys)
    return c_reads, t_reads


K2_MAX_THREADS = _build.source_define("ms_deform_attn", "K2_MAX_THREADS")


@pytest.mark.parametrize("M,W,L,P,dtype,aligned", [
    (8, 5, 4, 4, torch.bfloat16, True),    # the clip encoder
    (8, 5, 4, 4, torch.float32, True),
    (8, 0, 4, 4, torch.bfloat16, True),    # F = 1, the image encoder
    (8, 5, 4, 4, torch.bfloat16, False),   # offsets off 16 bytes: one pair a load
    (2, 2, 3, 2, torch.float32, True),     # the card tests' shapes
    (2, 2, 3, 3, torch.bfloat16, True),    # 16-byte loads impossible
    (2, 5, 4, 24, torch.float32, False),   # a query's loads outnumber the threads
    (1, 1, 1, 1, torch.float32, True)])
def test_tap_window_plan_reads_every_offset_once(M, W, L, P, dtype, aligned):
    """K2's launch geometry (`tap_window_plan`): over the blocks (t-free),
    threads, passes and unrolled queries, every offset pair of every query
    (a full and a partial q-block) is read exactly once, and reduced under
    its own head and stage."""
    plan = K.tap_window_plan(M, W, L, P, dtype, aligned)
    G, n_threads, VP = plan
    assert M % G == 0 and n_threads % 32 == 0 and n_threads <= K2_MAX_THREADS
    assert aligned or VP == 1
    assert VP == 1 or (2 * VP * (torch.finfo(dtype).bits // 8) == 16 and P % VP == 0)
    c_reads, t_reads = _k2_reads(K.Q_BLOCK + 37, M, W, L, P, plan)
    assert (c_reads == 1).all() and (t_reads == 1).all()
    blocks, block_threads = K.tap_window_grid(2, K.Q_BLOCK + 37, M, plan)
    assert (blocks, block_threads) == (2 * 2 * (M // G), n_threads)


def test_tap_window_plan_at_the_clip_encoder():
    """bf16 offsets of the clip encoder: 16-byte loads, whole queries' loads
    a block, and enough blocks for every SM of an H100 at Q = 5 100."""
    G, threads, VP = K.tap_window_plan(8, 5, 4, 4, torch.bfloat16)
    assert VP == 4
    vq = 6 * G * 16 // VP
    assert threads % vq < 32 and threads <= K2_MAX_THREADS
    assert K.tap_window_grid(6, 5100, 8, (G, threads, VP))[0] >= 132


@pytest.mark.parametrize("ntap,D,dtype", [
    (96, 32, torch.bfloat16), (96, 32, torch.float32), (96, 16, torch.bfloat16),
    (48, 5, torch.float32), (18, 12, torch.bfloat16), (24, 1, torch.float32),
    (1, 32, torch.bfloat16)])
def test_temporal_plan_takes_every_tap_once(ntap, D, dtype):
    """K3's launch geometry (`msda_temporal_kernel`, its K3_WARPS warps and
    K3_UNROLL taps a lane read from the source; lanes a tap as its launcher
    takes them): in a (t, q, m)'s block, over warps, lane groups and
    unrolled steps, every (tap, channel) is accumulated exactly once, and
    the warps' sums name each channel once."""
    warps = _build.source_define("ms_deform_attn", "K3_WARPS")
    unroll = _build.source_define("ms_deform_attn", "K3_UNROLL")
    vec = 16 // (torch.finfo(dtype).bits // 8)
    lanes = 1
    while lanes * vec < D:
        lanes *= 2
    seen = np.zeros((ntap, D), int)
    stored = np.zeros((warps, D), int)
    taps_a_warp = 32 // lanes
    step = warps * taps_a_warp
    for warp in range(warps):
        for lane in range(32):
            grp, c0 = lane // lanes, (lane % lanes) * vec
            for k0 in range(warp * taps_a_warp + grp, ntap, unroll * step):
                for u in range(unroll):
                    k = k0 + u * step
                    if k < ntap:
                        seen[k, c0:min(c0 + vec, D)] += 1
            if grp == 0:
                stored[warp, c0:min(c0 + vec, D)] += 1
    assert (seen == 1).all() and (stored == 1).all()


def test_frame_table_rules():
    np.testing.assert_array_equal(temporal_frame_table(("all",), 3),
                                  [[1, 2], [0, 2], [0, 1]])
    # window (-1, 1) reflects at the clip edges
    np.testing.assert_array_equal(temporal_frame_table(("window", (-1, 1)), 3),
                                  [[1, 1], [0, 2], [1, 1]])
