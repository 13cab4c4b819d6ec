"""Temporal deformable-attention kernels (K1-K3) and their plain versions.

The port's counterpart of `devis_tpu/ops/ms_deform_attn_pallas.py`. Each
public op takes the JAX package's q-major layout and dispatches on where its
tensors lie: on the CPU it runs the plain PyTorch version; on a CUDA device it
launches the hand-written kernel from `csrc/ms_deform_attn.cu` or raises.
`launches` counts kernel launches and `plain_calls` CPU dispatches, per op.

  * K1 `msda_temporal_proj` (encoder; replaces `_fwd_kernel_temporal_proj`):
    value (T, S, M, D), per-level references (T, Q, L, 2) and the raw outputs
    of the four projections: current offsets (T, Q, M*L*P*2), temporal
    offsets (T, Q, M*W*L*P*2), current logits (T, Q, M*L*P), temporal
    logits (T, Q, M*W*L*P). Locations = ref + off / (w_l, h_l) with the
    temporal reference pinned to level 0; weights = one softmax per
    (t, q, m) over the current and temporal logits together.
  * K2 `msda_tap_window` (replaces `_ranges_proj_kernel`): per
    (t, m, q-block, level) the first and last raster row of the level that a
    live K1 tap touches, (0, -1) where none does. Unpacked rows, q-blocks of
    `Q_BLOCK`. The main path does not consume it yet: K1 gathers directly.
  * K3 `msda_temporal` (decoder; replaces `_fwd_kernel_temporal`):
    precomputed loc (T, Q, M, Lf, P, 2) and att (T, Q, M, Lf, P) over the
    fused level stack.

Levels run frame-major: the current frame's L levels, then L levels for each
of the W frames the rule names (`temporal_frame_rule`). The value is read per
frame; no stacked copy is made.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ms_deform_attn import (Shapes, ms_deform_attn_temporal_plain,
                             normalize_shapes, rule_window)

Q_BLOCK = 128
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_LEVELS = 8
_MAX_WINDOW = 16


def _inv(spatial_shapes: Shapes, device):
    # f32 reciprocals of the level sizes, as the kernels compute them
    inv_w = torch.tensor([1.0 / w for _, w in spatial_shapes], dtype=torch.float32,
                         device=device)
    inv_h = torch.tensor([1.0 / h for h, _ in spatial_shapes], dtype=torch.float32,
                         device=device)
    return inv_w, inv_h


def temporal_proj_locations(spatial_shapes, ref, c_off, t_off, n_heads: int):
    """(T, Q, M, Lf, P, 2) f32 locations from references and raw offsets,
    with the same f32 operations as K1 and K2."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    T, Q, L, _ = ref.shape
    M = n_heads
    P = c_off.shape[-1] // (M * L * 2)
    W = t_off.shape[-1] // (M * L * P * 2)
    inv_w, inv_h = _inv(spatial_shapes, ref.device)
    ref = ref.float()
    co = c_off.float().reshape(T, Q, M, L, P, 2)
    to = t_off.float().reshape(T, Q, M, W, L, P, 2)
    lx_c = ref[:, :, None, :, None, 0] + co[..., 0] * inv_w[:, None]
    ly_c = ref[:, :, None, :, None, 1] + co[..., 1] * inv_h[:, None]
    r0 = ref[:, :, 0]                                    # level-0 reference
    lx_t = r0[:, :, None, None, None, None, 0] + to[..., 0] * inv_w[:, None]
    ly_t = r0[:, :, None, None, None, None, 1] + to[..., 1] * inv_h[:, None]
    loc_c = torch.stack([lx_c, ly_c], -1)
    loc_t = torch.stack([lx_t, ly_t], -1).reshape(T, Q, M, W * L, P, 2)
    return torch.cat([loc_c, loc_t], dim=3)


def temporal_proj_weights(c_logit, t_logit, n_heads: int, n_levels: int):
    """(T, Q, M, Lf, P) f32 joint softmax of current and temporal logits."""
    T, Q, _ = c_logit.shape
    M = n_heads
    logits = torch.cat([c_logit.float().reshape(T, Q, M, -1),
                        t_logit.float().reshape(T, Q, M, -1)], dim=-1)
    P = c_logit.shape[-1] // (M * n_levels)
    return torch.softmax(logits, dim=-1).reshape(T, Q, M, -1, P)


def msda_temporal_proj_plain(value, spatial_shapes, ref, c_off, t_off,
                             c_logit, t_logit, rule):
    """Plain K1: the rows are built in PyTorch, then sampled."""
    M = value.shape[2]
    loc = temporal_proj_locations(spatial_shapes, ref, c_off, t_off, M)
    att = temporal_proj_weights(c_logit, t_logit, M, len(spatial_shapes))
    return ms_deform_attn_temporal_plain(value, spatial_shapes, loc, att, rule)


def msda_tap_window_plain(spatial_shapes, ref, c_off, t_off, n_heads: int,
                          q_block: int = Q_BLOCK):
    """Plain K2 → (T, M, n_qblocks, Lf, 2) int32 [first, last] rows."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    loc = temporal_proj_locations(spatial_shapes, ref, c_off, t_off, n_heads)
    T, Q, M, Lf, P, _ = loc.shape
    L = len(spatial_shapes)
    nqb = -(-Q // q_block)
    big = torch.iinfo(torch.int32).max
    firsts, lasts = [], []
    for lvl in range(Lf):
        h, w = spatial_shapes[lvl % L]
        x = loc[:, :, :, lvl, :, 0] * w - 0.5                 # (T, Q, M, P)
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        live = (x > -1) & (x < w) & (y > -1) & (y < h)
        x0 = torch.floor(torch.where(live, x, 0.0)).long()
        y0 = torch.floor(torch.where(live, y, 0.0)).long()
        lo = y0.clamp(0, h - 1) * w + x0.clamp(0, w - 1)
        hi = (y0 + 1).clamp(0, h - 1) * w + (x0 + 1).clamp(0, w - 1)
        lo = torch.where(live, lo, big)
        hi = torch.where(live, hi, -1)
        pad = nqb * q_block - Q
        lo = torch.nn.functional.pad(lo, (0, 0, 0, 0, 0, pad), value=big)
        hi = torch.nn.functional.pad(hi, (0, 0, 0, 0, 0, pad), value=-1)
        lo = lo.reshape(T, nqb, q_block, M, P).amin(dim=(2, 4))  # (T, nqb, M)
        hi = hi.reshape(T, nqb, q_block, M, P).amax(dim=(2, 4))
        firsts.append(torch.where(hi >= 0, lo, 0))
        lasts.append(hi)
    out = torch.stack([torch.stack(firsts, -1), torch.stack(lasts, -1)], -1)
    return out.permute(0, 2, 1, 3, 4).to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------

def _check_cuda(name, device, tensors, dtype):
    for t in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")


def _check_geometry(name, spatial_shapes, D, W):
    if len(spatial_shapes) > _MAX_LEVELS:
        raise ValueError(f"{name}: at most {_MAX_LEVELS} levels")
    if D > 32:
        raise ValueError(f"{name}: head dim {D} > 32 is not supported")
    if W > _MAX_WINDOW:
        raise ValueError(f"{name}: at most {_MAX_WINDOW} temporal frames")


def _rule_args(rule):
    offsets = () if rule[0] == "all" else rule[1]
    return int(rule[0] == "all"), _build.int_array(offsets)


def _function(name: str, n_ptrs: int, n_ints: int):
    """A C entry of `csrc/ms_deform_attn.cu`, typed: `n_ptrs` device
    pointers, `n_ints` ints, then the level table, L, and for the attention
    entries the rule (flag, offsets, W), then the stream."""
    fn = getattr(_build.library("ms_deform_attn"), name)
    if fn.argtypes is None:
        P, I, A = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        tail = [A, I, I] if name.startswith("msda_tap_window") else [A, I, I, A, I]
        fn.argtypes = [P] * n_ptrs + [I] * n_ints + tail + [P]
        fn.restype = ctypes.c_int
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _levels(spatial_shapes):
    return _build.int_array([v for hw in spatial_shapes for v in hw])


def msda_temporal_proj(value, spatial_shapes, ref, c_off, t_off, c_logit,
                       t_logit, rule=("all",)):
    """K1 (see module docstring). Returns (T, Q, M*D) in the value's dtype."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    if not value.is_cuda:
        msda_temporal_proj.plain_calls += 1
        return msda_temporal_proj_plain(value, spatial_shapes, ref, c_off,
                                        t_off, c_logit, t_logit, rule)
    T, S, M, D = value.shape
    _, Q, L, _ = ref.shape
    P = c_logit.shape[-1] // (M * L)
    W = rule_window(rule, T)
    _check_geometry("msda_temporal_proj", spatial_shapes, D, W)
    _check_cuda("msda_temporal_proj", value.device,
                (value, c_off, t_off, c_logit, t_logit), value.dtype)
    _check_cuda("msda_temporal_proj", value.device, (ref,), torch.float32)
    if value.dtype not in _DTYPES:
        raise ValueError(f"msda_temporal_proj: unsupported dtype {value.dtype}")
    if (S != sum(h * w for h, w in spatial_shapes)
            or tuple(c_off.shape) != (T, Q, M * L * P * 2)
            or tuple(t_off.shape) != (T, Q, M * W * L * P * 2)
            or tuple(c_logit.shape) != (T, Q, M * L * P)
            or tuple(t_logit.shape) != (T, Q, M * W * L * P)):
        raise ValueError("msda_temporal_proj: inconsistent shapes")
    out = torch.empty((T, Q, M * D), dtype=value.dtype, device=value.device)
    fn = _function(f"msda_temporal_proj_{_DTYPES[value.dtype]}", 7, 6)
    rule_all, offsets = _rule_args(rule)
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), ref.data_ptr(), c_off.data_ptr(),
                        t_off.data_ptr(), c_logit.data_ptr(), t_logit.data_ptr(),
                        out.data_ptr(), T, Q, S, M, D, P, _levels(spatial_shapes),
                        L, rule_all, offsets, W, _stream(value)),
                     "msda_temporal_proj")
    msda_temporal_proj.launches += 1
    return out


msda_temporal_proj.launches = 0
msda_temporal_proj.plain_calls = 0


def msda_tap_window(spatial_shapes, ref, c_off, t_off, n_heads: int):
    """K2 (see module docstring) → (T, M, n_qblocks, Lf, 2) int32."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    if not ref.is_cuda:
        msda_tap_window.plain_calls += 1
        return msda_tap_window_plain(spatial_shapes, ref, c_off, t_off, n_heads)
    T, Q, L, _ = ref.shape
    M = n_heads
    P = c_off.shape[-1] // (M * L * 2)
    W = t_off.shape[-1] // (M * L * P * 2)
    _check_geometry("msda_tap_window", spatial_shapes, 0, W)
    _check_cuda("msda_tap_window", ref.device, (ref,), torch.float32)
    _check_cuda("msda_tap_window", ref.device, (c_off, t_off), c_off.dtype)
    if c_off.dtype not in _DTYPES:
        raise ValueError(f"msda_tap_window: unsupported dtype {c_off.dtype}")
    if (tuple(c_off.shape) != (T, Q, M * L * P * 2)
            or tuple(t_off.shape) != (T, Q, M * W * L * P * 2)):
        raise ValueError("msda_tap_window: inconsistent shapes")
    nqb = -(-Q // Q_BLOCK)
    out = torch.empty((T, M, nqb, (1 + W) * L, 2), dtype=torch.int32,
                      device=ref.device)
    fn = _function(f"msda_tap_window_{_DTYPES[c_off.dtype]}", 4, 5)
    with torch.cuda.device(ref.device):
        _build.check(fn(ref.data_ptr(), c_off.data_ptr(), t_off.data_ptr(),
                        out.data_ptr(), T, Q, M, P, Q_BLOCK,
                        _levels(spatial_shapes), L, W, _stream(ref)),
                     "msda_tap_window")
    msda_tap_window.launches += 1
    return out


msda_tap_window.launches = 0
msda_tap_window.plain_calls = 0


def msda_temporal(value, spatial_shapes, loc, att, rule=("all",)):
    """K3 (see module docstring). Returns (T, Q, M*D) in the value's dtype."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    if not value.is_cuda:
        msda_temporal.plain_calls += 1
        return ms_deform_attn_temporal_plain(value, spatial_shapes, loc, att,
                                             rule)
    T, S, M, D = value.shape
    _, Q, _, Lf, P, _ = loc.shape
    L = len(spatial_shapes)
    W = rule_window(rule, T)
    _check_geometry("msda_temporal", spatial_shapes, D, W)
    _check_cuda("msda_temporal", value.device, (value,), value.dtype)
    _check_cuda("msda_temporal", value.device, (loc, att), torch.float32)
    if value.dtype not in _DTYPES:
        raise ValueError(f"msda_temporal: unsupported dtype {value.dtype}")
    if (S != sum(h * w for h, w in spatial_shapes) or Lf != (1 + W) * L
            or tuple(loc.shape) != (T, Q, M, Lf, P, 2)
            or tuple(att.shape) != (T, Q, M, Lf, P)):
        raise ValueError("msda_temporal: inconsistent shapes")
    out = torch.empty((T, Q, M * D), dtype=value.dtype, device=value.device)
    fn = _function(f"msda_temporal_{_DTYPES[value.dtype]}", 4, 6)
    rule_all, offsets = _rule_args(rule)
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), loc.data_ptr(), att.data_ptr(),
                        out.data_ptr(), T, Q, S, M, D, P, _levels(spatial_shapes),
                        L, rule_all, offsets, W, _stream(value)), "msda_temporal")
    msda_temporal.launches += 1
    return out


msda_temporal.launches = 0
msda_temporal.plain_calls = 0
