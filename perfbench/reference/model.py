"""Plain PyTorch reference of the benchmarked model, in float32.

A frozen, self-contained statement of DeVIS (Deformable DETR with temporal
deformable attention over a clip, and the mask head), as trained. It
imports nothing of the program: the benchmark judges the program's training
steps against it. Parameter and buffer names equal the program's, so the
harness loads one set of seeded tensors into both.

Departures from a literal transcription, each exact in real arithmetic:
  * bilinear sampling (deformable attention and the DCNv2 layers) is
    `F.grid_sample(align_corners=False, padding_mode="zeros")`, which samples
    at pixel = loc * size - 0.5 with zeros outside, the rule of the papers'
    CUDA ops;
  * each deformable-attention call, each ResNet block and each mask-head
    layer keeps only its inputs for the backward pass and runs again there
    (`torch.utils.checkpoint`; none of them draws dropout): the float32
    activations of a full-size clip would not fit otherwise;
  * a DCNv2 layer mixes channels before it samples (sampling is linear and
    the kernel weight is constant over space).

`q` is the precision of the computation: identity for the float32
reference. The benchmark's control passes a rounding to a narrower type
(`train.quantizer`), which the model applies where the program's dtype
policy computes in its low type: the operands and outputs of every matrix
product, convolution and sampler, the batch and group norms' outputs and
the attention maps; layer norms, softmax statistics, locations and the
losses stay float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def grid_sample(v, grid):
    """Bilinear sampling at pixel = loc * size - 0.5, zeros outside (the one
    sampler of both the attention and the DCNv2 layers)."""
    return F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Linear(nn.Linear):
    def __init__(self, a: int, b: int, q: Q, bias: bool = True):
        super().__init__(a, b, bias=bias, device="meta")
        self.q = q

    def forward(self, x):
        return self.q(F.linear(self.q(x), self.q(self.weight), self.bias))


class Conv2d(nn.Conv2d):
    def __init__(self, a: int, b: int, k: int, q: Q, stride: int = 1, padding: int = 0,
                 bias: bool = True):
        super().__init__(a, b, k, stride=stride, padding=padding, bias=bias, device="meta")
        self.q = q

    def forward(self, x):
        return self.q(F.conv2d(self.q(x), self.q(self.weight), self.bias, self.stride,
                               self.padding))


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, q: Q, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps, self.q = groups, eps, q
        self.weight = nn.Parameter(torch.empty(channels, device="meta"))
        self.bias = nn.Parameter(torch.empty(channels, device="meta"))

    def forward(self, x):
        return self.q(F.group_norm(x, self.groups, self.weight, self.bias, self.eps))


class LayerNorm(nn.LayerNorm):
    def __init__(self, d: int):
        super().__init__(d, eps=1e-5, device="meta")


class Dropout(nn.Module):
    """Inverted dropout; the keep mask is `rand(x.shape) >= p` drawn from
    `generator`, one draw a call, in the order the layers run."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device, generator=self.generator) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


class MLP(nn.Module):
    def __init__(self, a: int, h: int, b: int, n: int, q: Q):
        super().__init__()
        dims = [a] + [h] * (n - 1) + [b]
        self.layers = nn.ModuleList(Linear(i, o, q) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def nearest(x, size):
    """Nearest resize of the last two axes: source = floor(dst * in / out)."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    iy = torch.floor(torch.arange(size[0], dtype=torch.float64, device=x.device)
                     * (h / size[0])).long().clamp(0, h - 1)
    ix = torch.floor(torch.arange(size[1], dtype=torch.float64, device=x.device)
                     * (w / size[1])).long().clamp(0, w - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


# ---------------------------------------------------------------------------
# ResNet-50 with frozen batch norm
# ---------------------------------------------------------------------------

class FrozenBatchNorm2d(nn.Module):
    def __init__(self, n: int, q: Q):
        super().__init__()
        self.q = q
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.empty(n, device="meta"))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * scale
        return self.q(x * scale[None, :, None, None] + shift[None, :, None, None])


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, down: bool, q: Q):
        super().__init__()
        self.q = q
        self.conv1 = Conv2d(cin, width, 1, q, bias=False)
        self.bn1 = FrozenBatchNorm2d(width, q)
        self.conv2 = Conv2d(width, width, 3, q, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width, q)
        self.conv3 = Conv2d(width, width * 4, 1, q, bias=False)
        self.bn3 = FrozenBatchNorm2d(width * 4, q)
        self.downsample = nn.Sequential(Conv2d(cin, width * 4, 1, q, stride=stride, bias=False),
                                        FrozenBatchNorm2d(width * 4, q)) if down else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.q(F.relu(y + (x if self.downsample is None else self.downsample(x))))


class ResNet50(nn.Module):
    def __init__(self, q: Q):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, q, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64, q)
        cin = 64
        for i, (n, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(cin, width, (1 if i == 0 else 2) if j == 0 else 1,
                                         j == 0, q))
                cin = width * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        outs = []
        for i in range(1, 5):
            for block in getattr(self, f"layer{i}"):
                x = recompute(block, x)
            outs.append(x)
        return outs


class Backbone(nn.Module):
    def __init__(self, q: Q):
        super().__init__()
        self.body = ResNet50(q)


def sine_encoding(mask, n: int):
    """2-d sine encoding of a padding mask (B, H, W) → (B, H, W, 2n)."""
    not_mask = (~mask).float()
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    y = y / (y[:, -1:, :] + 1e-6) * 2 * math.pi
    x = x / (x[:, :, -1:] + 1e-6) * 2 * math.pi
    dim_t = torch.arange(n, dtype=torch.float32, device=mask.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / n)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()], -1).flatten(-2)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()], -1).flatten(-2)
    return torch.cat([py, px], dim=-1)


class PositionEncoding(nn.Module):
    """The sine encoding; with `frames`, plus a learned embedding a frame."""

    def __init__(self, hidden: int, frames: int = 0):
        super().__init__()
        self.hidden = hidden
        self.temporal_embed = (nn.Parameter(torch.empty(frames, hidden, device="meta"))
                               if frames else None)

    def forward(self, mask):
        pos = sine_encoding(mask, self.hidden // 2)
        if self.temporal_embed is not None:
            pos = pos + self.temporal_embed[:, None, None, :]
        return pos


# ---------------------------------------------------------------------------
# deformable attention
# ---------------------------------------------------------------------------

_MODE = {"sampler": grid_sample, "recompute": True}


@contextlib.contextmanager
def counting(sampler):
    """Within the block the samplers are `sampler` and nothing is
    recomputed (`counts.flops` counts each operation once)."""
    saved = dict(_MODE)
    _MODE.update(sampler=sampler, recompute=False)
    try:
        yield
    finally:
        _MODE.update(saved)


def _sample(value, shapes, loc, att):
    """value (B, S, M, D); loc (B, Q, M, L, P, 2) in [0, 1] of each level;
    att (B, Q, M, L, P) → (B, Q, M*D)."""
    B, S, M, D = value.shape
    Qn, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    out = value.new_zeros((B * M, D, Qn))
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(B * M, D, h, w)
        start += h * w
        grid = 2 * loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * M, Qn, P, 2) - 1
        s = _MODE["sampler"](v, grid)
        a = att[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * M, 1, Qn, P)
        out = out + (s * a).sum(-1)
    return out.reshape(B, M, D, Qn).permute(0, 3, 1, 2).reshape(B, Qn, M * D)


def recompute(fn, *args):
    """`fn(*args)`, keeping only its inputs for the backward pass where a
    gradient is wanted."""
    if _MODE["recompute"] and torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def sample(value, shapes, loc, att):
    return recompute(_sample, value, shapes, loc, att)


def sample_temporal(value, shapes, loc, att):
    """value (T, S, M, D); loc (T, Q, M, (1 + W) * L, P, 2), the current
    frame's L levels, then L levels of each other frame in increasing order;
    att likewise → (T, Q, M*D)."""
    T, L = value.shape[0], len(shapes)
    table = [[f for f in range(T) if f != t] for t in range(T)]
    out = 0
    for j in range(T):
        v = value if j == 0 else value[torch.tensor([row[j - 1] for row in table],
                                                    device=value.device)]
        out = out + sample(v, shapes, loc[:, :, :, j * L:(j + 1) * L],
                           att[:, :, :, j * L:(j + 1) * L])
    return out


def locations(ref, off, shapes, n_points: int):
    """ref (B, Q, L', 2|4); off (B, Q, M, L', P, 2) → (B, Q, M, L', P, 2).
    2-d: ref + off / (W, H); 4-d: ref_xy + off / P * ref_wh / 2."""
    if ref.shape[-1] == 2:
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                            device=off.device)
        return ref[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
    r = ref[:, :, None, :, None, :]
    return r[..., :2] + off / n_points * r[..., 2:] * 0.5


class TemporalAttn(nn.Module):
    """DeVIS's temporal deformable attention over the T frames of a clip:
    P points in each of the current frame's L levels and in each level of
    the W other frames, one softmax over all of them a head."""

    def __init__(self, T: int, d: int, L: int, W: int, M: int, P: int, q: Q,
                 decoder: bool):
        super().__init__()
        self.T, self.L, self.W, self.M, self.P, self.q = T, L, W, M, P, q
        self.decoder = decoder
        self.value_proj = Linear(d, d, q)
        self.sampling_offsets = Linear(d, M * L * P * 2, q)
        self.temporal_sampling_offsets = Linear(d, M * L * W * P * 2, q)
        self.attention_weights = Linear(d, M * L * P, q)
        self.temporal_attention_weights = Linear(d, M * L * W * P, q)
        self.output_proj = Linear(d, d, q)

    def forward(self, query, ref, inp, shapes, pad):
        T, M, L, W, P = self.T, self.M, self.L, self.W, self.P
        C = query.shape[-1]
        if self.decoder:      # (1, T*Lq, C): frame t's queries attend from frame t
            query = query.reshape(T, -1, C)
            ref = ref.reshape((T, query.shape[1]) + ref.shape[-2:])
        Lq = query.shape[1]
        value = self.value_proj(inp).masked_fill(pad[..., None], 0.0)
        value = self.q(value.reshape(T, -1, M, C // M))
        logits = torch.cat([self.attention_weights(query).reshape(T, Lq, M, L * P),
                            self.temporal_attention_weights(query).reshape(T, Lq, M, -1)], -1)
        att = torch.softmax(logits, -1).reshape(T, Lq, M, (1 + W) * L, P)
        c_off = self.sampling_offsets(query).reshape(T, Lq, M, L, P, 2)
        t_shapes = tuple(shapes) * W
        if self.decoder:
            # instance-aware: query i of frame t samples frame f around
            # query i's reference in frame f
            table = torch.tensor([[f for f in range(T) if f != t] for t in range(T)],
                                 device=ref.device)
            t_ref = ref[table].permute(0, 2, 1, 3, 4).reshape(T, Lq, W * L, ref.shape[-1])
            t_off = self.temporal_sampling_offsets(query).reshape(T, Lq, M, W * L, P, 2)
        else:
            # the encoder's temporal taps sit around the level-0 reference
            t_ref = ref[:, :, :1].expand(T, Lq, W * L, 2)
            t_off = self.temporal_sampling_offsets(query).reshape(T, Lq, M, W * L, P, 2)
        loc = torch.cat([locations(ref, c_off, shapes, P),
                         locations(t_ref, t_off, t_shapes, P)], dim=3)
        out = self.output_proj(self.q(sample_temporal(value, shapes, loc, att)))
        return out.reshape(1, T * Lq, C) if self.decoder else out


class MultiHeadAttention(nn.Module):
    def __init__(self, d: int, M: int, dropout: float, q: Q):
        super().__init__()
        self.M, self.q = M, q
        self.dropout = Dropout(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d, device="meta"))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d, device="meta"))
        self.out_proj = Linear(d, d, q)

    def forward(self, qx, kx, vx):
        B, Lq, C = qx.shape
        Dh = C // self.M
        w, b, q = self.in_proj_weight, self.in_proj_bias, self.q

        def heads(x, i):
            y = q(F.linear(q(x), q(w[i * C:(i + 1) * C]), b[i * C:(i + 1) * C]))
            return y.reshape(B, -1, self.M, Dh).transpose(1, 2)

        qp, kp, vp = heads(qx, 0), heads(kx, 1), heads(vx, 2)
        att = self.dropout(q(torch.softmax(q(q(qp) @ q(kp).transpose(-1, -2)) / math.sqrt(Dh), -1)))
        out = q(att @ vp)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, C))


class EncoderLayer(nn.Module):
    def __init__(self, a: Dict, q: Q):
        super().__init__()
        d = a["hidden_dim"]
        self.dropout = Dropout(a["dropout"])
        self.self_attn = TemporalAttn(a["num_frames"], d, a["levels"], a["num_frames"] - 1,
                                      a["heads"], a["enc_points"], q, decoder=False)
        self.norm1 = LayerNorm(d)
        self.linear1 = Linear(d, a["dim_feedforward"], q)
        self.linear2 = Linear(a["dim_feedforward"], d, q)
        self.norm2 = LayerNorm(d)

    def forward(self, src, pos, ref, shapes, pad):
        drop = self.dropout
        src = self.norm1(src + drop(self.self_attn(src + pos, ref, src, shapes, pad)))
        y = self.linear2(drop(F.relu(self.linear1(src))))
        return self.norm2(src + drop(y))


class DecoderLayer(nn.Module):
    def __init__(self, a: Dict, q: Q):
        super().__init__()
        d = a["hidden_dim"]
        self.dropout = Dropout(a["dropout"])
        self.self_attn = MultiHeadAttention(d, a["heads"], a["dropout"], q)
        self.norm2 = LayerNorm(d)
        self.cross_attn = TemporalAttn(a["num_frames"], d, a["levels"], a["num_frames"] - 1,
                                       a["heads"], a["dec_points"], q, decoder=True)
        self.norm1 = LayerNorm(d)
        self.linear1 = Linear(d, a["dim_feedforward"], q)
        self.linear2 = Linear(a["dim_feedforward"], d, q)
        self.norm3 = LayerNorm(d)

    def forward(self, tgt, query_pos, ref, src, shapes, pad):
        drop = self.dropout
        qk = tgt + query_pos
        tgt = self.norm2(tgt + drop(self.self_attn(qk, qk, tgt)))
        tgt2 = self.cross_attn(tgt + query_pos, ref, src, shapes, pad)
        tgt = self.norm1(tgt + drop(tgt2.reshape(tgt.shape)))
        y = self.linear2(drop(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(y))


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def valid_ratios(masks) -> torch.Tensor:
    out = []
    for m in masks:
        H, W = m.shape[1:]
        vh = (~m[:, :, 0]).sum(1).float()
        vw = (~m[:, 0, :]).sum(1).float()
        out.append(torch.stack([vw / W, vh / H], -1))
    return torch.stack(out, 1)


def encoder_references(shapes, vr):
    refs = []
    for lvl, (h, w) in enumerate(shapes):
        ry, rx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=vr.device) + 0.5,
                                torch.arange(w, dtype=torch.float32, device=vr.device) + 0.5,
                                indexing="ij")
        ry = ry.reshape(-1)[None] / (vr[:, None, lvl, 1] * h)
        rx = rx.reshape(-1)[None] / (vr[:, None, lvl, 0] * w)
        refs.append(torch.stack([rx, ry], -1))
    return torch.cat(refs, 1)[:, :, None] * vr[:, None]


class Transformer(nn.Module):
    def __init__(self, a: Dict, q: Q):
        super().__init__()
        d = a["hidden_dim"]
        self.d = d
        self.with_gradient = a["bbx_gradient_prop"]
        self.level_embed = nn.Parameter(torch.empty(a["levels"], d, device="meta"))
        self.reference_points = Linear(d, 2, q)
        self.encoder = _Stack([EncoderLayer(a, q) for _ in range(a["enc_layers"])])
        self.decoder = _Stack([DecoderLayer(a, q) for _ in range(a["dec_layers"])])

    def forward(self, srcs, masks, pos, query_embed, bbox_embed):
        shapes = tuple((int(s.shape[2]), int(s.shape[3])) for s in srcs)
        B, C = srcs[0].shape[0], self.d
        memory = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        pad = torch.cat([m.reshape(B, -1) for m in masks], 1)
        pos_flat = torch.cat([p.reshape(B, -1, C) + self.level_embed[l]
                              for l, p in enumerate(pos)], 1)
        vr = valid_ratios(masks)
        enc_ref = encoder_references(shapes, vr)
        for layer in self.encoder.layers:
            memory = layer(memory, pos_flat, enc_ref, shapes, pad)
        query_pos, tgt = torch.split(query_embed, C, dim=1)
        query_pos, tgt, dvr = query_pos[None], tgt[None], vr[0:1]     # one clip's queries
        ref = torch.sigmoid(self.reference_points(query_pos))
        init_ref, out, hs, refs = ref, tgt, [], []
        for lid, layer in enumerate(self.decoder.layers):
            r = dvr if ref.shape[-1] == 2 else torch.cat([dvr, dvr], -1)
            out = layer(out, query_pos, ref[:, :, None] * r[:, None], memory, shapes, pad)
            tmp = bbox_embed[lid](out)
            if ref.shape[-1] == 4:
                new = torch.sigmoid(tmp + inverse_sigmoid(ref))
            else:
                new = torch.sigmoid(torch.cat([tmp[..., :2] + inverse_sigmoid(ref), tmp[..., 2:]], -1))
            ref = new if self.with_gradient else new.detach()
            hs.append(out)
            refs.append(ref)
        memories, start = [], 0
        for h, w in shapes:
            memories.append(memory[:, start:start + h * w].reshape(B, h, w, C))
            start += h * w
        return torch.stack(hs), memories, init_ref, torch.stack(refs)


class DeformableDETR(nn.Module):
    """Backbone, input projections (with the stride-2 fourth level), the
    transformer and a class and box head a decoder layer (box refinement)."""

    def __init__(self, a: Dict, q: Q):
        super().__init__()
        d = a["hidden_dim"]
        self.q = q
        self.with_gradient = a["bbx_gradient_prop"]
        self.backbone = nn.ModuleList([Backbone(q),
                                       PositionEncoding(d, a["num_frames"])])
        self.transformer = Transformer(a, q)
        projs = [(c, 1, 1) for c in (512, 1024, 2048)] + [(2048, 3, 2)]
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(c, d, k, q, stride=s, padding=(k - 1) // 2), GroupNorm(32, d, q))
            for c, k, s in projs)
        self.query_embed = nn.Embedding(a["num_queries"], 2 * d, device="meta")
        n = a["dec_layers"]
        self.class_embed = nn.ModuleList(Linear(d, a["num_logits"], q) for _ in range(n))
        self.bbox_embed = nn.ModuleList(MLP(d, d, 4, 3, q) for _ in range(n))

    def forward(self, images, pad):
        feats = self.backbone[0].body(images.permute(0, 3, 1, 2))
        fmasks = [nearest(pad, f.shape[-2:]) for f in feats]
        srcs = [self.input_proj[l](f) for l, f in enumerate(feats[1:])]
        masks = list(fmasks[1:])
        srcs.append(self.input_proj[3](feats[-1]))
        masks.append(nearest(pad, srcs[-1].shape[-2:]))
        pos = [self.backbone[1](m) for m in masks]
        if self.q is not identity:          # the program casts them to the features' type
            pos = [self.q(p) for p in pos]
        hs, memories, init_ref, refs = self.transformer(
            srcs, masks, pos, self.query_embed.weight, self.bbox_embed)
        levels = []
        for lvl in range(hs.shape[0]):
            logits = self.class_embed[lvl](hs[lvl])
            if self.with_gradient:
                boxes = refs[lvl]
            else:
                ref = inverse_sigmoid(init_ref if lvl == 0 else refs[lvl - 1])
                tmp = self.bbox_embed[lvl](hs[lvl])
                tmp = tmp + ref if ref.shape[-1] == 4 else torch.cat(
                    [tmp[..., :2] + ref, tmp[..., 2:]], -1)
                boxes = torch.sigmoid(tmp)
            levels.append({"pred_logits": logits, "pred_boxes": boxes})
        return levels, dict(backbone_feats=feats, memories=memories, masks=masks, hs=hs)


# ---------------------------------------------------------------------------
# mask head
# ---------------------------------------------------------------------------

class ModulatedDeformableConv(nn.Module):
    """DCNv2, 3x3, padding 1: offset and modulator fields, then each kernel
    position's channel mix sampled at its offset position and modulated."""

    def __init__(self, cin: int, cout: int, q: Q):
        super().__init__()
        self.q = q
        self.offset_conv = nn.Conv2d(cin, 18, 3, padding=1, device="meta")
        self.modulator_conv = nn.Conv2d(cin, 9, 3, padding=1, device="meta")
        self.regular_conv = nn.Conv2d(cin, cout, 3, padding=1, device="meta")

    def forward(self, x):
        q = self.q
        B, _, H, W = x.shape
        off = q(F.conv2d(q(x), q(self.offset_conv.weight), self.offset_conv.bias, padding=1))
        mod = q(2 * torch.sigmoid(q(F.conv2d(q(x), q(self.modulator_conv.weight),
                                             self.modulator_conv.bias, padding=1))))
        by = torch.arange(H, dtype=torch.float32, device=x.device)[:, None]
        bx = torch.arange(W, dtype=torch.float32, device=x.device)[None, :]
        wt = self.regular_conv.weight
        out = 0
        for k in range(9):
            ky, kx = divmod(k, 3)
            u = q(F.conv2d(q(x), q(wt[:, :, ky:ky + 1, kx:kx + 1])))
            py = by + (ky - 1) + off[:, 2 * k]
            px = bx + (kx - 1) + off[:, 2 * k + 1]
            grid = torch.stack([(2 * px + 1) / W - 1, (2 * py + 1) / H - 1], -1)
            s = _MODE["sampler"](q(u), grid)
            out = out + s * mod[:, k:k + 1]
        return q(out + self.regular_conv.bias[None, :, None, None])


class AttentionMaps(nn.Module):
    """Per level: softmax, jointly over heads and space, of the query
    embeddings against the encoder memory."""

    def __init__(self, d: int, heads: int, levels: int, q: Q):
        super().__init__()
        self.heads, self.d, self.q = heads, d, q
        for i in range(levels):
            sfx = "" if i == 0 else f"_{i}"
            setattr(self, f"q_linear{sfx}", Linear(d, d, q))
            setattr(self, f"k_linear{sfx}", Linear(d, d, q))

    def forward(self, emb, memories, masks):
        out, Dh, q = [], self.d // self.heads, self.q
        for i, mem in enumerate(memories):
            sfx = "" if i == 0 else f"_{i}"
            ql = getattr(self, f"q_linear{sfx}")(emb)
            kl = getattr(self, f"k_linear{sfx}")(mem)
            B, N, _ = ql.shape
            H, W = mem.shape[1:3]
            logits = q(torch.einsum("bnhc,bxyhc->bnhxy",
                                    q(ql.reshape(B, N, self.heads, Dh) * Dh ** -0.5),
                                    q(kl.reshape(B, H, W, self.heads, Dh))))
            logits = logits.masked_fill(masks[i][:, None, None], float("-inf"))
            out.append(q(torch.softmax(logits.reshape(B, N, -1), -1))
                       .reshape(B, N, self.heads, H, W))
        return out


class MaskHead(nn.Module):
    """FPN-style head on DCNv2 layers; the features are expanded
    instance-major (sample n*T + t)."""

    def __init__(self, d: int, heads: int, q: Q):
        super().__init__()
        dims = [d // 2 ** e for e in range(6)]
        c0 = d + heads
        self.lay1 = ModulatedDeformableConv(c0, c0, q)
        self.gn1 = GroupNorm(8, c0, q)
        self.lay2 = ModulatedDeformableConv(c0, dims[1], q)
        self.gn2 = GroupNorm(8, dims[1], q)
        for lvl in range(3):
            cin = dims[lvl + 1]
            self.add_module(f"adapter{lvl + 1}", Conv2d(d, cin, 1, q))
            if lvl + 1 < 3:
                cin += heads
            self.add_module(f"lay{lvl + 3}", ModulatedDeformableConv(cin, dims[lvl + 2], q))
            self.add_module(f"gn{lvl + 3}", GroupNorm(8, dims[lvl + 2], q))
        self.out_lay = ModulatedDeformableConv(dims[4], 1, q)

    def forward(self, feats, maps, n: int):
        def expand(t):
            return t.repeat(n, 1, 1, 1)

        x = torch.cat([expand(feats[0]), maps[0]], 1)
        x = F.relu(self.gn1(recompute(self.lay1, x)))
        x = F.relu(self.gn2(recompute(self.lay2, x)))
        for lvl, f in enumerate(feats[1:]):
            fpn = expand(getattr(self, f"adapter{lvl + 1}")(f))
            x = fpn + nearest(x, fpn.shape[-2:])
            if lvl + 1 < len(maps):
                x = torch.cat([x, maps[lvl + 1]], 1)
            x = F.relu(getattr(self, f"gn{lvl + 3}")(recompute(getattr(self, f"lay{lvl + 3}"), x)))
        return recompute(self.out_lay, x)


class SegmModel(nn.Module):
    """The DETR and its mask head. `forward` returns the output levels and
    what the mask head reads; `masks` computes mask logits for given query
    embeddings. The memories at /32, /16 and /8 give the attention maps;
    the head reads the /32, /16, /8 memories and the /4 backbone map."""

    def __init__(self, a: Dict, q: Q = identity):
        super().__init__()
        self.def_detr = DeformableDETR(a, q)
        d = a["hidden_dim"]
        self.bbox_attention = AttentionMaps(d, 8, 3, q)
        self.mask_head = MaskHead(d, 8, q)

    def forward(self, images, pad):
        levels, inter = self.def_detr(images, pad)
        mem = inter["memories"]                        # /8, /16, /32, /64
        att_mem = [mem[2], mem[1], mem[0]]
        att_mask = [inter["masks"][2], inter["masks"][1], inter["masks"][0]]
        feats = [mem[2].permute(0, 3, 1, 2), mem[1].permute(0, 3, 1, 2),
                 mem[0].permute(0, 3, 1, 2), inter["backbone_feats"][0]]
        return levels, dict(att_mem=att_mem, att_mask=att_mask, feats=feats, hs=inter["hs"])

    def masks(self, emb, head):
        """emb (T, N, C) → (N, T, h, w)."""
        T, N, _ = emb.shape
        maps = self.bbox_attention(emb, head["att_mem"], head["att_mask"])
        maps = [m.transpose(0, 1).reshape((N * T,) + m.shape[2:]) for m in maps]
        m = self.mask_head(head["feats"], maps, N)[:, 0]
        return m.reshape(N, T, *m.shape[1:])


def set_dropout_generator(model: nn.Module, generator) -> None:
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


def build(arch: Dict, device, q: Q = identity) -> SegmModel:
    """The model of `arch` (a configuration file's `reference` section) on
    `device`, its tensors uninitialised (the harness loads them)."""
    return SegmModel(arch, q).to_empty(device=device)

