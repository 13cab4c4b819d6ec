#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`devis_torch`) on one card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from `devis_torch/csrc/` (one nvcc per source, in
   parallel) and prints the card's name and power limit.
2. Holds each kernel (K1 encoder temporal attention, K2 tap windows, K3
   decoder temporal attention, K4 DCNv2 layer) against its plain PyTorch
   version at the YT-VIS-19 main-path shapes: f32 with TF32 off to 1e-4 of
   max|plain|, bf16 to 2e-2. Offsets are random and off the pixel grid.
   Times kernel and plain version with CUDA events.
3. Drives the main path: `build_model` at the YT-19 R50 config (bf16, 6+6
   layers, 60 queries, seeded random weights) and `VISInferFn` over 3
   consecutive clips of a seeded synthetic 360x640 uint8 video. Launch
   counters are zeroed just before and read just after; each clip must
   launch K1, K3 and K4 six times and no plain path. One clip also runs
   with the plain versions on the card, and the two are compared. K2 runs
   on the first encoder layer's inputs. One clip is profiled: device time
   by kernel group and the device's idle share.
4. Prints the `kernels` JSON line, a clip-latency line, the card line, and
   last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or without the
`devis_torch` package beside it. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
T, NQ, NUM_OUT, STRIDE = 6, 60, 20, 4
VIDEO_HW = (360, 640)
SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))      # the 384x640 canvas pyramid
M, D, P = 8, 32, 4
# mask-head layers (name, Cin, Cout, H, W) for 10 trajectories x 6 frames
DCN_LAYERS = (("lay1", 264, 264, 12, 20), ("lay2", 264, 128, 12, 20),
              ("lay3", 136, 64, 24, 40), ("lay4", 72, 32, 48, 80),
              ("lay5", 32, 16, 96, 160), ("out_lay", 16, 1, 96, 160))
DCN_B = 60
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # f32 outside the tensor cores
BF16_TC_FLOPS = 989e12         # bf16 tensor cores, dense


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over `iters` calls, by CUDA events after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, rel):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = bool(torch.isfinite(got.float()).all()) and err <= rel * max(scale, 1e-30)
    log(f"  {name}: max_abs_err {err:.3e}  max|plain| {scale:.3e}  "
        f"limit {rel:g} x max|plain|  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def touched_value_bytes(loc, spatial_shapes, table, itemsize):
    """Bytes of the distinct value rows (frame, pixel, head) that in-bounds
    bilinear corners of `loc` (T, Q, M, Lf, P, 2) read: the data-dependent
    input traffic of K1 and K3."""
    import torch
    Tn, _, Mn, Lf, _, _ = loc.shape
    L = len(spatial_shapes)
    S = sum(h * w for h, w in spatial_shapes)
    starts = [0]
    for h, w in spatial_shapes[:-1]:
        starts.append(starts[-1] + h * w)
    frames = torch.cat([torch.arange(Tn, device=loc.device)[:, None], table], 1)
    keys = []
    for lvl in range(Lf):
        j, l = divmod(lvl, L)
        h, w = spatial_shapes[l]
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        live = (x > -1) & (x < w) & (y > -1) & (y < h)
        x0 = torch.floor(torch.where(live, x, 0.0)).long()
        y0 = torch.floor(torch.where(live, y, 0.0)).long()
        f = frames[:, j].view(Tn, 1, 1, 1).expand_as(x0)
        m = torch.arange(Mn, device=loc.device).view(1, 1, Mn, 1).expand_as(x0)
        for oy in (0, 1):
            for ox in (0, 1):
                yi, xi = y0 + oy, x0 + ox
                ok = live & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                s = starts[l] + yi * w + xi
                keys.append(((f * S + s) * Mn + m)[ok])
    return torch.unique(torch.cat(keys)).numel() * D * itemsize


def msda_phases(torch, dev, gen, results):
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.ms_deform_attn import temporal_frame_table

    L = len(SHAPES)
    W = T - 1
    S = Q = sum(h * w for h, w in SHAPES)
    rule = ("all",)
    table = torch.as_tensor(temporal_frame_table(rule, T), device=dev)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    value = rnd(T, S, M, D)
    ref = torch.rand(T, Q, L, 2, generator=gen, device=dev)
    c_off = rnd(T, Q, M * L * P * 2, scale=3.0)      # pixels, off the grid
    t_off = rnd(T, Q, M * W * L * P * 2, scale=3.0)
    c_logit = rnd(T, Q, M * L * P)
    t_logit = rnd(T, Q, M * W * L * P)
    args32 = (value, SHAPES, ref, c_off, t_off, c_logit, t_logit, rule)
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    args16 = (bf(value), SHAPES, ref, bf(c_off), bf(t_off), bf(c_logit),
              bf(t_logit), rule)

    log("K1 msda_temporal_proj (encoder), T=6 Q=S=5100 M=8 D=32 Lf=24 P=4")
    compare("f32 ", K.msda_temporal_proj(*args32), K.msda_temporal_proj_plain(*args32), 1e-4)
    err = compare("bf16", K.msda_temporal_proj(*args16),
                  K.msda_temporal_proj_plain(*args16), 2e-2)
    ms = cuda_time(lambda: K.msda_temporal_proj(*args16), 20)
    plain_ms = cuda_time(lambda: K.msda_temporal_proj_plain(*args16), 3, 1)
    loc = K.temporal_proj_locations(SHAPES, ref, args16[3], args16[4], M)
    io = sum(t.numel() * t.element_size() for t in args16 if torch.is_tensor(t)
             and t is not args16[0]) + T * Q * M * D * 2
    vbytes = touched_value_bytes(loc, SHAPES, table, 2)
    flops = T * Q * M * (1 + W) * L * P * (8 * D + 40)
    results["K1"] = dict(
        name="msda_temporal_proj", route="cuda", source="devis_torch/csrc/ms_deform_attn.cu",
        replaces="devis_tpu/ops/ms_deform_attn_pallas.py:1748",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bytes=io + vbytes, flops=flops, flop_rate=F32_FLOPS, library_ms=None)
    del loc

    del args32, args16, c_off, t_off, c_logit, t_logit

    log("K3 msda_temporal (decoder), T=6 Q=10 M=8 Lf=24 P=4")
    Qd = NQ // T
    loc = torch.rand(T, Qd, M, (1 + W) * L, P, 2, generator=gen, device=dev) * 1.2 - 0.1
    att = torch.softmax(rnd(T, Qd, M, (1 + W) * L * P), -1).reshape(loc.shape[:-1])
    compare("f32 ", K.msda_temporal(value, SHAPES, loc, att, rule),
            K.ms_deform_attn_temporal_plain(value, SHAPES, loc, att, rule), 1e-4)
    v16 = bf(value)
    err = compare("bf16", K.msda_temporal(v16, SHAPES, loc, att, rule),
                  K.ms_deform_attn_temporal_plain(v16, SHAPES, loc, att, rule), 2e-2)
    ms = cuda_time(lambda: K.msda_temporal(v16, SHAPES, loc, att, rule), 50)
    plain_ms = cuda_time(lambda: K.ms_deform_attn_temporal_plain(v16, SHAPES, loc, att,
                                                                 rule), 5, 1)
    results["K3"] = dict(
        name="msda_temporal", route="cuda", source="devis_torch/csrc/ms_deform_attn.cu",
        replaces="devis_tpu/ops/ms_deform_attn_pallas.py:1406",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bytes=touched_value_bytes(loc, SHAPES, table, 2) + loc.numel() * 4
        + att.numel() * 4 + T * Qd * M * D * 2,
        flops=T * Qd * M * (1 + W) * L * P * 8 * D, flop_rate=F32_FLOPS, library_ms=None)


def tap_window_phase(torch, model, x, pad, results):
    """K2 on the inputs the main path gives the first encoder layer."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    enc = model.def_detr.transformer.encoder.layers[0].self_attn
    captured = {}
    hook = enc.register_forward_pre_hook(lambda mod, args: captured.setdefault("a", args))
    try:
        model(x, pad)
    finally:
        hook.remove()
    query, ref, _, shapes = captured["a"][:4]
    ref = ref.float().contiguous()
    c_off = enc.sampling_offsets(query).contiguous()
    t_off = enc.temporal_sampling_offsets(query).contiguous()
    Tn, Q, L, _ = ref.shape
    W = t_off.shape[-1] // c_off.shape[-1]
    log(f"K2 msda_tap_window on encoder layer 0's inputs: T={Tn} Q={Q} Lf={(1 + W) * L}, "
        f"{c_off.dtype} offsets, q-block {K.Q_BLOCK}")
    got = K.msda_tap_window(shapes, ref, c_off, t_off, M)
    want = K.msda_tap_window_plain(shapes, ref, c_off, t_off, M)
    live = (want[..., 1] >= 0).float().mean().item()
    log(f"  windows equal: {bool(torch.equal(got, want))}; live share {live:.3f}")
    if not torch.equal(got, want):
        raise AssertionError("K2 windows differ from the plain version")
    ms = cuda_time(lambda: K.msda_tap_window(shapes, ref, c_off, t_off, M), 20)
    plain_ms = cuda_time(lambda: K.msda_tap_window_plain(shapes, ref, c_off, t_off, M), 3, 1)
    P = c_off.shape[-1] // (M * L * 2)
    results["K2"] = dict(
        name="msda_tap_window", route="cuda", source="devis_torch/csrc/ms_deform_attn.cu",
        replaces="devis_tpu/ops/ms_deform_attn_pallas.py:1935",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bytes=ref.numel() * 4 + (c_off.numel() + t_off.numel()) * c_off.element_size()
        + got.numel() * 4,
        flops=Tn * Q * M * (1 + W) * L * P * 12, flop_rate=F32_FLOPS, library_ms=None)


def dcn_phase(torch, dev, gen, results):
    from devis_torch.ops.deform_conv import (modulated_deform_conv2d,
                                             modulated_deform_conv2d_plain)
    log(f"K4 modulated_deform_conv2d, B={DCN_B}, per mask-head layer")
    K = 3
    tot = dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0)
    err_max = 0.0
    for name, cin, cout, h, w in DCN_LAYERS:
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=dev) * scale
        x = rnd(DCN_B, cin, h, w)
        fan = (K * K * cin) ** 0.5
        args = [x, rnd(K, K, cin, 2 * K * K, scale=2.0 / fan), rnd(2 * K * K, scale=0.5),
                rnd(K, K, cin, K * K, scale=1.0 / fan), rnd(K * K),
                rnd(K, K, cin, cout, scale=1.0 / fan), rnd(cout)]
        a16 = [t.to(torch.bfloat16) for t in args[:2]] + [args[2]] \
            + [args[3].to(torch.bfloat16), args[4], args[5].to(torch.bfloat16), args[6]]
        if name in ("lay1", "lay5"):
            compare(f"{name} f32 ", modulated_deform_conv2d(*args),
                    modulated_deform_conv2d_plain(*args), 1e-4)
        err = compare(f"{name} bf16", modulated_deform_conv2d(*a16),
                      modulated_deform_conv2d_plain(*a16), 2e-2)
        err_max = max(err_max, err)
        ms = cuda_time(lambda: modulated_deform_conv2d(*a16), 10)
        plain_ms = cuda_time(lambda: modulated_deform_conv2d_plain(*a16), 2, 1)
        hw = h * w
        flops = 2 * DCN_B * hw * K * K * (3 * K * K * cin + 4 * cin + cin * cout)
        nbytes = (x.numel() + sum(t.numel() for t in a16[1::2]) + DCN_B * cout * hw) * 2
        log(f"    {name} {cin}->{cout} at {h}x{w}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bytes"] += nbytes
        tot["flops"] += flops
    results["K4"] = dict(
        name="modulated_deform_conv2d", route="cuda", source="devis_torch/csrc/deform_conv.cu",
        replaces="devis_tpu/ops/deform_conv_banded.py:169", max_abs_err=err_max,
        ms=tot["ms"], plain_ms=tot["plain_ms"], bytes=tot["bytes"], flops=tot["flops"],
        flop_rate=BF16_TC_FLOPS, library_ms=None)


def profile_clip(torch, infer, video):
    """Device time of one clip by kernel group, from torch.profiler, and the
    share of the clip's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer(video, 0)
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"K1 msda_temporal_proj": "msda_temporal_proj_kernel",
              "K3 msda_temporal": "msda_temporal_kernel",
              "K4 dcn_layer": "dcn_layer_kernel"}
    sums = dict.fromkeys(list(groups) + ["convolutions (cuDNN)", "matmuls", "other"], 0.0)
    top = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        # kernel events only: a CPU op's own entry repeats its kernels' time
        if us <= 0 or getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key
        top.append((us, e.count, name))
        low = name.lower()
        group = next((g for g, k in groups.items() if k in name), None)
        if group is None:
            group = ("convolutions (cuDNN)" if any(k in low for k in ("conv", "cudnn", "xmma", "fprop"))
                     else "matmuls" if any(k in low for k in ("gemm", "cutlass", "matmul"))
                     else "other")
        sums[group] += us / 1e3
    busy = sum(sums.values())
    log(f"profile of one clip ({wall_ms:.3f} ms wall): device busy {busy:.3f} ms, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for g, ms in sums.items():
        log(f"  {g}: {ms:.3f} ms")
    for us, n, name in sorted(top, reverse=True)[:10]:
        log(f"    {us / 1e3:8.3f} ms  x{n:<4d} {name[:90]}")


def check_counts(ops, wants):
    """Each op launched its kernel `want` times and never took the plain path."""
    for fn, want in zip(ops, wants):
        if fn.launches != want or fn.plain_calls:
            raise AssertionError(f"{fn.__name__}: {fn.launches} launches "
                                 f"(want {want}), {fn.plain_calls} plain calls")


class _Video:
    """Seeded synthetic uint8 video: a drifting colour gradient with moving
    rectangles, `n` frames of 360x640."""

    def __init__(self, n: int, seed: int):
        import numpy as np
        rs = np.random.RandomState(seed)
        h, w = VIDEO_HW
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        frames = []
        boxes = rs.randint(0, 300, size=(5, 4))
        colours = rs.randint(0, 255, size=(5, 3))
        for t in range(n):
            f = np.stack([(xx + 7 * t) % 256, (yy + 3 * t) % 256,
                          (xx + yy) % 256], -1)
            for (y0, x0, bh, bw), c in zip(boxes, colours):
                y, x = y0 + 4 * t, x0 + 9 * t
                f[y % h:min(h, y % h + 30 + bh // 4), x % w:min(w, x % w + 40 + bw // 3)] = c
            frames.append(f + rs.randint(0, 16, size=f.shape))
        self.frames = np.clip(np.stack(frames), 0, 255).astype(np.uint8)
        self.real_video_length = None

    def load_clip(self, i: int):
        return self.frames[i * STRIDE:i * STRIDE + T]


def main_path(torch, dev, card, results):
    import numpy as np

    from devis_torch.config import get_cfg_defaults
    from devis_torch.inference import VISInferFn, make_eval_buckets
    from devis_torch.models import build_model
    from devis_torch.models import attention as attn_mod
    from devis_torch.models import segmentation as seg_mod
    from devis_torch.models.segmentation import ModulatedDeformableConv
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import (modulated_deform_conv2d,
                                             modulated_deform_conv2d_plain)
    from devis_torch.util.box_ops import box_cxcywh_to_xyxy

    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "vis"
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.LOSS.MASK_AUX_LOSS = [0]
    cfg.MODEL.NUM_QUERIES = NQ
    cfg.MODEL.BBX_GRADIENT_PROP = True
    cfg.MODEL.DEVIS.NUM_FRAMES = T
    cfg.TEST.NUM_OUT = NUM_OUT
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = VIDEO_HW
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.freeze()
    t0 = time.perf_counter()
    model = build_model(41, cfg, seed=SEED)
    # The reference init zeroes the offset and logit projections, which puts
    # every tap on the pixel grid; seeded noise moves them off it.
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if any(s in name for s in ("sampling_offsets.weight", "attention_weights.weight",
                                       "offset_conv.weight", "modulator_conv.weight")):
                fan = p[0].numel()
                p.add_(torch.randn(p.shape, generator=gen).to(dev) / fan ** 0.5)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main path: DeVIS R50 YT-19, bf16, {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    video = _Video(T + 3 * STRIDE, SEED)
    infer = VISInferFn(model, T, make_eval_buckets(*VIDEO_HW))
    infer(video, 0)                                      # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    ops = (K.msda_temporal_proj, K.msda_tap_window, K.msda_temporal,
           modulated_deform_conv2d)
    for fn in ops:
        fn.launches = fn.plain_calls = 0
    lat = []
    outs = []
    for i in range(3):
        t0 = time.perf_counter()
        outs.append(infer(video, i))
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = {fn.__name__: fn.launches for fn in ops}
    plain = {fn.__name__: fn.plain_calls for fn in ops}
    log(f"  launches over 3 clips: {launches}; plain calls: {plain}")
    n_dcn = sum(isinstance(m, ModulatedDeformableConv) for m in model.modules())
    check_counts(ops, (3 * cfg.MODEL.TRANSFORMER.ENCODER_LAYERS, 0,
                       3 * cfg.MODEL.TRANSFORMER.DECODER_LAYERS, 3 * n_dcn))

    hv, wv = round(VIDEO_HW[0] / 4), round(VIDEO_HW[1] / 4)
    for r in outs:
        shapes = {k: tuple(np.shape(r[k])) for k in ("scores", "labels", "boxes",
                                                      "center_points", "mask_gather")}
        want = {"scores": (T, NUM_OUT), "labels": (NUM_OUT,), "boxes": (T, NUM_OUT, 4),
                "center_points": (T, NUM_OUT, 2), "mask_gather": (NUM_OUT,)}
        ml = r["mask_logits"]
        canvas = make_eval_buckets(*VIDEO_HW)[0]
        if shapes != want or tuple(ml.shape) != (NQ // T, T, canvas[0] // 4, canvas[1] // 4) \
                or ml.dtype != torch.float8_e4m3fn or r["valid_hw"] != (hv, wv):
            raise AssertionError(f"fetch shapes {shapes}, masks {tuple(ml.shape)} "
                                 f"{ml.dtype}, valid_hw {r['valid_hw']}")
        xyxy = box_cxcywh_to_xyxy(torch.from_numpy(r["boxes"]))
        if not (np.isfinite(r["scores"]).all() and np.isfinite(r["boxes"]).all()
                and torch.isfinite(ml.float()).all()
                and ((r["scores"] >= 0) & (r["scores"] <= 1)).all()
                and (xyxy[..., 2:] >= xyxy[..., :2]).all()
                and ((r["labels"] >= 0) & (r["labels"] < 40)).all()
                and ((r["mask_gather"] >= 0) & (r["mask_gather"] < NQ // T)).all()):
            raise AssertionError("non-finite or out-of-range outputs")
    clip_ms = float(np.mean(lat))
    log(f"  clip latency {[round(v, 3) for v in lat]} ms, mean {clip_ms:.3f} ms; "
        f"FPS = stride {STRIDE} / latency = {STRIDE / clip_ms * 1e3:.3f} ({card})")

    # One clip with the plain versions on the card, against the kernels.
    images, _, clip_len = infer.prepare(video, 0)
    x = torch.from_numpy(images).to(dev)
    x = (x.float() / 255.0 - infer._mean) / infer._std
    pad = torch.zeros(x.shape[:3], dtype=torch.bool, device=dev)
    pad[:, VIDEO_HW[0]:] = True
    with torch.inference_mode():
        out_k, res_k = model(x, pad)
        saved = (attn_mod.msda_temporal_proj, attn_mod.msda_temporal,
                 seg_mod.modulated_deform_conv2d)
        attn_mod.msda_temporal_proj = K.msda_temporal_proj_plain
        attn_mod.msda_temporal = K.ms_deform_attn_temporal_plain
        seg_mod.modulated_deform_conv2d = modulated_deform_conv2d_plain
        try:
            out_p, res_p = model(x, pad)
        finally:
            (attn_mod.msda_temporal_proj, attn_mod.msda_temporal,
             seg_mod.modulated_deform_conv2d) = saved
    # bf16 end to end through 12 attention layers and 6 DCNv2 layers: the two
    # paths round at different places, so probabilities and normalized boxes
    # agree to 5e-2, and mask logits to 5e-2 of their largest magnitude
    errs = {}
    for k, f in (("pred_logits", torch.sigmoid), ("pred_boxes", lambda t: t)):
        a, b = f(out_k[k].float()), f(out_p[k].float())
        errs[k] = (a - b).abs().max().item()
    mk, mp = res_k["masks"].float(), res_p["masks"].float()
    errs["masks / max|masks|"] = ((mk - mp).abs().max() / mp.abs().max()).item()
    log(f"  kernel path vs plain path on the card, max abs diff: {errs} (limit 5e-2)")
    if not all(v <= 5e-2 for v in errs.values()):
        raise AssertionError("kernel path disagrees with the plain path")
    with torch.inference_mode():
        tap_window_phase(torch, model, x, pad, results)
    profile_clip(torch, infer, video)
    return launches, clip_ms


def main() -> int:
    try:
        import torch
    except ImportError:
        print("PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "devis_torch")):
        print("devis_torch/ not found beside chip_smoke.py", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from devis_torch.ops import _build

    card = card_line()
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s (per source: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"card: {card}")

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    with torch.inference_mode():
        msda_phases(torch, dev, gen, results)
        dcn_phase(torch, dev, gen, results)
    torch.cuda.empty_cache()
    launches, clip_ms = main_path(torch, dev, card, results)

    counts = {"K1": launches["msda_temporal_proj"], "K2": launches["msda_tap_window"],
              "K3": launches["msda_temporal"], "K4": launches["modulated_deform_conv2d"]}
    kernels = []
    for key in ("K1", "K2", "K3", "K4"):
        r = results[key]
        bound_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = r["flops"] / r["flop_rate"] * 1e3
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": counts[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"clip_ms": clip_ms, "fps": STRIDE / clip_ms * 1e3, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
