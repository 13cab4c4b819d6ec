#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`devis_torch`) on one card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from `devis_torch/csrc/` (one nvcc per source, in
   parallel) and prints the card's name and power limit.
2. Holds each kernel against its plain PyTorch version at the YT-VIS-19
   main-path shapes: f32 with TF32 off to 1e-4 of max|plain|, bf16 to 2e-2.
   Offsets are random and off the pixel grid. Times kernel and plain version
   with CUDA events; K2, K3, K6 and K8 (K2 and K3's launches the host takes
   longer to make than they run) by their device time (torch.profiler), the op's CUDA-event
   time beside it, each with its grid (blocks, warps a block). K1 encoder
   temporal attention on K2's tap windows (K2 equal to its plain version), at
   raster references (the encoder's own, with the reference init's offsets)
   and at random ones (the windows' worst case): the windows' sizes per
   stage, the corners read from global memory (none may lie in a window
   that fits its capacity), K1 and K2 apart and together, and the kernel lab
   (`devis_torch.ops.msda_lab`: every cost-isolation mode's time, `full`
   over three capacity plans). K3
   decoder temporal attention, K4 DCNv2 layer (each layer also timed beside
   the route the layer takes under a gradient, `modulated_deform_conv2d_rows`,
   run without one: the yardstick of the fused kernel); K5 backward of K1/K3 at the
   encoder's shape at raster references (K1's inputs) and at random
   locations, and at the decoder's; K6 and K7, single-frame attention
   forward and backward, at the six mask-head layers on the route's query
   grid (K6 by device time, its op's CUDA-event time beside it); the
   differentiable DCNv2 route (K6) against K4. A backward
   kernel's bf16 run is held against the plain version on the same inputs
   upcast to f32 (the plain version's own bf16 scatter-add loses the sum).
   Every K5 and K7 case logs the device time of the op's kernels (entries,
   sort, gather, tap gradients: `device_profile`, by the op's tag in the
   kernels' names), their launches a call, all its device work and the op
   by CUDA events.
3. Drives the inference path: `build_model` at the YT-19 R50 config (bf16,
   6+6 layers, 60 queries, seeded random weights) and `VISInferFn` over 3
   consecutive clips of a seeded synthetic 360x640 uint8 video. Launch
   counters are zeroed just before and read just after; each clip must
   launch K1, K2, K3 and K4 six times and no plain path. One clip also runs
   with the plain versions on the card, and the two are compared. K2 and K1
   run alone on the first encoder layer's inputs, K3 on decoder layer 0's
   (f32 and bf16). One clip is profiled:
   device time by kernel group and the device's idle share.
4. Drives the train path: the same model in training mode (dropout 0.1,
   mask loss on decoder levels -1 and 2), `create_train_state` and
   `make_train_step` on a seeded synthetic clip with 4 instances in 10
   target slots: 1 warm-up step, then 3 timed steps with the counters zeroed
   before and read after. Each step must launch K1, K2 and K3 6 times, K5 12
   times, K6 and K7 12 times each, K4 never, and no plain path; every loss
   finite, every parameter with a gradient, every trained tensor changed
   (counted), frozen ones not. One step is profiled and one more goes
   through `train_one_epoch`. Then one step of a model with 1 encoder and 2
   decoder layers at full width (mask loss on both decoder levels, 10 target
   slots) with the kernels against one step with the plain versions on the
   card, from the same weights and batch with dropout off: every loss, and
   every parameter's gradient against that tensor's own norm.
5. The COCO image model (Deformable-DETR R50 + mask head, 91 classes, bf16,
   6+6 layers, 300 queries, top 50; one 800x1216 image on its 832x1344
   canvas). K8 (projection-fused attention) at the encoder's shape (1 and 2
   images) and at decoder layer 0's, by device time, with the corner
   gathers' bytes through L2; K9 (backward from taps) at the decoder's shape
   by device time, its op's CUDA-event time and the op's breakdown (the
   zero, the cast, the op, the chain rule through `taps`, the whole backward:
   device ms, launches and host-clock ms a call), K10
   (deformable conv from given fields) and K4 at the six mask-head layers at
   batch 50 (each beside its route: `deform_conv2d_rows`,
   `modulated_deform_conv2d_rows`), K6 and K7 at the decoder's shape (1 and 2 images) and K7 at the
   encoder's (Q = S, 2 images), each against its plain version; K6 and K7
   at the six mask-head layers at the image train step's 50 masks (held
   against the plain versions at 10 masks where the f32 copy of U passes
   1.5 GB; K6 by device time). The
   inference path:
   `build_model` and `evaluate_coco` over a seeded synthetic dataset, 1
   warm-up image + 3 images: an image must launch K8 7, K6 5 and K4 6 times
   and no plain path; one image also runs with the plain versions on the
   card; K2 runs on encoder layer 0's inputs with an empty temporal part;
   the public op `deform_conv2d` (K10) recomputes the six mask-head layers
   of that image from their field convolutions and is held against K4; one
   image is profiled. The train path: 1 warm-up + 3 steps of
   `make_train_step` at 2 images, 25 target slots, mask loss on decoder
   levels -1 and 2: a step must launch K8 7, K6 5 + 12, K9 5, K7 7 + 12
   times; finite losses, every trained tensor moved, frozen ones not; one
   step is profiled; then a 1+2-layer step (1 image, 10 slots) with the
   kernels against the plain versions, per gradient tensor.
6. The probes (`devis_torch.ops.probes`, measurement kernels on no model
   path; run after step 5's kernel phases, before the models): K12a `tent_band` and K12b `corner_gather` at the JAX script's shape
   (C 16, Wp 384, N 32 Wp, ncand 4, reps 9) and at C 512, N 96 Wp, each
   against its plain version and K12a against K12b (f32, 1e-5 of
   max|plain|), timed by device time with the op's CUDA-event time, K12b
   beside its method's floor (its gathered reads at 128 bytes a clock an
   SM); K12c in both forms, `mma_probe` (wgmma) and `mma_probe_sync`
   (mma.sync), at 1-3 dots and at `benchmarks/mxu_probe.py:79-86`'s eight
   (n_dots, K, N), grid 912, on seeded bf16 operands (2e-2), with SM cycles
   a dot and TFLOP/s, beside one cuBLAS product of the same MACs and n_dots
   products (rate yardsticks), the wgmma form's streamed shapes also with
   clusters of 2 and 4 blocks; 96 dots must take longer than 48 in both
   forms, and the compiled library must hold HGMMA in the wgmma form's
   kernels and HMMA in the mma.sync form's (`cuobjdump -sass`, printed).
7. Video in, tracks out (right after step 3's clips, before training):
   `build_tracker` + `inference_vis` with the clip model of step 3 over the synthetic corpus of `bench.py:126-130` (4 videos
   of 36 frames, 360x640 and 480x320, 20 instances each; T 6, stride 4): one
   warm pass, then one timed pass with the counters zeroed before and read
   after. Each clip must launch K1, K2, K3 and K4 six times and no plain
   path; tracks must survive, every segmentation's RLE must have its video's
   size, and the TrackMAP summary must be finite. Prints the e2e FPS (frames
   / (wait + stitch), as `inference_vis` computes it), the wait and stitch
   seconds, the host seconds of the full-resolution resize and RLE and of
   each pipeline stage, and profiles one tracked video.
8. The CLI from files (after the COCO paths): seeded PNG trees on disk
   (`devis_torch.util.fixtures`: COCO, 9 + 4 images of 480x640 and 640x480
   with polygon, RLE and crowd annotations; YouTube-VIS 2019, 2 + 2 videos
   of 12 frames of 360x640 with RLE segmentations and null frames), then
   `devis_torch.main.main` on configs/deformable_mask_head/
   deformable_mask_head_R_50.yaml and configs/devis/YT-19/
   devis_R_50_YT-19.yaml as the files give them (the port's own YAML
   reader), bf16, seeded random weights, full width and depth. Each run has
   its counts zeroed before and read after. COCO: --eval-only (an image
   launches K8 7, K6 5, K4 6 times; finite bbox and segm stats); one epoch
   of training at batch 2 (four steps, each K8 7, K6 5 + 12, K9 5, K7 7 + 12)
   with the periodic evaluation (4 images) and checkpoints; --resume (the
   next epoch, four steps; its first starts from the checkpoint's weights to the
   bit). YT-19: 4 train steps (K1/K2/K3 6, K5 12, K6/K7 12 a step) with the
   periodic evaluation, then --eval-only (K1-K4 six a clip, tracks at the
   video's size, finite TrackMAP). Times the evaluation calls, the steps,
   the epoch loop's waits for a batch and, apart, the host's decode +
   transform + collate of a batch. After each run but the resumed one,
   every kernel it launched is held against its plain version on the
   inputs the run gave it first (layer 0 of the encoder's and decoder's
   attention, decoder layer 1's q-major op, mask-head layer 0: K2 equal,
   the forwards to 2e-2; after a train run the backwards on a seeded
   gradient, the value's to 1e-2, loc's and att's to 1e-4 of max|plain|).
9. The Swin-L configurations (after the CLI phase), each from its config
   file as the port's YAML reader gives it, bf16, full width and depth,
   seeded random weights with the noise of step 3: DeVIS Swin-L
   (configs/devis/YT-19/devis_Swin_L_YT-19.yaml) through `VISInferFn` over
   3 clips (K1-K4 six launches a clip, no plain path), the kernels on the
   path's first inputs and one whole clip against the plain versions (the
   clip path's gates), one clip profiled beside the Swin backbone alone on
   its input (softmax, layer norm, GELU, roll, matmuls, other); its clip
   train step at the train path's batch, dropout 0.1 and drop path to 0.3:
   one step with both recomputation flags against one without from the
   same weights, batch and generator seed (losses to 1e-2, each gradient
   to 5e-2 of its norm + 1e-5 of the whole, the generator's state after
   equal), then 1 + 3 steps with both flags off and 1 + 3 with both on
   (K1-K3 6 a step, twice that with the flags, K5 12, K6/K7 12; step ms,
   peak memory, one step profiled each), the kernels of the flagged run on
   its first inputs against their plain versions; the COCO image model on
   Swin-L (configs/deformable_mask_head/deformable_mask_head_SwinL.yaml,
   'coco') through `evaluate_coco`, 1 + 3 images at 800x1216 (K8 7, K6 5,
   K4 6 an image), its kernels on their first inputs and one image
   against the plain versions (the image path's gates).
10. The paper's ablation configurations (after the Swin-L phase), each from
   its file under configs/devis/ablations/, bf16, full width and depth,
   seeded random weights with the noise of step 3. Ablation 0 (Deformable
   VisTR: 36-frame clips, 360 queries, one /32 level, plain-conv + 3-d conv
   head, not instance-aware) on a seeded 36-frame video at the config's
   test size (300x533 on the 320x576 canvas): 2 clips through
   `VISInferFn` (K1, K2, K3 six launches a clip, nothing else), the
   clip's kernels on their first inputs and one clip against the plain
   versions (the clip path's gates), K2 and K1 on encoder layer 0's inputs
   and K3 on decoder layer 0's at W = 35, L = 1 in f32 and bf16 with the
   windows' sizes per stage and their device times and bounds; one train
   step of one such clip (4 instances in 10 slots; K5 12 launches, no
   plain path, finite losses, step ms and peak memory), K5 on its encoder
   layer 0's inputs with time and bound, and the step's kernels against
   their plain versions. Ablation 1 (no temporal connections, 36 frames):
   the same clips and step (K8 7 and K6 5 a clip; a step K8 7, K6 5, K7 7,
   K9 5), then a 1 + 2-layer step at full width, kernels against plain
   versions per gradient tensor. Ablations 2, 2-5, 3 and 4 (6 frames): 3
   clips each with their launches and one against the plain versions.
   Each config's clip is profiled; ablation 3's plain-conv mask head and
   3-d head also alone on that clip's inputs.
11. Training over many steps: `devis_torch.overfit_synthetic` with the MDC
   head (the JAX `benchmarks/overfit_synthetic.py`'s DeVIS: T = 4 at
   128x192, 2 + 2 layers, f32, LR 4e-4, 2 synthetic videos) for
   OVERFIT_STEPS steps, the counts zeroed before and read after (a step:
   K1, K2 and K3 2 each, K5 4, K6 and K7 12 each, K4 0), then
   `build_tracker` + `inference_vis` over its videos (a clip: K1, K2 and
   K3 2 each, K4 6); the loss
   must halve and the predicted tracks must not collapse into one; the loss
   curve, TrackMAP AP / AP50 / AP75, the pred-vs-pred IoUs and seconds a
   step are printed. Before the steps, one step of a copy of the model on
   the first clip through the kernels and through the plain versions, held
   at the train path's gates, and the kernels on that step's first inputs
   against their plain versions; after tracking, the kernels on the
   tracker's first inputs the same way.
12. DDP: NCCL at world size 1 in this process (`devis_torch.parallel`), the
   train path's full-width clip step unwrapped and in
   `DistributedDataParallel`, from the same weights and dropout seed: the
   first steps held to each other at the train path's gates, 3 timed steps
   of each (the wrapped ones' launches counted: those of step 4), and the
   all-reduce calls of one profiled step of each (DDP's buckets on top of
   the normaliser's and the metrics'). A failure to set up NCCL fails the
   run.
13. Determinism (after the kernel phases, `determinism_phase`): K5, K7 and
   K9 `REPEATS` times each on the same inputs at the paths' shapes (K5 at
   the clip encoder and decoder and at W = 35, L = 1; K7 at the clip mask
   head's six layers, the image mask head's six at 50 masks and the image
   encoder; K9 at the image decoder): every run's gradients equal the
   first's bit for bit and agree with the plain version; device time beside
   the bound.
14. The visualizers (`viz_phase`): the visualization config from its own
   file through `devis_torch.main --eval-only` on a YouTube-VIS 2021 tree
   whose two validation videos carry its `VIDEO_NAMES`, at full width
   (180 queries, bf16): K1-K4 launches counted, the kernels held to their
   plain versions on the run's first inputs, the merged overlays of both
   videos counted; `visualize_att_maps --per-level` on the same tree and
   weights, its capture held to the plain path's.
15. Prints the `kernels` JSON line (K1-K10, K12a-K12c, each with
   `redesigned`: whether its first port has been redesigned for Hopper;
   `repeat_equal`: for K5, K7 and K9 whether the determinism phase's runs
   were equal, with `determinism` by shape; K5
   and K7 with `op_ms`, `device_ms` and their times per shape;
   K6 and K8 with `op_ms` and their times per shape; K9
   with `op_ms` and its op's `breakdown`; K12a and K12b with `op_ms`, K12b
   with `method_floor_ms`; K12c with its shapes and, under `sync`, the
   mma.sync form's; `cli_launches`: its launches over the CLI phase;
   `cli_max_abs_err`: its largest error in the CLI phase's checks;
   `swin_{clip,train,remat_train,image}_launches`: its launches on each
   Swin-L path; `swin_max_abs_err`: its largest error in their checks;
   `ablation{key}_{clip,train}_launches`: its launches on each ablation
   path; `ablation_max_abs_err`: its largest error in their checks;
   `ablation0_w35` for K1, K3, K5: ms, plain ms, bound and error at
   ablation 0's W = 35, L = 1; `overfit_{train,eval}_launches` and
   `ddp_launches`: its launches in the overfit phase's steps and tracking
   and in the 3 DDP steps; `viz_launches`: over the visualization phase's
   two runs; `overfit_max_abs_err`: its largest error in the
   overfit phase's checks), a
   clip-latency line, a
   train-step line with peak memory, the image model's two lines, the e2e
   line, the `cli` line, the `swin` line, the `ablations` line (each config's
   clip latency, busy ms, idle share, step ms and peak GiB, with the card),
   the `overfit` line, the `ddp` line and the `viz` line, the card line,
   and last {"ok":
   true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or without the
`devis_torch` package beside it. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
T, NQ, NUM_OUT, STRIDE = 6, 60, 20, 4
NUM_CLASSES = 41              # YT-VIS-19 with the background
N_SLOTS, N_INSTANCES = 10, 4  # target slots of a train clip, and those filled
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
GRAD_TOL, GRAD_FLOOR = 5e-2, 1e-5   # kernel path against plain path, per tensor
# the COCO image model: one 800x1216 image on its 832x1344 canvas
COCO_CLASSES, COCO_NQ, COCO_OUT = 91, 300, 50
COCO_HW, COCO_CANVAS = (800, 1216), (832, 1344)
COCO_SHAPES = ((104, 168), (52, 84), (26, 42), (13, 21))
COCO_DCN_LAYERS = (("lay1", 264, 264, 26, 42), ("lay2", 264, 128, 26, 42),
                   ("lay3", 136, 64, 52, 84), ("lay4", 72, 32, 104, 168),
                   ("lay5", 32, 16, 208, 336), ("out_lay", 16, 1, 208, 336))
COCO_BATCH, COCO_SLOTS, COCO_INSTANCES = 2, 25, 6
COCO_MASK_CMP_B = 10          # masks of a mask-head layer the plain K7 is held at
# the probes: K12a/K12b at the JAX script's shape and at a large one (C, N / Wp)
BAND_WP, BAND_NCAND, BAND_REPS = 384, 4, 9
BAND_SHAPES = (("script", 16, 32), ("large", 512, 96))
# K12c at mxu_probe.py:79-86's (n_dots, K, N); the first is the reference shape
MMA_SHAPES = ((48, 128, 256), (24, 256, 256), (12, 512, 256), (2, 3072, 256),
              (48, 128, 128), (96, 128, 256), (48, 64, 256), (48, 32, 256))
H100_SMS = 132
# kernels whose first port has been redesigned for Hopper (PERF.md, section 6)
REDESIGNED = frozenset(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K12a",
                        "K12b", "K12c"))
# the e2e corpus (bench.py:126-130): 4 videos of 36 frames, 20 instances each
E2E_VIDEOS, E2E_FRAMES, E2E_SIZES, E2E_INSTANCES = 4, 36, ((360, 640), (480, 320)), 20


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


def device_ms(fn, kernel: str, iters: int = 20, tries: int = 3) -> float:
    """Mean device time of the kernels whose name holds `kernel` over
    `iters` calls of `fn`, from torch.profiler: the kernel's own time, which
    CUDA events around back-to-back calls miss where the host takes longer
    to launch a small kernel than the kernel runs. The profiler's schedule
    traces a warm-up window of `iters` calls first and keeps the second;
    the card idles 20 ms at each window's edges. A kept window must hold
    every launch: one that lost some (2-3 of 20 in a few windows, cause
    unknown) is logged and taken again, up to `tries` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(tries):
        kept = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.extend(p.key_averages())) as prof:
            for _ in range(2):
                time.sleep(0.02)
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.02)
                prof.step()
        total, n = 0.0, 0
        for e in kept:
            if kernel in e.key and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                total += e.self_cuda_time_total if us is None else us
                n += e.count
        if n == iters:
            return total / 1e3 / n
        counts.append(n)
        log(f"    {kernel}: {n} launches of {iters} in the profiler's window; taken again")
    raise AssertionError(f"{kernel}: {counts} launches profiled of {iters} in {tries} windows")


def device_profile(fn, iters: int = 20, tag: str = ""):
    """(device ms, kernel launches, wall ms) a call of `fn` over `iters`
    calls: the device time of every kernel and memset it launched whose name
    holds `tag` (every one by default), from torch.profiler (a warm-up
    window, then the kept one, as `device_ms`), and host-clock time a call
    of an untraced run ending in a synchronisation, which is the host's time
    where it exceeds the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    kept = []
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.extend(p.key_averages())) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    total, n = 0.0, 0
    for e in kept:
        if tag in e.key and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            total += e.self_cuda_time_total if us is None else us
            n += e.count
    if n == 0:
        raise AssertionError(f"no kernel named {tag!r} in the profiler's window")
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return total / 1e3 / iters, n / iters, (time.perf_counter() - t0) * 1e3 / iters


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


def corner_stats(loc, spatial_shapes, frames=None):
    """(taps, live in-bounds corners, distinct value rows read) of a location
    tensor (B, Q, M, Lx, P, 2) over `spatial_shapes` repeated along Lx.
    `frames` (B, Lx / L) names the value frame of each level group (the
    temporal kernels); single-frame attention reads its own batch entry."""
    import torch
    Bn, _, Mn, Lx, _, _ = loc.shape
    L = len(spatial_shapes)
    S = sum(h * w for h, w in spatial_shapes)
    starts = [0]
    for h, w in spatial_shapes[:-1]:
        starts.append(starts[-1] + h * w)
    if frames is None:
        frames = torch.arange(Bn, device=loc.device)[:, None].expand(Bn, Lx // L)
    live_corners = 0
    keys = []
    for lvl in range(Lx):
        j, l = divmod(lvl, L)
        h, w = spatial_shapes[l]
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        live = (x > -1) & (x < w) & (y > -1) & (y < h)
        x0 = torch.floor(torch.where(live, x, 0.0)).long()
        y0 = torch.floor(torch.where(live, y, 0.0)).long()
        f = frames[:, j].view(Bn, 1, 1, 1).expand_as(x0)
        m = torch.arange(Mn, device=loc.device).view(1, 1, Mn, 1).expand_as(x0)
        for oy in (0, 1):
            for ox in (0, 1):
                yi, xi = y0 + oy, x0 + ox
                ok = live & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                live_corners += int(ok.sum())
                keys.append((((f * S + starts[l] + yi * w + xi) * Mn + m)[ok]))
    rows = torch.unique(torch.cat(keys)).numel()
    return loc[..., 0].numel(), live_corners, rows


def touched_value_bytes(loc, spatial_shapes, table, itemsize):
    """Bytes of the distinct value rows (frame, pixel, head) that in-bounds
    bilinear corners of `loc` (T, Q, M, Lf, P, 2) read: the data-dependent
    input traffic of K1 and K3."""
    import torch
    frames = torch.cat([torch.arange(loc.shape[0], device=loc.device)[:, None], table], 1)
    return corner_stats(loc, spatial_shapes, frames)[2] * D * itemsize


def window_stats(torch, windows, plan, L):
    """Logs the rows a K2 window spans at each stage (frame slot j, level l):
    quartiles and maximum over the (t, m, q-block) blocks, the share of
    blocks over the level's capacity, and the rows a block stages against
    the corners it reads. Returns the summary for the JSON line."""
    from devis_torch.ops.ms_deform_attn_cuda import Q_BLOCK
    n = (windows[..., 1] - windows[..., 0] + 1).clamp(min=0).float()    # (T, M, nqb, Lf)
    Lf = n.shape[-1]
    n = n.reshape(-1, Lf)
    caps = torch.tensor([plan[s % L] for s in range(Lf)], device=n.device, dtype=n.dtype)
    over = (n > caps).float()
    qs = torch.quantile(n, torch.tensor([0.25, 0.5, 0.75], device=n.device), dim=0)
    for j in range(Lf // L):
        cells = [f"l{l} {qs[0, j * L + l]:.0f}/{qs[1, j * L + l]:.0f}/{qs[2, j * L + l]:.0f} "
                 f"max {n[:, j * L + l].max():.0f} over {over[:, j * L + l].mean():.3f}"
                 for l in range(L)]
        log(f"    window rows j={j} (quartiles, max, share over capacity): " + "; ".join(cells))
    staged = torch.minimum(n, caps).sum(1).mean().item()
    corners = Q_BLOCK * Lf * P * 4
    log(f"    a block stages {staged:.0f} rows on average and reads {corners} corners; "
        f"{over.mean().item():.3f} of the (block, stage) pairs are over capacity {tuple(plan)}")
    return dict(quartiles_by_stage=qs.T.tolist(), max_by_stage=n.max(0).values.tolist(),
                over_share=over.mean().item(), over_by_stage=over.mean(0).tolist(),
                staged_rows_per_block=staged, corners_per_block=corners)


def encoder_inputs(torch, dev, gen, refs):
    """K1's f32 inputs at the clip's shapes. "raster": the encoder's own
    references, every pixel of the pyramid a query at its pixel centre, and
    the reference init's offsets (head direction times point index + 1
    pixels) plus N(0, 1) pixels. "random": references uniform over the image
    and offsets N(0, 9) pixels, the worst case for the windows."""
    from devis_torch.models.attention import (sampling_offsets_bias_init,
                                              temporal_sampling_offsets_bias_init)
    from devis_torch.models.transformer import encoder_reference_points
    L, W = len(SHAPES), T - 1
    S = Q = sum(h * w for h, w in SHAPES)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    value = rnd(T, S, M, D)
    if refs == "raster":
        ref = encoder_reference_points(SHAPES, torch.ones(1, L, 2, device=dev))
        ref = ref.expand(T, Q, L, 2).contiguous()
        c_bias = torch.from_numpy(sampling_offsets_bias_init(M, L, P)).to(dev)
        t_bias = torch.from_numpy(temporal_sampling_offsets_bias_init(M, L, W, P)).to(dev)
        c_off = c_bias + rnd(T, Q, M * L * P * 2)
        t_off = t_bias + rnd(T, Q, M * W * L * P * 2)
    else:
        ref = torch.rand(T, Q, L, 2, generator=gen, device=dev)
        c_off = rnd(T, Q, M * L * P * 2, scale=3.0)      # pixels, off the grid
        t_off = rnd(T, Q, M * W * L * P * 2, scale=3.0)
    return (value, SHAPES, ref, c_off, t_off, rnd(T, Q, M * L * P), rnd(T, Q, M * W * L * P),
            ("all",))


def k2_grid(torch, c_off, Q, n_frames=T, window=T - 1):
    """(blocks, warps a block) of K2's default launch on these offsets."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    plan = K.tap_window_plan(M, window, len(SHAPES), P, c_off.dtype)
    blocks, threads = K.tap_window_grid(n_frames, Q, M, plan)
    return blocks, threads // 32


def k3_grid(torch, loc):
    """(blocks, warps a block) of K3's launch: a block per (t, q, m)."""
    from devis_torch.ops import _build
    return (loc.shape[0] * loc.shape[1] * loc.shape[2],
            _build.source_define("ms_deform_attn", "K3_WARPS"))


def k1_phase(torch, dev, gen, results):
    """K1 (with K2 before it, as the op runs them) at raster and at random
    references: f32 and bf16 against the plain version, the `count` mode's
    corners read from global memory (none in a window that fits), the
    windows' sizes, times; then the kernel lab on the same bf16 inputs."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.ms_deform_attn import temporal_frame_table

    L, W = len(SHAPES), T - 1
    S = Q = sum(h * w for h, w in SHAPES)
    table = torch.as_tensor(temporal_frame_table(("all",), T), device=dev)
    plan = K.window_plan(SHAPES, torch.bfloat16, D, P)
    out = {}
    for refs in ("raster", "random"):
        args32 = encoder_inputs(torch, dev, gen, refs)
        args16 = tuple(t.to(torch.bfloat16) if torch.is_tensor(t) and t is not args32[2] else t
                       for t in args32)
        log(f"K1 msda_temporal_proj (encoder) on K2's windows, {refs} references, "
            f"T={T} Q=S={S} M={M} D={D} Lf={(1 + W) * L} P={P}, bf16 plan {plan}")
        compare("f32 ", K.msda_temporal_proj(*args32), K.msda_temporal_proj_plain(*args32),
                1e-4)
        err = compare("bf16", K.msda_temporal_proj(*args16),
                      K.msda_temporal_proj_plain(*args16), 2e-2)
        windows = K.msda_tap_window(SHAPES, args16[2], args16[3], args16[4], M)
        if not torch.equal(windows, K.msda_tap_window_plain(SHAPES, *args16[2:5], M)):
            raise AssertionError(f"K2 windows differ from the plain version ({refs} references)")
        stats = window_stats(torch, windows, plan, L)
        _, reads = K.launch_k1(*args16, windows, plan, "count")
        log(f"    corners read from global memory: {reads[0].item()} in windows that fit, "
            f"{reads[1].item()} in windows over capacity (of {T * Q * M * (1 + W) * L * P * 4} "
            f"corners)")
        if reads[0].item() != 0:
            raise AssertionError("a K2 window missed a tap of K1")
        op_ms = cuda_time(lambda: K.msda_temporal_proj(*args16), 20)
        k1_ms = cuda_time(lambda: K.launch_k1(*args16, windows, plan), 20)
        k2_ms = device_ms(lambda: K.msda_tap_window(SHAPES, args16[2], args16[3], args16[4], M),
                          "msda_tap_window_kernel")
        plain_ms = cuda_time(lambda: K.msda_temporal_proj_plain(*args16), 3, 1)
        loc = K.temporal_proj_locations(SHAPES, args16[2], args16[3], args16[4], M)
        io = sum(t.numel() * t.element_size() for t in args16[2:] if torch.is_tensor(t)) \
            + T * Q * M * D * 2
        nbytes = io + touched_value_bytes(loc, SHAPES, table, 2)
        flops = T * Q * M * (1 + W) * L * P * (8 * D + 40)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        log(f"    K1 + K2 {op_ms:.4f} ms (K1 {k1_ms:.4f}, K2 {k2_ms:.4f} on grid "
            f"{k2_grid(torch, args16[3], Q)}, windows equal to the plain K2's); plain "
            f"{plain_ms:.3f} ms; bound {bound:.4f} ms")
        out[refs] = dict(max_abs_err=err, ms=k1_ms, op_ms=op_ms, k2_ms=k2_ms,
                         plain_ms=plain_ms, bytes=nbytes, flops=flops, bound_ms=bound,
                         reads=reads.tolist(), windows=stats,
                         lab=lab_phase(torch, args16, windows, plan, bound))
        del args32, args16, loc, windows
        torch.cuda.empty_cache()
    r = out["raster"]
    results["K1"] = dict(
        name="msda_temporal_proj", route="cuda", source="devis_torch/csrc/ms_deform_attn.cu",
        replaces="devis_tpu/ops/ms_deform_attn_pallas.py:1748",
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], bytes=r["bytes"],
        flops=r["flops"], flop_rate=F32_FLOPS, library_ms=None, op_ms=r["op_ms"],
        k2_ms=r["k2_ms"], windows=r["windows"], lab=r["lab"],
        random_refs={k: v for k, v in out["random"].items() if k not in ("bytes", "flops")})


def lab_phase(torch, args16, windows, plan, bound):
    """The kernel lab (`devis_torch.ops.msda_lab`) on K1's bf16 inputs: each
    mode's time at the default plan, and `full` and `count` over the
    capacity plans for 1, 2 and 3 blocks an SM. `nostage` must equal `full`
    to the bit; `count` must read no corner of a fitted window from global
    memory."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.msda_lab import MODES, lab_temporal_proj

    L = len(SHAPES)
    full, _ = lab_temporal_proj(*args16, windows, plan, "full")
    nostage, _ = lab_temporal_proj(*args16, windows, plan, "nostage")
    if not torch.equal(full, nostage):
        raise AssertionError("K1 without its window differs from K1")
    modes = {m: cuda_time(lambda m=m: lab_temporal_proj(*args16, windows, plan, m), 20)
             for m in MODES}
    log(f"    lab modes at plan {tuple(plan)}: "
        + ", ".join(f"{m} {v:.4f} ms" for m, v in modes.items()) + f" (bound {bound:.4f} ms)")
    sweep = []
    for blocks in (1, 2, 3):
        p = K.window_plan(SHAPES, torch.bfloat16, D, P, blocks_per_sm=blocks)
        ms = cuda_time(lambda: lab_temporal_proj(*args16, windows, p, "full"), 20)
        _, reads = lab_temporal_proj(*args16, windows, p, "count")
        caps = torch.tensor([p[s % L] for s in range(windows.shape[-2])], device=windows.device)
        over = ((windows[..., 1] - windows[..., 0] + 1) > caps).float().mean().item()
        smem = K.k1_smem_bytes(p, L, T - 1, torch.bfloat16, D, P)
        log(f"    plan for {blocks} block(s) an SM {p} ({smem} bytes): full {ms:.4f} ms; "
            f"over capacity {over:.3f}; global reads {reads.tolist()}")
        if reads[0].item() != 0:
            raise AssertionError("a K2 window missed a tap of K1")
        sweep.append(dict(blocks_per_sm=blocks, plan=list(p), smem=smem, ms=ms,
                          over_share=over, reads=reads.tolist()))
    return dict(modes=modes, sweep=sweep)


def msda_phases(torch, dev, gen, results):
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.ms_deform_attn import temporal_frame_table

    L = len(SHAPES)
    W = T - 1
    S = sum(h * w for h, w in SHAPES)
    rule = ("all",)
    table = torch.as_tensor(temporal_frame_table(rule, T), device=dev)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    k1_phase(torch, dev, gen, results)
    value = rnd(T, S, M, D)
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731

    log("K3 msda_temporal (decoder), T=6 Q=10 M=8 Lf=24 P=4")
    Qd = NQ // T
    loc = torch.rand(T, Qd, M, (1 + W) * L, P, 2, generator=gen, device=dev) * 1.2 - 0.1
    att = torch.softmax(rnd(T, Qd, M, (1 + W) * L * P), -1).reshape(loc.shape[:-1])
    compare("f32 ", K.msda_temporal(value, SHAPES, loc, att, rule),
            K.ms_deform_attn_temporal_plain(value, SHAPES, loc, att, rule), 1e-4)
    v16 = bf(value)
    err = compare("bf16", K.msda_temporal(v16, SHAPES, loc, att, rule),
                  K.ms_deform_attn_temporal_plain(v16, SHAPES, loc, att, rule), 2e-2)
    ms = device_ms(lambda: K.msda_temporal(v16, SHAPES, loc, att, rule), "msda_temporal_kernel")
    op_ms = cuda_time(lambda: K.msda_temporal(v16, SHAPES, loc, att, rule), 50)
    plain_ms = cuda_time(lambda: K.ms_deform_attn_temporal_plain(v16, SHAPES, loc, att,
                                                                 rule), 5, 1)
    grid = k3_grid(torch, loc)
    log(f"    K3 {ms:.4f} ms of device time on grid {grid} (blocks, warps a block); the op "
        f"{op_ms:.4f} ms a call by CUDA events (the host's launch); plain {plain_ms:.3f} ms")
    results["K3"] = dict(grid=grid, op_ms=op_ms,
        name="msda_temporal", route="cuda", source="devis_torch/csrc/ms_deform_attn.cu",
        replaces="devis_tpu/ops/ms_deform_attn_pallas.py:1406",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bytes=touched_value_bytes(loc, SHAPES, table, 2) + loc.numel() * 4
        + att.numel() * 4 + T * Qd * M * D * 2,
        flops=T * Qd * M * (1 + W) * L * P * 8 * D, flop_rate=F32_FLOPS, library_ms=None)


def clip_input(torch, dev, infer, video):
    """(x, pad): the model's normalized input for the first clip of `video`
    as `VISInferFn` prepares it."""
    images, (h, w), _ = infer.prepare(video, 0)
    x = torch.from_numpy(images).to(dev)
    x = (x.float() / 255.0 - infer._mean) / infer._std
    pad = torch.zeros(x.shape[:3], dtype=torch.bool, device=dev)
    pad[:, h:] = True
    pad[:, :, w:] = True
    return x, pad


def capture_encoder0(model, x, pad):
    """Encoder layer 0's attention module and what the main path gives it:
    (attn, query, ref (f32), src, shapes, padding, c_off, t_off)."""
    enc = model.def_detr.transformer.encoder.layers[0].self_attn
    captured = {}
    hook = enc.register_forward_pre_hook(lambda mod, args: captured.setdefault("a", args))
    try:
        model(x, pad)
    finally:
        hook.remove()
    query, ref, src, shapes, padding = captured["a"][:5]
    return (enc, query, ref.float().contiguous(), src, shapes, padding,
            enc.sampling_offsets(query).contiguous(),
            enc.temporal_sampling_offsets(query).contiguous())


def capture_decoder0(model, x, pad):
    """The arguments decoder layer 0's temporal cross-attention passes to
    `msda_temporal` on the main path: (value, shapes, loc, att, rule)."""
    from devis_torch.models import attention as attn_mod
    layer = model.def_detr.transformer.decoder.layers[0].cross_attn
    captured = {}
    op = attn_mod.msda_temporal

    def grab(*args):
        if captured.get("armed") and "a" not in captured:
            captured["a"] = args
        return op(*args)

    hook = layer.register_forward_pre_hook(lambda mod, args: captured.update(armed=True))
    attn_mod.msda_temporal = grab
    try:
        model(x, pad)
    finally:
        hook.remove()
        attn_mod.msda_temporal = op
    return captured["a"]


def tap_window_phase(torch, model, x, pad, results):
    """K2, and K1 on its windows, on the inputs the main path gives the
    first encoder layer: K2 against its plain version, the windows' sizes,
    the `count` mode's reads from global memory, K1 against its plain
    version and the two times."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    enc, query, ref, src, shapes, padding, c_off, t_off = capture_encoder0(model, x, pad)
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
    ms = device_ms(lambda: K.msda_tap_window(shapes, ref, c_off, t_off, M),
                   "msda_tap_window_kernel")
    op_ms = cuda_time(lambda: K.msda_tap_window(shapes, ref, c_off, t_off, M), 20)
    plain_ms = cuda_time(lambda: K.msda_tap_window_plain(shapes, ref, c_off, t_off, M), 3, 1)
    P = c_off.shape[-1] // (M * L * 2)
    grid = k2_grid(torch, c_off, Q, Tn, W)
    log(f"  K2 {ms:.4f} ms of device time on grid {grid} (blocks, warps a block), the op "
        f"{op_ms:.4f} ms a call by CUDA events, plain {plain_ms:.3f} ms; "
        f"at raster references {results['K1']['k2_ms']:.4f} ms, random "
        f"{results['K1']['random_refs']['k2_ms']:.4f} ms")
    value = enc._value(src, padding).contiguous()
    args = (value, shapes, ref, c_off, t_off, enc.attention_weights(query).contiguous(),
            enc.temporal_attention_weights(query).contiguous(), ("all",))
    plan = K.window_plan(shapes, value.dtype, value.shape[-1], P)
    stats = window_stats(torch, got, plan, L)
    _, reads = K.launch_k1(*args, got, plan, "count")
    err = compare("  K1 on them, bf16", K.msda_temporal_proj(*args),
                  K.msda_temporal_proj_plain(*args), 2e-2)
    k1_ms = cuda_time(lambda: K.launch_k1(*args, got, plan), 20)
    log(f"  corners read from global memory {reads.tolist()} (in fitted windows, in windows "
        f"over capacity); K1 {k1_ms:.4f} ms, K2 {ms:.4f} ms")
    if reads[0].item() != 0:
        raise AssertionError("a K2 window missed a tap of K1")
    results["K2"] = dict(
        name="msda_tap_window", route="cuda", source="devis_torch/csrc/ms_deform_attn.cu",
        replaces="devis_tpu/ops/ms_deform_attn_pallas.py:1935",
        max_abs_err=0.0, ms=ms, op_ms=op_ms, plain_ms=plain_ms, grid=grid,
        raster_ms=results["K1"]["k2_ms"], random_ms=results["K1"]["random_refs"]["k2_ms"],
        bytes=ref.numel() * 4 + (c_off.numel() + t_off.numel()) * c_off.element_size()
        + got.numel() * 4,
        flops=Tn * Q * M * (1 + W) * L * P * 12, flop_rate=F32_FLOPS, library_ms=None)
    results["K1"]["path_inputs"] = dict(ms=k1_ms, max_abs_err=err, reads=reads.tolist(),
                                        windows=stats)


def temporal_path_phase(torch, model, x, pad, results):
    """K3 on the inputs the main path gives decoder layer 0's temporal
    cross-attention (its call of `msda_temporal`, captured): against the
    plain version in bf16 (2e-2) and, upcast, in f32 with TF32 off (1e-4);
    its time beside its grid."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    value, shapes, loc, att, rule = capture_decoder0(model, x, pad)
    Tn, Qd = loc.shape[:2]
    log(f"K3 msda_temporal on decoder layer 0's inputs: T={Tn} Q={Qd} M={M} D={D} "
        f"Lf={loc.shape[3]} P={loc.shape[4]}, {value.dtype} value")
    v32 = value.float()
    compare("  f32 ", K.msda_temporal(v32, shapes, loc, att, rule),
            K.ms_deform_attn_temporal_plain(v32, shapes, loc, att, rule), 1e-4)
    err = compare("  bf16", K.msda_temporal(value, shapes, loc, att, rule),
                  K.ms_deform_attn_temporal_plain(value, shapes, loc, att, rule), 2e-2)
    ms = device_ms(lambda: K.msda_temporal(value, shapes, loc, att, rule),
                   "msda_temporal_kernel")
    op_ms = cuda_time(lambda: K.msda_temporal(value, shapes, loc, att, rule), 50)
    plain_ms = cuda_time(lambda: K.ms_deform_attn_temporal_plain(value, shapes, loc, att, rule),
                         5, 1)
    grid = k3_grid(torch, loc)
    log(f"  K3 {ms:.4f} ms of device time on grid {grid} (blocks, warps a block), the op "
        f"{op_ms:.4f} ms a call by CUDA events, plain {plain_ms:.3f} ms")
    results["K3"]["path_inputs"] = dict(ms=ms, op_ms=op_ms, plain_ms=plain_ms, max_abs_err=err,
                                        grid=grid)


def dcn_phase(torch, dev, gen, results):
    """K4 at the clip's six mask-head layers against its plain version, and
    timed beside the route the layer takes under a gradient
    (`modulated_deform_conv2d_rows`: cuDNN field convolutions, a cuBLAS
    premix and K6's gather), here without one: the yardstick the fused
    kernel has to beat."""
    from devis_torch.ops.deform_conv import (modulated_deform_conv2d,
                                             modulated_deform_conv2d_plain,
                                             modulated_deform_conv2d_rows)
    log(f"K4 modulated_deform_conv2d, B={DCN_B}, per mask-head layer")
    K = 3
    tot = dict(ms=0.0, plain_ms=0.0, route_ms=0.0, bytes=0, flops=0)
    layers = []
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
        route = [t.to(torch.bfloat16) for t in args]      # the model's bf16 biases
        route_ms = cuda_time(lambda: modulated_deform_conv2d_rows(*route), 10)
        hw = h * w
        flops = 2 * DCN_B * hw * K * K * (3 * K * K * cin + 4 * cin + cin * cout)
        nbytes = (x.numel() + sum(t.numel() for t in a16[1::2]) + DCN_B * cout * hw) * 2
        log(f"    {name} {cin}->{cout} at {h}x{w}: kernel {ms:.3f} ms, route {route_ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
        layers.append(dict(layer=name, ms=ms, route_ms=route_ms))
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["route_ms"] += route_ms
        tot["bytes"] += nbytes
        tot["flops"] += flops
    results["K4"] = dict(
        name="modulated_deform_conv2d", route="cuda", source="devis_torch/csrc/deform_conv.cu",
        replaces="devis_tpu/ops/deform_conv_banded.py:169", max_abs_err=err_max,
        ms=tot["ms"], plain_ms=tot["plain_ms"], bytes=tot["bytes"], flops=tot["flops"],
        flop_rate=BF16_TC_FLOPS, library_ms=None, route_ms=tot["route_ms"], layers=layers)
    log(f"    six layers: K4 {tot['ms']:.3f} ms, route {tot['route_ms']:.3f} ms")


def backward_cost(loc, att, value, shapes, frames, d):
    """(bytes, operations, live corners) of a backward kernel (K5, K7) on
    these inputs. Bytes are what the function must move: the distinct value
    rows the live taps read, loc, att and the output gradient read once, the
    value gradient written once in the value's type, the loc and att
    gradients written once. About 24 operations per tap and channel plus 40
    per tap. The live in-level corners are the adds onto the value gradient
    (times D) that a kernel without windows makes; no part of the bound."""
    taps, corners, rows = corner_stats(loc, shapes, frames)
    item = value.element_size()
    nbytes = (rows * d * item + 2 * (loc.numel() + att.numel()) * 4
              + loc.shape[0] * loc.shape[1] * loc.shape[2] * d * item
              + value.numel() * item)
    return nbytes, taps * (24 * d + 40), corners


BWD_TAGS = {"K5": "k5_bwd", "K7": "k7_bwd", "K9": "k9_bwd"}


def bwd_times(torch, key, op, iters=10):
    """Times of a backward op (K5, K7, K9: csrc/msda_bwd.cuh) on its bf16
    inputs: `ms` the device time of its kernels a call (entries, the radix
    sort's passes, bounds, gather, tap gradients: the kernels whose name
    holds its tag), `kernels` their launches a call, `device_ms` every
    kernel and memset of a call (the zeroed segment bounds among them),
    `op_ms` the op a call by CUDA events."""
    ms, n, _ = device_profile(op, iters, BWD_TAGS[key])
    dev_ms, launches, _ = device_profile(op, iters)
    return dict(ms=ms, kernels=n, device_ms=dev_ms, device_launches=launches,
                op_ms=cuda_time(op, iters))


def bwd_compare(torch, label, bwd, plain, args32, args16):
    """A backward kernel's f32 and bf16 gradients against its plain version;
    the bf16 run is held against the plain version on the same inputs upcast
    to f32 (the plain version's own bf16 scatter-add loses the sum). f32: the
    kernels sum in another order than the plain version; bf16: the value
    gradient is rounded once to bf16, the row gradients stay f32. Returns
    the bf16 value gradient's error."""
    up = tuple(t.float() if torch.is_tensor(t) else t for t in args16)
    err = 0.0
    for tag, args, ref_args, tols in (("f32 ", args32, args32, (1e-4, 1e-4, 1e-4)),
                                      ("bf16", args16, up, (1e-2, 1e-4, 1e-4))):
        if args is None:
            continue
        got, want = bwd(*args), plain(*ref_args)
        for part, g, w, tol in zip(("value", "loc", "att"), got, want, tols):
            e = compare(f"{label} {tag} grad_{part}", g, w, tol)
            if tag == "bf16" and part == "value":
                err = e
        del got, want
    return err


def log_bwd(where, rec):
    log(f"    {where}: kernels {rec['ms']:.4f} ms in {rec['kernels']:.0f} launches, all device "
        f"work {rec['device_ms']:.4f} ms, op {rec['op_ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.3f} ms; bound {rec['bound_ms']:.5f} ms")


def temporal_bwd_phase(torch, dev, gen, results):
    """K5 at the encoder's shape (Q = S = 5100) at raster references (K1's
    inputs: the encoder's own references, the init's offsets plus N(0, 1)
    pixels) and at random locations, and at the decoder's (Q = 10)."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.ms_deform_attn import temporal_frame_table

    L, W = len(SHAPES), T - 1
    S = sum(h * w for h, w in SHAPES)
    rule = ("all",)
    table = torch.as_tensor(temporal_frame_table(rule, T), device=dev)
    frames = torch.cat([torch.arange(T, device=dev)[:, None], table], 1)
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    cases = {}
    for case in ("encoder raster", "encoder random", "decoder"):
        Q = NQ // T if case == "decoder" else S
        log(f"K5 msda_temporal_bwd ({case}), T={T} Q={Q} M={M} D={D} Lf={(1 + W) * L} P={P}")
        if case == "encoder raster":
            a = encoder_inputs(torch, dev, gen, "raster")
            value = a[0]
            loc = K.temporal_proj_locations(SHAPES, a[2], a[3], a[4], M)
            att = K.temporal_proj_weights(a[5], a[6], M, L)
            del a
        else:
            value = torch.randn(T, S, M, D, generator=gen, device=dev)
            loc = torch.rand(T, Q, M, (1 + W) * L, P, 2, generator=gen, device=dev) * 1.2 - 0.1
            att = torch.softmax(torch.randn(T, Q, M, (1 + W) * L * P, generator=gen,
                                            device=dev), -1).reshape(loc.shape[:-1])
        grad = torch.randn(T, Q, M * D, generator=gen, device=dev)
        a16 = (bf(value), SHAPES, loc, att, bf(grad), rule)
        err = bwd_compare(torch, "", K.msda_temporal_bwd, K.msda_temporal_bwd_plain,
                          (value, SHAPES, loc, att, grad, rule), a16)
        nbytes, flops, corners = backward_cost(loc, att, a16[0], SHAPES, frames, D)
        rec = bwd_times(torch, "K5", lambda: K.msda_temporal_bwd(*a16))
        rec["plain_ms"] = cuda_time(lambda: K.msda_temporal_bwd_plain(*a16), 2, 1)
        rec.update(max_abs_err=err, bytes=nbytes, flops=flops,
                   bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3)
        log_bwd(case, rec)
        cases[case] = rec
        del value, loc, att, grad, a16
        torch.cuda.empty_cache()
    # one encoder (raster references) plus one decoder launch: a twelfth of a
    # train step's K5 work
    enc, dec = cases["encoder raster"], cases["decoder"]
    results["K5"] = dict(
        name="msda_temporal_bwd", route="cuda", source="devis_torch/csrc/ms_deform_attn.cu",
        replaces="devis_tpu/ops/ms_deform_attn_pallas.py:940",
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        **{k: enc[k] + dec[k] for k in ("ms", "op_ms", "plain_ms", "bytes", "flops",
                                         "device_ms")},
        flop_rate=F32_FLOPS, library_ms=None, shapes=cases)


REPEATS = 5                    # runs of a backward on the same inputs, bits compared


def determinism_phase(torch, dev, gen, results):
    """K5, K7 and K9 each `REPEATS` times on the same bf16 inputs at the
    paths' shapes: K5 at the clip encoder (raster references, K1's inputs)
    and decoder (Q 10) and at W = 35, L = 1 (ablation 0's encoder layer 0:
    36 frames of the 10x18 level); K7 at the clip mask head's six layers
    (D 264 down to out_lay's D 1), the image mask head's six at 50 masks
    and the image encoder (2 images, Q = S); K9 at the image decoder (2
    images, Q 300). Every run's gradients must equal the first's bit for bit
    (`torch.equal`: grad_value, grad_loc, grad_att; K9's grad_value, grad_wt)
    and the first agree with the plain version on the inputs upcast to f32
    (value 1e-2, the others 1e-4, as `bwd_compare`; the image mask head at
    `COCO_MASK_CMP_B` masks where the plain version's f32 copy of U passes
    1.5 GB). Logs each case's device time (its kernels, `device_profile`)
    beside its bound; adds `determinism` and `repeat_equal` to
    results["K5"], ["K7"], ["K9"]."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.ms_deform_attn import temporal_frame_table

    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
    out = {"K5": {}, "K7": {}, "K9": {}}

    def case(key, name, op, plain, cost, parts=("value", "loc", "att"), cut=None):
        first = [t.clone() for t in op()]
        equal = True
        for _ in range(REPEATS - 1):
            equal &= all(torch.equal(a, b) for a, b in zip(first, op()))
        want = plain()
        errs = [compare(f"{key} ({name}) grad_{part}", g if cut is None else g[:cut], w,
                        1e-2 if part == "value" else 1e-4)
                for part, g, w in zip(parts, first, want)]
        del first, want
        if not equal:
            raise AssertionError(f"{key} ({name}): {REPEATS} runs on the same inputs differ")
        ms, n, _ = device_profile(op, 5, BWD_TAGS[key])
        nbytes, flops = cost
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        log(f"    {key} {name}: {REPEATS} runs equal bit for bit; {ms:.4f} ms of device time in "
            f"{n:.0f} launches, bound {bound:.5f} ms; error {errs[0]:.3e}")
        out[key][name] = dict(repeat_equal=True, repeats=REPEATS, max_abs_err=errs[0],
                              ms=ms, kernels=n, bound_ms=bound)
        torch.cuda.empty_cache()

    log(f"determinism: K5, K7 and K9 {REPEATS} times each on the same inputs")
    L = len(SHAPES)
    S = sum(h * w for h, w in SHAPES)
    for name, Tn, shapes, Q in (("clip encoder", T, SHAPES, S),
                                ("clip decoder", T, SHAPES, NQ // T),
                                ("W=35 L=1", 36, ((10, 18),), 180)):
        W, Ln, Sn = Tn - 1, len(shapes), sum(h * w for h, w in shapes)
        rule = ("all",)
        if name == "clip encoder":
            a = encoder_inputs(torch, dev, gen, "raster")
            value = a[0]
            loc = K.temporal_proj_locations(SHAPES, a[2], a[3], a[4], M).contiguous()
            att = K.temporal_proj_weights(a[5], a[6], M, L).contiguous()
            del a
        else:
            value = rnd(Tn, Sn, M, D)
            loc = torch.rand(Tn, Q, M, (1 + W) * Ln, P, 2, generator=gen, device=dev) * 1.2 - 0.1
            att = torch.softmax(rnd(Tn, Q, M, (1 + W) * Ln * P), -1).reshape(loc.shape[:-1])
        a16 = (bf(value), shapes, loc, att, bf(rnd(Tn, Q, M * D)), rule)
        up = tuple(t.float() if torch.is_tensor(t) else t for t in a16)
        table = torch.as_tensor(temporal_frame_table(rule, Tn), device=dev)
        frames = torch.cat([torch.arange(Tn, device=dev)[:, None], table], 1)
        nbytes, flops, _ = backward_cost(loc, att, a16[0], shapes, frames, D)
        case("K5", name, lambda: K.msda_temporal_bwd(*a16),
             lambda: K.msda_temporal_bwd_plain(*up), (nbytes, flops))
        del value, loc, att, a16, up
    for where, B, layers in (("clip", DCN_B, DCN_LAYERS),
                             ("image", COCO_SLOTS * COCO_BATCH, COCO_DCN_LAYERS)):
        for lname, _, cout, h, w in layers:
            shapes = ((h, w),) * 9
            if where == "clip":
                value, loc, att, grad = mask_head_rows(torch, dev, gen, B, cout, h, w)
            else:
                value = rnd(B, 9 * h * w, 1, cout)
                loc = dcn_route_loc(torch, dev, gen, B, h, w)
                att = torch.rand(B, h * w, 1, 9, 1, generator=gen, device=dev) * 2.0
                grad = rnd(B, h * w, cout)
            a16 = (bf(value), shapes, loc, att, bf(grad))
            del value, grad
            nb = B if B * 9 * h * w * cout * 4 <= 1.5e9 else COCO_MASK_CMP_B
            cut = tuple(t[:nb].float() if torch.is_tensor(t) and t.dtype == torch.bfloat16
                        else t[:nb] if torch.is_tensor(t) else t for t in a16)
            nbytes, flops, _ = backward_cost(loc, att, a16[0], shapes, None, cout)
            case("K7", f"{where} {lname} D={cout} B={B}", lambda: K.msda_rows_bwd(*a16),
                 lambda: K.msda_rows_bwd_plain(*cut), (nbytes, flops), cut=nb)
            del loc, att, a16, cut
    Sc, Lc = sum(h * w for h, w in COCO_SHAPES), len(COCO_SHAPES)
    value = rnd(COCO_BATCH, Sc, M, D)
    loc = torch.rand(COCO_BATCH, Sc, M, Lc, P, 2, generator=gen, device=dev) * 1.2 - 0.1
    att = torch.softmax(rnd(COCO_BATCH, Sc, M, Lc * P), -1).reshape(loc.shape[:-1])
    a16 = (bf(value), COCO_SHAPES, loc, att, bf(rnd(COCO_BATCH, Sc, M * D)))
    up = tuple(t.float() if torch.is_tensor(t) else t for t in a16)
    nbytes, flops, _ = backward_cost(loc, att, a16[0], COCO_SHAPES, None, D)
    case("K7", f"image encoder B={COCO_BATCH}", lambda: K.msda_rows_bwd(*a16),
         lambda: K.msda_rows_bwd_plain(*up), (nbytes, flops))
    del value, loc, att, a16, up
    value, loc, att = image_decoder_rows(torch, dev, gen, COCO_BATCH)
    idx, wt = K.taps(COCO_SHAPES, loc, att)
    v16, g16 = bf(value), bf(rnd(COCO_BATCH, COCO_NQ, M * D))
    rows = corner_stats(loc, COCO_SHAPES)[2]
    live = int((wt != 0).sum())
    nbytes = rows * D * 2 + idx.numel() * 4 + 2 * wt.numel() * 4 + g16.numel() * 2 \
        + v16.numel() * 2
    case("K9", f"image decoder B={COCO_BATCH}",
         lambda: K.msda_taps_bwd(v16, COCO_SHAPES, idx, wt, g16),
         lambda: K.msda_taps_bwd_plain(v16.float(), COCO_SHAPES, idx, wt, g16.float()),
         (nbytes, idx.numel() * 2 * D + live * 2 * D), parts=("value", "wt"))
    for key, cases in out.items():
        results[key]["determinism"] = cases
        results[key]["repeat_equal"] = all(c["repeat_equal"] for c in cases.values())


def mask_head_rows(torch, dev, gen, B, cout, h, w):
    """(value f32, loc, att, grad f32) of K6/K7 at one clip mask-head layer:
    U as 9 one-point levels of one head, each pixel's taps at its centre
    plus offsets of N(0, 2) pixels, some off the map."""
    hw = h * w
    value = torch.randn(B, 9 * hw, 1, cout, generator=gen, device=dev)
    base = torch.stack(torch.meshgrid(
        (torch.arange(w, device=dev) + 0.5) / w, (torch.arange(h, device=dev) + 0.5) / h,
        indexing="xy"), -1).reshape(1, hw, 1, 1, 1, 2)
    jitter = torch.randn(B, hw, 1, 9, 1, 2, generator=gen, device=dev) * 2.0
    loc = (base + jitter / torch.tensor([w, h], device=dev)).contiguous()
    att = torch.rand(B, hw, 1, 9, 1, generator=gen, device=dev) * 2.0
    grad = torch.randn(B, hw, cout, generator=gen, device=dev)
    return value, loc, att, grad


def rows_phase(torch, dev, gen, results):
    """K6 and K7 at the six mask-head layers (the K*K positions of U = x . W
    as 9 one-point levels of one head), and the K6 route against K4."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import (modulated_deform_conv2d,
                                             modulated_deform_conv2d_rows)
    from devis_torch.ops.ms_deform_attn import ms_deform_attn

    log(f"K6 msda_rows / K7 msda_rows_bwd, B={DCN_B}, 9 levels, per mask-head layer")
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    fwd = dict(ms=0.0, op_ms=0.0, plain_ms=0.0, bytes=0, flops=0, err=0.0, layers=[])
    bwd = dict(ms=0.0, op_ms=0.0, plain_ms=0.0, bytes=0, flops=0, device_ms=0.0, err=0.0,
               layers=[])
    for name, cin, cout, h, w in DCN_LAYERS:
        shapes = ((h, w),) * 9
        hw = h * w
        value, loc, att, grad = mask_head_rows(torch, dev, gen, DCN_B, cout, h, w)
        v16, g16 = bf(value), bf(grad)
        with torch.no_grad():
            if name in ("lay1", "lay5"):
                compare(f"{name} K6 f32 ", K.msda_rows(value, shapes, loc, att),
                        ms_deform_attn(value, shapes, loc, att), 1e-4)
            err = compare(f"{name} K6 bf16", K.msda_rows(v16, shapes, loc, att),
                          ms_deform_attn(v16, shapes, loc, att), 2e-2)
            fwd["err"] = max(fwd["err"], err)
            op = lambda: K.msda_rows(v16, shapes, loc, att)  # noqa: E731
            ms = device_ms(op, "msda_rows_kernel", iters=10)
            op_ms = cuda_time(op, 10)
            plain_ms = cuda_time(lambda: ms_deform_attn(v16, shapes, loc, att), 2, 1)
        taps, _, rows = corner_stats(loc, shapes)
        nbytes = rows * cout * 2 + (loc.numel() + att.numel()) * 4 + DCN_B * hw * cout * 2
        fwd["ms"] += ms
        fwd["op_ms"] += op_ms
        fwd["plain_ms"] += plain_ms
        fwd["bytes"] += nbytes
        fwd["flops"] += taps * 8 * cout
        fwd["layers"].append(dict(layer=name, ms=ms, op_ms=op_ms, plain_ms=plain_ms,
                                  bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                               taps * 8 * cout / F32_FLOPS) * 1e3))
        line = (f"    {name} D={cout} at {h}x{w}: K6 {ms:.4f} ms by device time, op "
                f"{op_ms:.4f} ms (plain {plain_ms:.3f}), bound "
                f"{fwd['layers'][-1]['bound_ms']:.4f} ms")

        a16 = (v16, shapes, loc, att, g16)
        err = bwd_compare(torch, f"{name} K7", K.msda_rows_bwd, K.msda_rows_bwd_plain,
                          (value, shapes, loc, att, grad) if name in ("lay1", "lay5") else None,
                          a16)
        bwd["err"] = max(bwd["err"], err)
        nbytes, flops, corners = backward_cost(loc, att, v16, shapes, None, cout)
        rec = bwd_times(torch, "K7", lambda: K.msda_rows_bwd(*a16))
        rec["plain_ms"] = cuda_time(lambda: K.msda_rows_bwd_plain(*a16), 2, 1)
        rec.update(layer=name, bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3)
        for k in ("ms", "op_ms", "plain_ms", "device_ms"):
            bwd[k] += rec[k]
        bwd["bytes"] += nbytes
        bwd["flops"] += flops
        bwd["layers"].append(rec)
        log(line)
        log_bwd(f"{name} K7", rec)
        del value, loc, att, grad, v16, g16, a16
        torch.cuda.empty_cache()
    for key, tot, nm, line in (("K6", fwd, "msda_rows", 354), ("K7", bwd, "msda_rows_bwd", 773)):
        results[key] = dict(
            name=nm, route="cuda", source="devis_torch/csrc/ms_deform_attn_rows.cu",
            replaces=f"devis_tpu/ops/ms_deform_attn_pallas.py:{line}", max_abs_err=tot["err"],
            ms=tot["ms"], plain_ms=tot["plain_ms"], bytes=tot["bytes"], flops=tot["flops"],
            flop_rate=F32_FLOPS, library_ms=None,
            **{k: tot[k] for k in ("op_ms", "device_ms", "layers") if k in tot})

    log("DCNv2 layer: the differentiable route (K6) against K4 on the same inputs")
    Kk = 3
    for name, cin, cout, h, w in (DCN_LAYERS[0], DCN_LAYERS[4]):
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=dev) * scale
        fan = (Kk * Kk * cin) ** 0.5
        args = [rnd(DCN_B, cin, h, w), rnd(Kk, Kk, cin, 2 * Kk * Kk, scale=2.0 / fan),
                rnd(2 * Kk * Kk, scale=0.5), rnd(Kk, Kk, cin, Kk * Kk, scale=1.0 / fan),
                rnd(Kk * Kk), rnd(Kk, Kk, cin, cout, scale=1.0 / fan), rnd(cout)]
        a16 = [bf(t) for t in args]
        with torch.no_grad():
            torch.backends.cudnn.allow_tf32 = False
            compare(f"{name} f32 ", modulated_deform_conv2d_rows(*args),
                    modulated_deform_conv2d(*args), 1e-4)
            # bf16: the route rounds its offset and modulation fields and U to
            # bf16 (as the JAX package's does); K4 keeps them in f32
            compare(f"{name} bf16", modulated_deform_conv2d_rows(*a16),
                    modulated_deform_conv2d(*a16), 3e-2)


def probe_phase(torch, dev, gen, results):
    """K12a, K12b and K12c (`devis_torch.ops.probes`, measurement only)
    against their plain versions; K12a against K12b; their times, K12b's
    beside its method's floor. K12c in both forms (wgmma, the default, and
    mma.sync) at the JAX probe's eight shapes with its cycles a dot and
    rate, beside one cuBLAS product of the same MACs and n_dots products
    (rate yardsticks); its streamed shapes also with clusters of 2 and 4
    blocks sharing the tiles' TMA loads."""
    from devis_torch.ops import _build, probes

    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    for label, C, rows in BAND_SHAPES:
        N = rows * BAND_WP
        u = torch.rand(C, N + BAND_NCAND * BAND_WP, generator=gen, device=dev)
        dy = torch.rand(N, generator=gen, device=dev) * 2 - 1
        dx = torch.rand(N, generator=gen, device=dev) * 2 - 1
        args = (u, dy, dx, BAND_NCAND, BAND_WP, BAND_REPS)
        log(f"K12a tent_band / K12b corner_gather, C={C} Wp={BAND_WP} N={N} "
            f"ncand={BAND_NCAND} reps={BAND_REPS}")
        tent, gather = probes.tent_band(*args), probes.corner_gather(*args)
        # f32, every tap in the band: summation order only
        err_a = compare("K12a f32", tent, probes.tent_band_plain(*args), 1e-5)
        err_b = compare("K12b f32", gather, probes.corner_gather_plain(*args), 1e-5)
        compare("K12a against K12b", tent, gather, 1e-5)
        nbytes = 4 * (u.numel() + 2 * N + C * N)
        # the function has at most 4 nonzero taps a (c, n, rep): both bounds
        # count 4 multiply-adds; `method_flops` is what each method issues
        # (K12a's band: ncand² multiply-adds)
        flops = 8 * C * N * BAND_REPS
        # K12b's method gathers 4 f32 corners a (c, n, rep): its floor at
        # 128 bytes a clock an SM from shared memory, at the max SM clock
        gathered = 16 * C * N * BAND_REPS
        floor_b = gathered / (128 * H100_SMS * clock_mhz * 1e6) * 1e3
        for key, op, plain, err, method_flops in (
                ("K12a", probes.tent_band, probes.tent_band_plain, err_a,
                 2 * C * N * BAND_REPS * BAND_NCAND ** 2),
                ("K12b", probes.corner_gather, probes.corner_gather_plain, err_b, flops)):
            ms = device_ms(lambda: op(*args), op.__name__ + "_kernel")
            op_ms = cuda_time(lambda: op(*args), 20)
            plain_ms = cuda_time(lambda: plain(*args), 3, 1)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            log(f"    {key} {op.__name__}: {ms:.4f} ms by device time, op {op_ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.2f} GFLOP; the method issues {method_flops / 1e9:.2f} GFLOP, "
                f"{method_flops / F32_FLOPS * 1e3:.4f} ms at the f32 peak)"
                + (f"; the method's floor {floor_b:.4f} ms ({gathered / 1e9:.2f} GB of "
                   f"gathered reads at 128 B a clock an SM, {clock_mhz:.0f} MHz)"
                   if key == "K12b" else ""))
            entry = dict(ms=ms, op_ms=op_ms, plain_ms=plain_ms, max_abs_err=err, bytes=nbytes,
                         flops=flops, method_flops=method_flops, C=C, N=N, bound_ms=bound)
            if key == "K12b":
                entry["method_floor_ms"] = floor_b
            if label == "script":
                results[key + "_script"] = entry
            else:
                results[key] = dict(
                    entry, name=op.__name__, route="cuda", source="devis_torch/csrc/probes.cu",
                    replaces="benchmarks/bench_tent_gather.py:" + ("23" if key == "K12a" else "41"),
                    flop_rate=F32_FLOPS, library_ms=None,
                    script_shape=results.pop(key + "_script"))

    forms = (probes.mma_probe, probes.mma_probe_sync)
    log(f"K12c mma_probe (wgmma) and mma_probe_sync (mma.sync), grid {probes.GRID}, "
        f"D {probes.D}, bf16 (max SM clock {clock_mhz:.0f} MHz)")
    # at 1-3 dots a dropped or extra product is a 33-100 % error, far above
    # the bf16 limit; at the timed shapes' 12-96 dots it would be 1-8 %
    for n_dots, K in ((1, 128), (2, 128), (3, 128), (1, 3072), (2, 3072), (3, 3072)):
        v = torch.randn(K, probes.D, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(K, 256, generator=gen, device=dev).to(torch.bfloat16)
        for op in forms:
            compare(f"{op.__name__} n_dots={n_dots} K={K} N=256 bf16", op(v, w, n_dots),
                    probes.mma_probe_plain(v, w, n_dots), 2e-2)
    shapes = {op.__name__: [] for op in forms}
    for n_dots, K, Nw in MMA_SHAPES:
        v = torch.randn(K, probes.D, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(K, Nw, generator=gen, device=dev).to(torch.bfloat16)
        want = probes.mma_probe_plain(v, w, n_dots)
        plain_ms = cuda_time(lambda: probes.mma_probe_plain(v, w, n_dots), 3, 1)
        a = v.t().contiguous().repeat(probes.GRID, 1)            # (GRID * D, K)
        lib48_ms = cuda_time(lambda: [torch.mm(a, w) for _ in range(n_dots)], 10)
        a_all = a.repeat(n_dots, 1)                              # (GRID * D * n_dots, K)
        lib_ms = cuda_time(lambda: torch.mm(a_all, w), 10)
        del a, a_all
        flops = 2 * probes.GRID * n_dots * K * probes.D * Nw
        log(f"  n_dots={n_dots} K={K} N={Nw}: cuBLAS one mm ({probes.GRID * probes.D * n_dots}"
            f"x{K})x({K}x{Nw}) {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), "
            f"{n_dots} x mm ({probes.GRID * probes.D}x{K})x({K}x{Nw}) {lib48_ms:.4f} ms; "
            f"plain {plain_ms:.3f} ms")
        for op in forms:
            resident = (probes.mma_probe_resident if op is probes.mma_probe
                        else probes.mma_sync_resident)(K, Nw)
            # bf16 operands, f32 accumulation in another order: one output rounding
            err = compare(f"{op.__name__} n_dots={n_dots} K={K} N={Nw} bf16", op(v, w, n_dots),
                          want, 2e-2)
            ms = cuda_time(lambda: op(v, w, n_dots), 10)
            cycles = ms * 1e-3 * clock_mhz * 1e6 * H100_SMS / (probes.GRID * n_dots)
            tflops = flops / ms / 1e9
            row = dict(n_dots=n_dots, K=K, N=Nw, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_48_ms=lib48_ms, cycles_a_dot=cycles, tflops=tflops,
                       max_abs_err=err, flops=flops, resident=resident)
            extra = ""
            if op is probes.mma_probe and not resident:
                # the streamed tiles shared by clusters of 2 and 4 blocks
                row["cluster_ms"] = {c: cuda_time(lambda: op(v, w, n_dots, cluster=c), 10)
                                     for c in (2, 4)}
                extra = "; clusters of 2 / 4 blocks " + " / ".join(
                    f"{t:.4f}" for t in row["cluster_ms"].values()) + " ms"
            log(f"    {op.__name__} {'resident' if resident else 'streamed'}: {ms:.4f} ms, "
                f"{cycles:.0f} SM cycles a dot, {tflops:.1f} TFLOP/s "
                f"({tflops / (BF16_TC_FLOPS / 1e12):.3f} of the bf16 peak){extra}")
            shapes[op.__name__].append(row)
    for name, rows in shapes.items():
        by = {(r["n_dots"], r["K"], r["N"]): r for r in rows}
        if not by[(96, 128, 256)]["ms"] > 1.5 * by[(48, 128, 256)]["ms"]:
            raise AssertionError(f"K12c {name}: 96 dots did not take longer than 48: the "
                                 "products were folded or dropped")
    # the wgmma form compiles to HGMMA, the mma.sync form to HMMA: counted in
    # each kernel's own SASS (cuobjdump)
    lib = os.path.join(_build.BUILD_DIR, "libprobes.so")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True).stdout
    counts = {"mma_probe_wgmma_kernel": 0, "mma_probe_sync_kernel": 0}
    kernel = None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = next((k for k in counts if k in line), None)
        elif kernel is not None:
            counts[kernel] += ("HGMMA" if "wgmma" in kernel else "HMMA") in line
    hgmma, hmma = counts["mma_probe_wgmma_kernel"], counts["mma_probe_sync_kernel"]
    log(f"    libprobes.so's SASS (cuobjdump): HGMMA in the wgmma form {hgmma}, "
        f"HMMA in the mma.sync form {hmma}")
    if hgmma == 0 or hmma == 0:
        raise AssertionError("K12c: the wgmma form holds no HGMMA or the mma.sync form no HMMA")
    ref, ref_sync = shapes["mma_probe"][0], shapes["mma_probe_sync"][0]
    results["K12c"] = dict(
        name="mma_probe", route="cuda", source="devis_torch/csrc/probes.cu",
        replaces="benchmarks/mxu_probe.py:37",
        max_abs_err=max(r["max_abs_err"] for rows in shapes.values() for r in rows),
        ms=ref["ms"], plain_ms=ref["plain_ms"], library_ms=ref["library_ms"],
        library_48_ms=ref["library_48_ms"],
        bytes=2 * (ref["K"] * (probes.D + ref["N"]) + probes.D * ref["N"]),
        flops=ref["flops"], flop_rate=BF16_TC_FLOPS, shapes=shapes["mma_probe"],
        sync=dict(name="mma_probe_sync", ms=ref_sync["ms"], shapes=shapes["mma_probe_sync"]),
        hgmma_in_sass=hgmma, hmma_in_sass=hmma, max_sm_clock_mhz=clock_mhz)


def probe_ops():
    from devis_torch.ops import probes
    return probes.tent_band, probes.corner_gather, probes.mma_probe, probes.mma_probe_sync


def check_probes_idle(after):
    """The probes' launch and plain-call counts since `probe_phase` (zeroed
    at its end): the probes lie on no model path, so all stay 0."""
    counts = {fn.__name__: (fn.launches, fn.plain_calls) for fn in probe_ops()}
    log(f"  probes after {after}: (launches, plain calls) {counts}")
    if any(n for pair in counts.values() for n in pair):
        raise AssertionError(f"a probe ran on a model path ({after}): {counts}")
    return {name: pair[0] for name, pair in counts.items()}


KERNEL_GROUPS = {"K1 msda_temporal_proj": "msda_temporal_proj_win_kernel",
                 "K2 msda_tap_window": "msda_tap_window_kernel",
                 "K5 msda_temporal_bwd": "k5_bwd",
                 "K3 msda_temporal": "msda_temporal_kernel",
                 "K7 msda_rows_bwd": "k7_bwd",
                 "K6 msda_rows": "msda_rows_kernel",
                 "K8 msda_proj": "msda_proj_kernel",
                 "K9 msda_taps_bwd": "k9_bwd",
                 "K4 / K10 dcn_layer": "dcn_layer_"}   # dcn_layer_mma_kernel, _f32_kernel


def profile_run(torch, what, fn, groups=KERNEL_GROUPS):
    """Device time of one call of `fn` by kernel group (`groups`: a group's
    name → a substring of its kernels' lower-case names; the rest as cuDNN
    convolutions, matmuls or other), from torch.profiler, and the share of
    its wall time the device was busy. Returns (busy ms, wall ms, ms by
    group)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sums = dict.fromkeys(list(groups) + ["convolutions (cuDNN)", "matmuls", "other"], 0.0)
    top = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        # kernel events only: a CPU op's own entry, and an annotation's span
        # on the device (the optimizer's), repeat their kernels' time
        if us <= 0 or getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."):
            continue
        name = e.key
        top.append((us, e.count, name))
        low = name.lower()
        group = next((g for g, k in groups.items() if k in low), None)
        if group is None:
            group = ("convolutions (cuDNN)"
                     if any(k in low for k in ("conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad"))
                     else "matmuls" if any(k in low for k in ("gemm", "cutlass", "matmul", "nvjet"))
                     else "other")
        sums[group] += us / 1e3
    busy = sum(sums.values())
    log(f"profile of one {what} ({wall_ms:.3f} ms wall): device busy {busy:.3f} ms, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for g, ms in sums.items():
        if ms:
            log(f"  {g}: {ms:.3f} ms")
    for us, n, name in sorted(top, reverse=True)[:10]:
        log(f"    {us / 1e3:8.3f} ms  x{n:<4d} {name[:90]}")
    return busy, wall_ms, sums


def check_counts(ops, wants):
    """Each op launched its kernel `want` times and never took the plain path."""
    for fn, want in zip(ops, wants):
        if fn.launches != want or fn.plain_calls:
            raise AssertionError(f"{fn.__name__}: {fn.launches} launches "
                                 f"(want {want}), {fn.plain_calls} plain calls")


class _Video:
    """Seeded synthetic uint8 video: a drifting colour gradient with moving
    rectangles, `n` frames of `hw` (360x640), in clips of `clip` frames
    `STRIDE` apart."""

    def __init__(self, n: int, seed: int, hw=VIDEO_HW, clip: int = T):
        import numpy as np
        rs = np.random.RandomState(seed)
        h, w = hw
        self.clip = clip
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
        return self.frames[i * STRIDE:i * STRIDE + self.clip]


def move_taps_off_the_grid(torch, model, dev, box_noise):
    """The reference init zeroes the offset and logit projections, which puts
    every tap on the pixel grid; seeded noise moves them off it. It also
    zeroes the box heads' last layer, which makes every box, and so every
    later layer's reference, independent of the attention; a quarter of that
    noise there (`box_noise`) lets the boxes tell a wrong kernel. The two
    train-step compares leave it out: the L1 and GIoU losses turn on the
    sign of differences of bf16 boxes, so one bf16 step between two correct
    paths moved the box heads' gradients by up to 9e-2 of their norm."""
    gen = torch.Generator().manual_seed(SEED + 1)
    box_gen = torch.Generator().manual_seed(SEED + 8)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if any(s in name for s in ("sampling_offsets.weight", "attention_weights.weight",
                                       "offset_conv.weight", "modulator_conv.weight")):
                p.add_(torch.randn(p.shape, generator=gen).to(dev) / p[0].numel() ** 0.5)
            elif box_noise and "bbox_embed" in name and name.endswith("layers.2.weight"):
                p.add_(torch.randn(p.shape, generator=box_gen).to(dev)
                       * 0.25 / p[0].numel() ** 0.5)


def build(torch, dev, enc_layers=6, dec_layers=6, mask_aux=(2,), box_noise=True):
    """(cfg, model): DeVIS R50 at the YT-VIS-19 widths, bf16 compute, seeded
    random weights, in eval mode."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model

    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "vis"
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.LOSS.MASK_AUX_LOSS = list(mask_aux)
    cfg.MODEL.LOSS.AUX_LOSS_WEIGHTING = True
    cfg.MODEL.NUM_QUERIES = NQ
    cfg.MODEL.BBX_GRADIENT_PROP = True
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = enc_layers
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = dec_layers
    cfg.MODEL.DEVIS.NUM_FRAMES = T
    cfg.TEST.NUM_OUT = NUM_OUT
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = VIDEO_HW
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.freeze()
    t0 = time.perf_counter()
    model = build_model(NUM_CLASSES, cfg, seed=SEED)
    move_taps_off_the_grid(torch, model, dev, box_noise)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: DeVIS R50 YT-19, {enc_layers}+{dec_layers} layers, bf16, {n_params} "
        f"parameters, built in {time.perf_counter() - t0:.1f} s")
    return cfg, model


def check_clip_fetch(torch, outs, cfg, hw, canvas):
    """Each `VISInferFn` result of a clip of frames `hw` on `canvas` has the
    fetch's shapes and dtypes at the config's frames, queries and NUM_OUT
    (masks for every trajectory where they are no more than NUM_OUT),
    finite scores in [0, 1], ordered boxes and labels and gathers in
    range."""
    import numpy as np

    from devis_torch.util.box_ops import box_cxcywh_to_xyxy

    Tn, k_out = cfg.MODEL.DEVIS.NUM_FRAMES, cfg.TEST.NUM_OUT
    nq = cfg.MODEL.NUM_QUERIES // Tn
    want = {"scores": (Tn, k_out), "labels": (k_out,), "boxes": (Tn, k_out, 4),
            "center_points": (Tn, k_out, 2), "mask_gather": (k_out,)}
    for r in outs:
        shapes = {k: tuple(np.shape(r[k])) for k in want}
        ml = r["mask_logits"]
        if shapes != want or tuple(ml.shape) != (min(nq, k_out), Tn, canvas[0] // 4,
                                                 canvas[1] // 4) \
                or ml.dtype != torch.float8_e4m3fn \
                or r["valid_hw"] != (round(hw[0] / 4), round(hw[1] / 4)):
            raise AssertionError(f"fetch shapes {shapes}, masks {tuple(ml.shape)} "
                                 f"{ml.dtype}, valid_hw {r['valid_hw']}")
        xyxy = box_cxcywh_to_xyxy(torch.from_numpy(r["boxes"]))
        if not (np.isfinite(r["scores"]).all() and np.isfinite(r["boxes"]).all()
                and torch.isfinite(ml.float()).all()
                and ((r["scores"] >= 0) & (r["scores"] <= 1)).all()
                and (xyxy[..., 2:] >= xyxy[..., :2]).all()
                and ((r["labels"] >= 0) & (r["labels"] < NUM_CLASSES)).all()  # 41 logits
                and ((r["mask_gather"] >= 0) & (r["mask_gather"] < nq)).all()):
            raise AssertionError("non-finite or out-of-range outputs")


@contextlib.contextmanager
def plain_forward():
    """Within the block a model's forward takes the plain versions of K1, K3,
    K8, the q-major op and K4 in place of the kernels (the clip without
    temporal connections, DeVIS ablations, takes the single-frame ops)."""
    from devis_torch.models import attention as attn_mod
    from devis_torch.models import segmentation as seg_mod
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import modulated_deform_conv2d_plain
    from devis_torch.ops.ms_deform_attn import ms_deform_attn

    sites = ((attn_mod, "msda_temporal_proj", K.msda_temporal_proj_plain),
             (attn_mod, "msda_temporal", K.ms_deform_attn_temporal_plain),
             (attn_mod, "msda_proj", K.msda_proj_plain), (attn_mod, "msda_taps", ms_deform_attn),
             (seg_mod, "modulated_deform_conv2d", modulated_deform_conv2d_plain))
    saved = [getattr(mod, name) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(sites, saved):
            setattr(mod, name, fn)


def clip_vs_plain(torch, model, x, pad):
    """One clip through the kernels and through their plain versions on the
    card, held to the clip path's gates. Returns the errors."""
    with torch.inference_mode():
        out_k, res_k = model(x, pad)
        with plain_forward():
            out_p, res_p = model(x, pad)
    # bf16 end to end through 12 attention layers and 6 DCNv2 layers: the two
    # paths round at different places, so probabilities and mask logits agree
    # to 5e-2 of their largest magnitude (a seeded model's probabilities are
    # small, so an absolute limit would say nothing) and normalized boxes to 2e-2
    # (five bf16 steps just below 1)
    errs = {}
    prob_k, prob_p = (torch.sigmoid(o["pred_logits"].float()) for o in (out_k, out_p))
    top = prob_p.max().item()
    errs["pred_logits / max"] = ((prob_k - prob_p).abs().max() / top).item()
    box_err = (out_k["pred_boxes"].float() - out_p["pred_boxes"].float()).abs().max().item()
    mk, mp = res_k["masks"].float(), res_p["masks"].float()
    errs["masks / max|masks|"] = ((mk - mp).abs().max() / mp.abs().max()).item()
    log(f"  kernel path vs plain path on the card, max abs diff over the largest plain value "
        f"({top:.4f} for probabilities): {errs} (limit 5e-2); pred_boxes {box_err:.3e} "
        f"(limit 2e-2)")
    if not all(v <= 5e-2 for v in errs.values()) or box_err > 2e-2:
        raise AssertionError("kernel path disagrees with the plain path")
    return dict(errs, pred_boxes=box_err)


def clip_ops():
    """The wrappers a clip model may launch: K1, K2, K3, K5 (temporal), K8,
    K6, K9, K7 (single frame: the clip without temporal connections), K4."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import modulated_deform_conv2d
    return [K.msda_temporal_proj, K.msda_tap_window, K.msda_temporal, K.msda_temporal_bwd,
            K.msda_proj, K.msda_rows, K.msda_taps_bwd, K.msda_rows_bwd,
            modulated_deform_conv2d]


def clip_wants(cfg, model, train: bool = False):
    """Launches of `clip_ops` a clip (with `train`, a train step of a model
    without DCNv2 layers): with temporal connections K1, K2 once an encoder
    layer and K3 once a decoder layer, K5 once each in the backward;
    without them K8 once an encoder layer and at decoder layer 0 (2-d
    references), K6 at the later decoder layers (4-d references after the
    first box refinement), K9 and K7 their backwards; K4 once a DCNv2 layer
    of the mask head."""
    from devis_torch.models.segmentation import ModulatedDeformableConv
    n_enc = cfg.MODEL.TRANSFORMER.ENCODER_LAYERS
    n_dec = cfg.MODEL.TRANSFORMER.DECODER_LAYERS
    n_dcn = sum(isinstance(m, ModulatedDeformableConv) for m in model.modules())
    if train and n_dcn:
        raise ValueError("clip_wants counts the train step of a plain-conv mask head only")
    b = int(train)
    if cfg.MODEL.DEVIS.DEFORMABLE_ATTENTION.DISABLE_TEMPORAL_CONNECTIONS:
        return [0, 0, 0, 0, n_enc + 1, n_dec - 1, b * (n_dec - 1), b * (n_enc + 1), n_dcn]
    return [n_enc, n_enc, n_dec, b * (n_enc + n_dec), 0, 0, 0, 0, n_dcn]


def infer_clips(torch, card, cfg, model, what="inference path", n_clips=3):
    """`VISInferFn` over `n_clips` clips of the seeded 360x640 video,
    resized to the config's test size as `ValTransform` sizes it, on the
    canvas of its eval buckets, after a warm-up, the counts zeroed just
    before and read just after: `clip_wants` a clip and no plain path; the
    fetches checked. Returns (infer, video, launches, latencies in ms)."""
    from devis_torch.datasets.transforms import get_size_with_aspect_ratio
    from devis_torch.inference import VISInferFn, make_eval_buckets

    Tn = cfg.MODEL.DEVIS.NUM_FRAMES
    hw = get_size_with_aspect_ratio(VIDEO_HW, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    buckets = make_eval_buckets(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    log(f"{what}: VISInferFn over {n_clips} clips of {Tn} frames of {hw[0]}x{hw[1]} on the "
        f"{buckets[0][0]}x{buckets[0][1]} canvas")
    video = _Video(Tn + (n_clips - 1) * STRIDE, SEED, hw=hw, clip=Tn)
    infer = VISInferFn(model, Tn, buckets)
    infer(video, 0)                                      # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    ops = clip_ops()
    zero_coco_counts(ops)
    lat = []
    outs = []
    for i in range(n_clips):
        t0 = time.perf_counter()
        outs.append(infer(video, i))
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = {fn.__name__: fn.launches for fn in ops}
    plain = {fn.__name__: fn.plain_calls for fn in ops}
    log(f"  launches over {n_clips} clips: {launches}; plain calls: {plain}")
    check_coco_counts(ops, [n_clips * c for c in clip_wants(cfg, model)])
    check_clip_fetch(torch, outs, cfg, hw, buckets[0])
    clip_ms = sum(lat) / len(lat)
    log(f"  clip latency {[round(v, 3) for v in lat]} ms, mean {clip_ms:.3f} ms; "
        f"FPS = stride {STRIDE} / latency = {STRIDE / clip_ms * 1e3:.3f} ({card})")
    return infer, video, launches, lat


def main_path(torch, dev, card, cfg, model, results):
    infer, video, launches, lat = infer_clips(torch, card, cfg, model)
    # One clip with the plain versions on the card, against the kernels.
    x, pad = clip_input(torch, dev, infer, video)
    clip_vs_plain(torch, model, x, pad)
    with torch.inference_mode():
        tap_window_phase(torch, model, x, pad, results)
        temporal_path_phase(torch, model, x, pad, results)
    profile_run(torch, "clip", lambda: infer(video, 0))
    return launches, sum(lat) / len(lat)


def e2e_phase(torch, dev, card, cfg, model):
    """Video in, tracks out: `build_tracker` + `inference_vis` over the
    synthetic corpus of `bench.py:126-130`, one warm pass, then one timed
    pass with the launch counters zeroed before and read after; one video
    profiled. The warm pass draws every frame once and the corpus keeps it
    (a stand-in for decoded frames), so the timed pass's prepare stage is
    the frame resize and the canvas padding. Returns (e2e record, launches)."""
    import math
    import threading

    from devis_torch.datasets.synthetic import SyntheticVISValDataset
    from devis_torch.inference import build_tracker, inference_vis
    from devis_torch.models.segmentation import ModulatedDeformableConv
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import modulated_deform_conv2d
    from devis_torch.tracking import track as track_mod

    def corpus(n_videos):
        return SyntheticVISValDataset(
            num_frames=T, stride=STRIDE, n_videos=n_videos, video_len=E2E_FRAMES,
            sizes=E2E_SIZES, n_inst=E2E_INSTANCES, min_size=cfg.INPUT.MIN_SIZE_TEST,
            max_size=cfg.INPUT.MAX_SIZE_TEST, seed=SEED)

    dataset = corpus(E2E_VIDEOS)
    n_clips = sum(len(v) for v in dataset)
    frames = dataset.get_total_num_frames()
    log(f"e2e: build_tracker + inference_vis, {E2E_VIDEOS} videos x {E2E_FRAMES} frames "
        f"{E2E_SIZES}, {E2E_INSTANCES} instances each, {n_clips} clips")
    # host time of the full-resolution resize + RLE, summed over the threads
    # that run it (the tracker's encode pool and the stitching thread)
    spent = {"s": 0.0, "masks": 0, "frame_resize_s": 0.0}
    lock = threading.Lock()
    to_rle = track_mod.SmallMask.to_rle

    class TimedTransform(type(dataset[0].transform)):
        def __call__(self, img):
            t0 = time.perf_counter()
            out = super().__call__(img)
            with lock:
                spent["frame_resize_s"] += time.perf_counter() - t0
            return out

    timed_transform = TimedTransform(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    for video in dataset:
        video.transform = timed_transform

    def timed_to_rle(self):
        t0 = time.perf_counter()
        out = to_rle(self)
        with lock:
            spent["s"] += time.perf_counter() - t0
            spent["masks"] += 1
        return out

    track_mod.SmallMask.to_rle = timed_to_rle
    try:
        tracker = build_tracker(cfg, model)
        # seconds in each pipeline stage, summed over its threads' calls
        stages = dict.fromkeys(("prepare", "dispatch", "fetch"), 0.0)
        for stage in stages:
            def timed_stage(*a, _fn=getattr(tracker.infer_fn, stage), _stage=stage):
                t0 = time.perf_counter()
                out = _fn(*a)
                with lock:
                    stages[_stage] += time.perf_counter() - t0
                return out
            setattr(tracker.infer_fn, stage, timed_stage)
        t0 = time.perf_counter()
        inference_vis(tracker, dataset, verbose=False)            # warm (cuDNN plans)
        warm_s = time.perf_counter() - t0
        tracker.wait_time = tracker.stitch_time = 0.0
        spent.update(s=0.0, masks=0, frame_resize_s=0.0)
        stages.update(prepare=0.0, dispatch=0.0, fetch=0.0)
        ops = (K.msda_temporal_proj, K.msda_tap_window, K.msda_temporal,
               modulated_deform_conv2d)
        for fn in ops:
            fn.launches = fn.plain_calls = 0
        t0 = time.perf_counter()
        out = inference_vis(tracker, dataset, verbose=False)
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in ops}
        plain = {fn.__name__: fn.plain_calls for fn in ops}
    finally:
        track_mod.SmallMask.to_rle = to_rle
    n_dcn = sum(isinstance(m, ModulatedDeformableConv) for m in model.modules())
    log(f"  launches over the timed pass: {launches}; plain calls: {plain}")
    check_counts(ops, (n_clips * cfg.MODEL.TRANSFORMER.ENCODER_LAYERS,
                       n_clips * cfg.MODEL.TRANSFORMER.ENCODER_LAYERS,
                       n_clips * cfg.MODEL.TRANSFORMER.DECODER_LAYERS, n_clips * n_dcn))

    sizes = {v.video_id: list(v.original_size) for v in dataset}
    results = out["results"]
    if not results:
        raise AssertionError("e2e: no track survived the score thresholds")
    for r in results:
        segs = [s for s in r["segmentations"] if s is not None]
        if not segs or any(s["size"] != sizes[r["video_id"]] for s in segs) \
                or len(r["segmentations"]) != E2E_FRAMES or not math.isfinite(r["score"]):
            raise AssertionError(f"e2e: malformed track of video {r['video_id']}")
    summary = {k: out["eval"][k] for k in ("AP", "AP50", "AP75", "AR")}
    if not all(math.isfinite(v) for v in summary.values()):
        raise AssertionError(f"e2e: TrackMAP not finite: {summary}")
    rec = dict(e2e_fps=out["fps"], wait_s=tracker.wait_time, stitch_s=tracker.stitch_time,
               resize_rle_s=spent["s"], resize_rle_masks=spent["masks"],
               frame_resize_s=spent["frame_resize_s"], frames=frames,
               clips=n_clips, tracks=len(results), pass_wall_s=wall_s, warm_pass_s=warm_s,
               stage_s=dict(stages), trackmap=summary, card=card)
    log(f"  e2e FPS {out['fps']:.3f} = {frames} frames / (wait {tracker.wait_time:.3f} s + "
        f"stitch {tracker.stitch_time:.3f} s); pass wall {wall_s:.3f} s; resize + RLE "
        f"{spent['s']:.3f} s of host time over {spent['masks']} masks; {len(results)} tracks; "
        f"TrackMAP {summary} ({card})")
    log("  pipeline stages, seconds summed over their calls: "
        + ", ".join(f"{k} {v:.3f} s ({v / n_clips * 1e3:.1f} ms a clip)" for k, v in stages.items())
        + f"; of prepare, the frame resize {spent['frame_resize_s']:.3f} s")
    one = corpus(1)
    profile_run(torch, f"e2e video ({len(one[0])} clips, inference_vis)",
                lambda: inference_vis(build_tracker(cfg, model), one, verbose=False))
    return rec, launches


def kernel_ops():
    """The wrappers that count launches, K1-K3, K5-K7, K4."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import modulated_deform_conv2d
    return [K.msda_temporal_proj, K.msda_tap_window, K.msda_temporal, K.msda_temporal_bwd,
            K.msda_rows, K.msda_rows_bwd, modulated_deform_conv2d]


def train_batch(n_slots):
    from devis_torch.util.synthetic import synthetic_clip_batch
    return synthetic_clip_batch(SEED + 2, T, (384, 640), VIDEO_HW, min(N_INSTANCES, n_slots),
                                n_slots, NUM_CLASSES - 1)


def check_parameters_moved(torch, model, labels, before):
    """Every parameter holds a gradient, every trained tensor changed since
    `before`, no frozen one did."""
    no_grad, still, moved_frozen, n_moved = [], [], [], 0
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        if p.grad is None:                 # cut from the graph
            no_grad.append(name)
        if labels[name] == "frozen":
            if not same:
                moved_frozen.append(name)
        elif not same:
            n_moved += 1
        # a trained tensor may stand still only where it is exactly zero and so
        # is its gradient (AdamW then leaves it at zero)
        elif p.grad is None or bool(p.grad.abs().max() > 0) or bool(p.detach().abs().max() > 0):
            still.append(name)
    n_trained = sum(v != "frozen" for v in labels.values())
    log(f"  {n_moved} of {n_trained} trained tensors moved; {len(moved_frozen)} of "
        f"{len(labels) - n_trained} frozen ones moved; {len(no_grad)} tensors without a gradient")
    if no_grad or still or moved_frozen:
        raise AssertionError(f"no gradient: {no_grad}; trained but unchanged: {still}; "
                             f"frozen but moved: {moved_frozen}")


def timed_steps(torch, step, state, batch, gen, n_steps):
    """`n_steps` train steps, each timed to its synchronisation and held to
    finite metrics. Returns (state, the steps' ms)."""
    import numpy as np
    step_ms = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        m = {k: float(v) for k, v in metrics.items()}
        log(f"  step {i}: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f} "
            f"finite {m['finite']:.0f}  {step_ms[-1]:.3f} ms")
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad or m["finite"] != 1.0:
            raise AssertionError(f"step {i}: non-finite {bad or 'loss'}")
    return state, step_ms


def train_path(torch, dev, card, cfg, model):
    """1 warm-up and 3 timed steps through `make_train_step` at full width
    and depth; launch counts, finite losses, which parameters moved."""
    import numpy as np

    from devis_torch.engine import (create_train_state, make_train_step, param_labels,
                                    train_one_epoch)
    from devis_torch.models.segmentation import ModulatedDeformableConv

    log(f"train path: make_train_step, 1 clip a step, {N_INSTANCES} instances in "
        f"{N_SLOTS} slots, dropout {cfg.MODEL.DROPOUT}")
    state = create_train_state(cfg, model, steps_per_epoch=100)
    step = make_train_step(model, cfg)
    batch = train_batch(N_SLOTS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    labels = param_labels(model, cfg)
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch, gen)               # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    ops = kernel_ops()
    for fn in ops:
        fn.launches = fn.plain_calls = 0
    n_steps = 3
    state, step_ms = timed_steps(torch, step, state, batch, gen, n_steps)
    launches = {fn.__name__: fn.launches for fn in ops}
    plain = {fn.__name__: fn.plain_calls for fn in ops}
    log(f"  launches over {n_steps} steps: {launches}; plain calls: {plain}")
    n_enc = cfg.MODEL.TRANSFORMER.ENCODER_LAYERS
    n_dec = cfg.MODEL.TRANSFORMER.DECODER_LAYERS
    n_dcn = sum(isinstance(m, ModulatedDeformableConv) for m in model.modules())
    n_mask = 1 + len(cfg.MODEL.LOSS.MASK_AUX_LOSS)
    check_counts(ops, [n_steps * c for c in (n_enc, n_enc, n_dec, n_enc + n_dec,
                                             n_dcn * n_mask, n_dcn * n_mask, 0)])
    if state.step != 1 + n_steps:
        raise AssertionError(f"{state.step} updates after {1 + n_steps} steps")

    check_parameters_moved(torch, model, labels, before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean_ms = float(np.mean(step_ms))
    log(f"  train step {[round(v, 3) for v in step_ms]} ms, mean {mean_ms:.3f} ms; "
        f"peak memory {peak:.3f} GiB ({card})")
    profile_run(torch, "train step", lambda: step(state, batch, gen))
    # and one step through the host epoch loop, which raises on a non-finite loss
    done = state.step
    state, averages = train_one_epoch(step, state, [batch], gen, epoch=0)
    if state.step != done + 1 or not np.isfinite(averages["loss"]):
        raise AssertionError(f"epoch loop: step {state.step}, averages {averages}")
    return launches, mean_ms, peak


def report_step_difference(torch, out, what="kernel-path train step disagrees with the "
                                            "plain path"):
    """`out`: ((metrics, gradients) of the kernel step, of the plain step).
    Returns the largest differences: of a metric and of a tensor, each to
    its own value, and of the whole gradient to its norm."""
    (mk, gk), (mp, gp) = out
    # bf16 end to end: the two paths round at different places. Every loss
    # and the gradient norm to 1e-2 of its value (or 1e-3 absolute). Each
    # parameter's clipped gradient to GRAD_TOL of that tensor's own norm,
    # plus GRAD_FLOOR of the whole gradient's norm: a tensor whose gradient
    # is below a few 1e-5 of the whole (the last decoder layer's offset
    # biases) carries bf16 rounding noise of about a tenth of its own size
    worst = max(((abs(mk[k] - mp[k]) / max(abs(mp[k]), 0.1), k) for k in mp
                 if k not in ("finite", "class_error")))
    total = torch.sqrt(sum(gp[k].double().square().sum() for k in gp)).item()
    rows = []
    for k in gp:
        diff = (gk[k] - gp[k]).double().norm().item()
        own = gp[k].double().norm().item()
        rows.append((diff / max(own, 1e-30), diff, own, k))
    rows.sort(reverse=True)
    bad = [r for r in rows if r[1] > GRAD_TOL * r[2] + GRAD_FLOOR * total]
    diff_all = sum(r[1] ** 2 for r in rows) ** 0.5
    log(f"  loss {mk['loss']:.5f} vs {mp['loss']:.5f}; grad_norm {mk['grad_norm']:.4f} vs "
        f"{mp['grad_norm']:.4f}; worst metric {worst[1]} off by {worst[0]:.3e} "
        f"(limit 1e-2); all gradients |diff| / |grad| = {diff_all / total:.3e}")
    log(f"  per tensor |diff| / |own grad| over {len(rows)} tensors (limit {GRAD_TOL:g} + "
        f"{GRAD_FLOOR:g} of the whole norm {total:.4f}); the largest:")
    for rel, diff, own, k in rows[:8]:
        log(f"    {rel:.3e}  |diff| {diff:.3e}  |grad| {own:.3e}  {k}")
    proj = [r for r in rows if any(s in r[3] for s in ("sampling_offsets", "attention_weights",
                                                       "offset_conv", "modulator_conv"))]
    log(f"  the {len(proj)} offset, logit and field projections, where the kernels' loc and "
        f"att gradients land; the largest:")
    for rel, diff, own, k in proj[:8]:
        log(f"    {rel:.3e}  |diff| {diff:.3e}  |grad| {own:.3e}  {k}")
    if worst[0] > 1e-2 or bad or mk["finite"] != 1.0:
        raise AssertionError(f"{what}: "
                             f"{[r[3] for r in bad]}")
    return {"metric_rel": worst[0], "tensor_rel": rows[0][0], "grad_rel": diff_all / total}


def compare_train_paths(torch, cfg, model_k, batch, ops, plain_names):
    """One train step of `model_k` with the kernels and one of its copy with
    the plain versions on the card (dropout off): `plain_names` maps a
    kernel wrapper's name in `models.attention` or `ops.deform_conv` to its
    plain version in `ops.ms_deform_attn_cuda`. Reports every loss and every
    parameter's gradient against that tensor's own norm, and returns
    `report_step_difference`'s largest differences."""
    import copy

    from devis_torch.engine import create_train_state, make_train_step
    from devis_torch.models import attention as attn_mod
    from devis_torch.models.layers import Dropout
    from devis_torch.ops import deform_conv as dc_mod
    from devis_torch.ops import ms_deform_attn_cuda as K

    for mod in model_k.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    model_p = copy.deepcopy(model_k)
    patches = [(dc_mod if name == "msda_rows" else attn_mod, name, getattr(K, plain))
               for name, plain in plain_names.items()]
    out = []
    for tag, model in (("kernels", model_k), ("plain", model_p)):
        for fn in ops:
            fn.launches = fn.plain_calls = 0
        saved = [getattr(mod, name) for mod, name, _ in patches]
        if tag == "plain":
            for mod, name, plain in patches:
                setattr(mod, name, plain)
        try:
            state = create_train_state(cfg, model, steps_per_epoch=100)
            _, metrics = make_train_step(model, cfg)(state, batch)
        finally:
            for (mod, name, _), fn in zip(patches, saved):
                setattr(mod, name, fn)
        counts = {fn.__name__: fn.launches for fn in ops}
        log(f"  {tag} step: launches {counts}")
        n = sum(counts.values())
        if (n == 0) != (tag == "plain") or any(fn.plain_calls for fn in ops):
            raise AssertionError(f"{tag} step launched {n} kernels")
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: p.grad.float() for k, p in model.named_parameters()}))
        torch.cuda.empty_cache()
    return report_step_difference(torch, out)


def train_compare(torch, dev):
    """The clip model: 1 encoder and 2 decoder layers at full width with the
    mask loss on both decoder levels (the plain versions keep every gathered
    tap for their backward, about 30 GB an encoder layer), the same batch as
    the train path's (10 target slots, so the DCNv2 batch is 60)."""
    log("kernel path against plain path, one train step, 1+2 layers at full width")
    cfg, model = build(torch, dev, 1, 2, mask_aux=(0,), box_noise=False)
    compare_train_paths(torch, cfg, model, train_batch(N_SLOTS), kernel_ops(),
                        {"msda_temporal_proj": "msda_temporal_proj_plain",
                         "msda_temporal": "ms_deform_attn_temporal_plain",
                         "msda_rows": "ms_deform_attn"})


# ---------------------------------------------------------------------------
# the COCO image model
# ---------------------------------------------------------------------------

def k8_inputs(torch, dev, gen, B, Q):
    """(value, ref, off, logit) f32 of K8 at the image model's heads: random
    references, offsets of N(0, 3) pixels (off the grid, some off the map),
    N(0, 1) logits."""
    L = len(COCO_SHAPES)
    S = sum(h * w for h, w in COCO_SHAPES)
    value = torch.randn(B, S, M, D, generator=gen, device=dev)
    ref = torch.rand(B, Q, L, 2, generator=gen, device=dev)
    off = torch.randn(B, Q, M * L * P * 2, generator=gen, device=dev) * 3.0
    logit = torch.randn(B, Q, M * L * P, generator=gen, device=dev)
    return value, ref, off, logit


def image_decoder_rows(torch, dev, gen, B):
    """(value f32, loc, att) of K6 at the image decoder's shape: Q 300,
    locations uniform on [-0.1, 1.1], softmax weights."""
    L = len(COCO_SHAPES)
    S = sum(h * w for h, w in COCO_SHAPES)
    value = torch.randn(B, S, M, D, generator=gen, device=dev)
    loc = torch.rand(B, COCO_NQ, M, L, P, 2, generator=gen, device=dev) * 1.2 - 0.1
    att = torch.softmax(torch.randn(B, COCO_NQ, M, L * P, generator=gen, device=dev),
                        -1).reshape(B, COCO_NQ, M, L, P)
    return value, loc, att


def taps_bwd_breakdown(torch, K, v16, loc, att, g16):
    """K9's op and the backward around it at the image decoder's shape, as
    `device_profile` gives them: the zero of the f32 value gradient, the
    cast of it to bf16, the op (zero, K9, cast), the chain rule through
    `taps` (the taps rebuilt under autograd, their weights' gradient taken
    to loc and att), and the whole backward of `msda_taps` (the op and the
    chain)."""
    shape = v16.shape
    gv = torch.zeros(shape, dtype=torch.float32, device=v16.device)
    idx, wt = K.taps(COCO_SHAPES, loc, att)
    g_wt = K.msda_taps_bwd(v16, COCO_SHAPES, idx, wt, g16)[1]

    def chain():
        with torch.enable_grad():
            lc, at = loc.detach().requires_grad_(), att.detach().requires_grad_()
            return torch.autograd.grad(K.taps(COCO_SHAPES, lc, at)[1], (lc, at), g_wt)

    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_() for t in (v16, loc, att))
        out = K.msda_taps(leaves[0], COCO_SHAPES, *leaves[1:])
    parts = {"zero": lambda: torch.zeros(shape, dtype=torch.float32, device=v16.device),
             "cast": lambda: gv.to(torch.bfloat16),
             "op": lambda: K.msda_taps_bwd(v16, COCO_SHAPES, idx, wt, g16),
             "chain through taps": chain,
             "backward": lambda: torch.autograd.grad(out, leaves, g16, retain_graph=True)}
    return {part: device_profile(fn) for part, fn in parts.items()}


def coco_kernel_phases(torch, dev, gen, results):
    """K8, K9 and K10, and K6, K7 and K4 again, at the image model's shapes
    against their plain versions."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import (deform_conv2d, deform_conv2d_plain,
                                             deform_conv2d_rows, modulated_deform_conv2d,
                                             modulated_deform_conv2d_plain,
                                             modulated_deform_conv2d_rows)
    from devis_torch.ops.ms_deform_attn import ms_deform_attn

    L = len(COCO_SHAPES)
    S = sum(h * w for h, w in COCO_SHAPES)
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # K8 by device time (its op's CUDA-event time beside it) at the encoder
    # (one image, and the train step's two) and at decoder layer 0; the
    # kernels line sums one encoder and one decoder-layer-0 launch of an image
    tot = dict(ms=0.0, op_ms=0.0, plain_ms=0.0, bytes=0, flops=0, err=0.0, shapes={})
    with torch.inference_mode():
        for where, B, Q in (("encoder", 1, S), ("encoder B=2", 2, S),
                            ("decoder layer 0", 1, COCO_NQ)):
            log(f"K8 msda_proj ({where}), B={B} Q={Q} S={S} M={M} D={D} L={L} P={P}")
            value, ref, off, logit = k8_inputs(torch, dev, gen, B, Q)
            a32 = (value, COCO_SHAPES, ref, off, logit)
            a16 = (bf(value), COCO_SHAPES, ref, bf(off), bf(logit))
            if B == 1:
                compare("f32 ", K.msda_proj(*a32), K.msda_proj_plain(*a32), 1e-4)
            err = compare("bf16", K.msda_proj(*a16), K.msda_proj_plain(*a16), 2e-2)
            op = lambda: K.msda_proj(*a16)  # noqa: E731
            ms = device_ms(op, "msda_proj_kernel")
            op_ms = cuda_time(op, 20)
            plain_ms = cuda_time(lambda: K.msda_proj_plain(*a16), 3, 1)
            loc = K.proj_locations(COCO_SHAPES, ref, a16[3], M)
            taps, corners, rows = corner_stats(loc, COCO_SHAPES)
            nbytes = rows * D * 2 + ref.numel() * 4 + (off.numel() + logit.numel()) * 2 \
                + B * Q * M * D * 2
            flops = B * Q * M * L * P * (8 * D + 40)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            # the corner gathers' traffic through L2: D channels a live corner
            l2_bytes = corners * D * 2
            log(f"    {where}: kernel {ms:.5f} ms by device time, op {op_ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms; bound {bound:.5f} ms ({nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.3f} GFLOP); corner gathers {l2_bytes / 1e9:.3f} GB through L2")
            tot["shapes"][where] = dict(ms=ms, op_ms=op_ms, plain_ms=plain_ms, bound_ms=bound,
                                        l2_bytes=l2_bytes)
            tot["err"] = max(tot["err"], err)
            if B == 1:
                tot["ms"] += ms
                tot["op_ms"] += op_ms
                tot["plain_ms"] += plain_ms
                tot["bytes"] += nbytes
                tot["flops"] += flops
            del value, ref, off, logit, a32, a16, loc
    results["K8"] = dict(
        name="msda_proj", route="cuda", source="devis_torch/csrc/ms_deform_attn_proj.cu",
        replaces="devis_tpu/ops/ms_deform_attn_pallas.py:2210", max_abs_err=tot["err"],
        ms=tot["ms"], op_ms=tot["op_ms"], plain_ms=tot["plain_ms"], bytes=tot["bytes"],
        flops=tot["flops"], flop_rate=F32_FLOPS, library_ms=None, shapes=tot["shapes"])

    B, Q = COCO_BATCH, COCO_NQ
    log(f"K9 msda_taps_bwd (decoder), B={B} Q={Q} M={M} D={D} L={L}, {4 * P} entries a level")
    value, loc, att = image_decoder_rows(torch, dev, gen, B)
    grad = rnd(B, Q, M * D)
    idx, wt = K.taps(COCO_SHAPES, loc, att)
    for tag, v, g, tols in (("f32 ", value, grad, (1e-4, 1e-4)),
                            ("bf16", bf(value), bf(grad), (1e-2, 1e-4))):
        got = K.msda_taps_bwd(v, COCO_SHAPES, idx, wt, g)
        want = K.msda_taps_bwd_plain(v.float(), COCO_SHAPES, idx, wt, g.float())
        for part, gg, ww, tol in zip(("value", "wt"), got, want, tols):
            e = compare(f"{tag} grad_{part}", gg, ww, tol)
            if tag == "bf16" and part == "value":
                err = e
    v16, g16 = bf(value), bf(grad)
    op = lambda: K.msda_taps_bwd(v16, COCO_SHAPES, idx, wt, g16)  # noqa: E731
    rec9 = bwd_times(torch, "K9", op, iters=20)
    ms, op_ms = rec9["ms"], rec9["op_ms"]
    plain_ms = cuda_time(lambda: K.msda_taps_bwd_plain(v16, COCO_SHAPES, idx, wt, g16), 3, 1)
    live = int((wt != 0).sum())
    rows = corner_stats(loc, COCO_SHAPES)[2]
    nbytes = rows * D * 2 + idx.numel() * 4 + 2 * wt.numel() * 4 + g16.numel() * 2 \
        + v16.numel() * 2
    flops = idx.numel() * 2 * D + live * 2 * D
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    breakdown = taps_bwd_breakdown(torch, K, v16, loc, att, g16)
    log(f"    kernels {ms:.5f} ms by device time in {rec9['kernels']:.0f} launches, all device "
        f"work {rec9['device_ms']:.5f} ms, op {op_ms:.4f} ms, plain {plain_ms:.3f} ms; "
        f"bound {bound:.5f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); "
        f"{live} live entries, grid {K.taps_plan(D, torch.bfloat16, True)}")
    for part, (dms, n, wall) in breakdown.items():
        log(f"    {part}: device {dms:.5f} ms in {n:.1f} launches, wall {wall:.4f} ms a call")
    results["K9"] = dict(
        name="msda_taps_bwd", route="cuda", source="devis_torch/csrc/ms_deform_attn_taps.cu",
        replaces="devis_tpu/ops/ms_deform_attn_pallas.py:443", max_abs_err=err,
        ms=ms, op_ms=op_ms, plain_ms=plain_ms, bytes=nbytes, flops=flops,
        flop_rate=F32_FLOPS, library_ms=None, device_ms=rec9["device_ms"],
        breakdown={part: dict(device_ms=dms, launches=n, wall_ms=wall)
                   for part, (dms, n, wall) in breakdown.items()})
    del idx, wt, v16, g16

    # K6 and K7 where the image model launches them: K6 in decoder layers 1-5
    # (one image when serving, the batch when training), K7 as K8's backward
    # in decoder layer 0 and in the six encoder layers (Q = S)
    def rows_at(where, value, loc, att, grad, forward):
        v16, g16 = bf(value), bf(grad)
        times = {}
        if forward:
            with torch.no_grad():
                compare(f"{where} K6 f32 ", K.msda_rows(value, COCO_SHAPES, loc, att),
                        ms_deform_attn(value, COCO_SHAPES, loc, att), 1e-4)
                compare(f"{where} K6 bf16", K.msda_rows(v16, COCO_SHAPES, loc, att),
                        ms_deform_attn(v16, COCO_SHAPES, loc, att), 2e-2)
                op = lambda: K.msda_rows(v16, COCO_SHAPES, loc, att)  # noqa: E731
                ms = device_ms(op, "msda_rows_kernel")
                op_ms = cuda_time(op, 20)
                plain_ms = cuda_time(lambda: ms_deform_attn(v16, COCO_SHAPES, loc, att), 3, 1)
            taps, _, rows = corner_stats(loc, COCO_SHAPES)
            nbytes = rows * D * 2 + (loc.numel() + att.numel()) * 4 + grad.numel() * 2
            times["K6"] = dict(ms=ms, op_ms=op_ms, plain_ms=plain_ms, bound_ms=max(
                nbytes / HBM_BYTES_PER_S, taps * 8 * D / F32_FLOPS) * 1e3)
        a16 = (v16, COCO_SHAPES, loc, att, g16)
        bwd_compare(torch, f"{where} K7", K.msda_rows_bwd, K.msda_rows_bwd_plain,
                    (value, COCO_SHAPES, loc, att, grad), a16)
        nbytes, flops, corners = backward_cost(loc, att, v16, COCO_SHAPES, None, D)
        rec = bwd_times(torch, "K7", lambda: K.msda_rows_bwd(*a16))
        rec["plain_ms"] = cuda_time(lambda: K.msda_rows_bwd_plain(*a16), 2, 1)
        rec.update(bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3)
        times["K7"] = rec
        for key, t in times.items():
            if key == "K7":
                log_bwd(f"{where} K7", t)
            else:
                log(f"    {where}: {key} {t['ms']:.5f} ms by device time, op {t['op_ms']:.4f} "
                    f"ms, plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms")
            results[key].setdefault("coco_shapes", {})[where] = t
        torch.cuda.empty_cache()

    log(f"K6 msda_rows / K7 msda_rows_bwd at the image model's shapes, S={S} M={M} D={D} "
        f"L={L} P={P}")
    rows_at(f"decoder B=1 Q={Q}", value[:1], loc[:1], att[:1], grad[:1], forward=True)
    rows_at(f"decoder B={B} Q={Q}", value, loc, att, grad, forward=True)
    del loc, att, grad
    loc = torch.rand(B, S, M, L, P, 2, generator=gen, device=dev) * 1.2 - 0.1
    att = torch.softmax(rnd(B, S, M, L * P), -1).reshape(B, S, M, L, P)
    rows_at(f"encoder B={B} Q={S}", value, loc, att, rnd(B, S, M * D), forward=False)
    del value, loc, att
    coco_mask_head_bwd_phase(torch, dev, gen, results)

    log(f"K10 deform_conv2d (and K4 on the same layers), B={COCO_OUT}, per mask-head layer; "
        "each beside its route without a gradient (cuDNN fields, cuBLAS premix, K6)")
    tot = dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0, err=0.0, k4=0.0, route_ms=0.0,
               k4_route=0.0, k4_flops=0, k4_bytes=0)
    layers, k4_layers = [], []
    with torch.inference_mode():
        for name, cin, cout, h, w in COCO_DCN_LAYERS:
            hw = h * w
            fan = (9 * cin) ** 0.5
            x = rnd(COCO_OUT, cin, h, w)
            offset = rnd(COCO_OUT, 18, h, w, scale=2.0)     # pixels, some off the map
            mask = torch.rand(COCO_OUT, 9, h, w, generator=gen, device=dev) * 2.0
            weight, bias = rnd(3, 3, cin, cout, scale=1.0 / fan), rnd(cout)
            a16 = (bf(x), bf(offset), bf(mask), bf(weight), bias)
            if name in ("lay1", "lay5"):
                compare(f"{name} f32 ", deform_conv2d(x, offset, mask, weight, bias),
                        deform_conv2d_plain(x, offset, mask, weight)
                        + bias[None, :, None, None], 1e-4)
            plain16 = lambda: (deform_conv2d_plain(*a16[:4])  # noqa: E731
                               + bias[None, :, None, None]).to(torch.bfloat16)
            tot["err"] = max(tot["err"], compare(f"{name} bf16", deform_conv2d(*a16),
                                                 plain16(), 2e-2))
            ms = cuda_time(lambda: deform_conv2d(*a16), 5)
            plain_ms = cuda_time(plain16, 2, 1)
            route_ms = cuda_time(lambda: deform_conv2d_rows(*a16), 5)
            k4 = [a16[0], bf(rnd(3, 3, cin, 18, scale=2.0 / fan)), rnd(18, scale=0.5),
                  bf(rnd(3, 3, cin, 9, scale=1.0 / fan)), rnd(9), a16[3], bias]
            if name in ("lay1", "lay5"):
                k4_32 = [t.float() for t in k4]
                compare(f"{name} K4 f32 ", modulated_deform_conv2d(*k4_32),
                        modulated_deform_conv2d_plain(*k4_32), 1e-4)
                del k4_32
            compare(f"{name} K4 bf16", modulated_deform_conv2d(*k4),
                    modulated_deform_conv2d_plain(*k4), 2e-2)
            k4_ms = cuda_time(lambda: modulated_deform_conv2d(*k4), 5)
            k4_route = [bf(t) for t in k4]                  # the model's bf16 biases
            k4_route_ms = cuda_time(lambda: modulated_deform_conv2d_rows(*k4_route), 5)
            log(f"    {name} {cin}->{cout} at {h}x{w}: K10 {ms:.3f} ms, route {route_ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms; K4 (fields computed) {k4_ms:.3f} ms, route "
                f"{k4_route_ms:.3f} ms")
            layers.append(dict(layer=name, ms=ms, route_ms=route_ms))
            k4_layers.append(dict(layer=name, ms=k4_ms, route_ms=k4_route_ms))
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["route_ms"] += route_ms
            tot["k4"] += k4_ms
            tot["k4_route"] += k4_route_ms
            tot["k4_flops"] += 2 * COCO_OUT * hw * 9 * (27 * cin + 4 * cin + cin * cout)
            tot["k4_bytes"] += (x.numel() + 9 * cin * (27 + cout) + COCO_OUT * cout * hw) * 2
            tot["bytes"] += (x.numel() + offset.numel() + mask.numel() + weight.numel()
                             + COCO_OUT * cout * hw) * 2 + cout * 4
            tot["flops"] += 2 * COCO_OUT * hw * 9 * (4 * cin + cin * cout)
            del x, offset, mask, a16, k4, k4_route
            torch.cuda.empty_cache()
    k4_bound = max(tot["k4_bytes"] / HBM_BYTES_PER_S, tot["k4_flops"] / BF16_TC_FLOPS) * 1e3
    log(f"    six layers: K10 {tot['ms']:.3f} ms (route {tot['route_ms']:.3f}), "
        f"K4 {tot['k4']:.3f} ms (route {tot['k4_route']:.3f}, bound {k4_bound:.4f})")
    results["K4"].setdefault("coco_shapes", {})[f"six layers B={COCO_OUT}"] = dict(
        ms=tot["k4"], route_ms=tot["k4_route"], bound_ms=k4_bound, layers=k4_layers)
    results["K10"] = dict(
        name="deform_conv2d", route="cuda", source="devis_torch/csrc/deform_conv.cu",
        replaces="devis_tpu/ops/deform_conv_banded.py:72", max_abs_err=tot["err"],
        ms=tot["ms"], plain_ms=tot["plain_ms"], bytes=tot["bytes"], flops=tot["flops"],
        flop_rate=BF16_TC_FLOPS, library_ms=None, route_ms=tot["route_ms"], layers=layers)
    return tot["k4"]


def coco_mask_head_bwd_phase(torch, dev, gen, results):
    """K6 and K7 at the image mask head's six DCNv2 layers at the batch the
    image train step gives them (2 images x 25 slots = 50 masks a mask
    level), on the route's rows (`deform_conv2d_rows`: pixel + kernel
    position + an offset of N(0, 2) pixels, 9 one-point levels) and its
    query grid. Each is held against its plain version at `COCO_MASK_CMP_B`
    masks where the plain version's f32 copy of U passes 1.5 GB (lay5), and
    timed at full batch: K6 by device time, its op by CUDA events beside it."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.ms_deform_attn import ms_deform_attn
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    B = COCO_SLOTS * COCO_BATCH
    tot = dict(ms=0.0, op_ms=0.0, bound_ms=0.0, device_ms=0.0, layers=[])
    fwd = dict(ms=0.0, op_ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, layers=[])
    log(f"K6 msda_rows / K7 msda_rows_bwd at the image mask head, B={B}, 9 levels, per layer")
    for name, cin, cout, h, w in COCO_DCN_LAYERS:
        shapes = ((h, w),) * 9
        loc = dcn_route_loc(torch, dev, gen, B, h, w)
        att = torch.rand(B, h * w, 1, 9, 1, generator=gen, device=dev) * 2.0
        v16 = bf(torch.randn(B, 9 * h * w, 1, cout, generator=gen, device=dev))
        g16 = bf(torch.randn(B, h * w, cout, generator=gen, device=dev))
        a16 = (v16, shapes, loc, att, g16)
        nb = B if B * 9 * h * w * cout * 4 <= 1.5e9 else COCO_MASK_CMP_B
        cut = tuple(t[:nb] if torch.is_tensor(t) else t for t in a16)
        with torch.no_grad():
            op = lambda: K.msda_rows(v16, shapes, loc, att)  # noqa: E731
            err = compare(f"{name} B={nb} K6 bf16", op()[:nb], ms_deform_attn(*cut[:4]), 2e-2)
            ms = device_ms(op, "msda_rows_kernel", iters=5)
            op_ms = cuda_time(op, 5)
            plain_ms = cuda_time(lambda: ms_deform_attn(*cut[:4]), 2, 1)
        taps, _, rows = corner_stats(loc, shapes)
        nbytes = rows * cout * 2 + (loc.numel() + att.numel()) * 4 + B * h * w * cout * 2
        bound = max(nbytes / HBM_BYTES_PER_S, taps * 8 * cout / F32_FLOPS) * 1e3
        log(f"    {name} D={cout} at {h}x{w}: K6 {ms:.4f} ms by device time, op {op_ms:.4f} "
            f"ms (plain at B={nb} {plain_ms:.3f}), bound {bound:.4f} ms")
        fwd["layers"].append(dict(layer=name, ms=ms, op_ms=op_ms, plain_ms=plain_ms,
                                  bound_ms=bound, compare_batch=nb))
        for k, v in (("ms", ms), ("op_ms", op_ms), ("plain_ms", plain_ms), ("bound_ms", bound)):
            fwd[k] += v
        fwd["err"] = max(fwd["err"], err)

        bwd_compare(torch, f"{name} B={nb} K7", K.msda_rows_bwd, K.msda_rows_bwd_plain, None,
                    cut)
        nbytes, flops, corners = backward_cost(loc, att, v16, shapes, None, cout)
        rec = bwd_times(torch, "K7", lambda: K.msda_rows_bwd(*a16), iters=5)
        rec["plain_ms"] = cuda_time(lambda: K.msda_rows_bwd_plain(*cut), 2, 1)
        rec.update(layer=name, compare_batch=nb,
                   bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3)
        log_bwd(f"{name} D={cout} at {h}x{w} (plain at B={nb})", rec)
        for k in ("ms", "op_ms", "bound_ms", "device_ms"):
            tot[k] += rec[k]
        tot["layers"].append(rec)
        del loc, att, v16, g16, a16, cut
        torch.cuda.empty_cache()
    log(f"    six layers: K6 {fwd['ms']:.4f} ms, op {fwd['op_ms']:.4f} ms, bound "
        f"{fwd['bound_ms']:.4f} ms; K7 {tot['ms']:.3f} ms, op {tot['op_ms']:.3f} ms, bound "
        f"{tot['bound_ms']:.4f} ms")
    results["K6"]["max_abs_err"] = max(results["K6"]["max_abs_err"], fwd.pop("err"))
    results["K6"].setdefault("coco_shapes", {})[f"mask head B={B}"] = fwd
    results["K7"].setdefault("coco_shapes", {})[f"mask head B={B}"] = tot


def dcn_route_loc(torch, dev, gen, B, h, w, px=2.0):
    """(B, h*w, 1, 9, 1, 2) f32 locations as `deform_conv2d_rows` builds them:
    each pixel shifted by its kernel position (ky - 1, kx - 1) and an offset
    of N(0, px) pixels, normalized as the attention's."""
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w).reshape(-1)
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w).reshape(-1)
    k = torch.arange(9, device=dev)
    ky, kx = (k // 3 - 1).float(), (k % 3 - 1).float()
    off = torch.randn(B, h * w, 9, 2, generator=gen, device=dev) * px
    lx = (xs[None, :, None] + kx + off[..., 1] + 0.5) / w
    ly = (ys[None, :, None] + ky + off[..., 0] + 0.5) / h
    return torch.stack([lx, ly], -1).reshape(B, h * w, 1, 9, 1, 2).contiguous()


def build_coco(torch, dev, enc_layers=6, dec_layers=6, mask_aux=(2,), box_noise=True):
    """(cfg, model): Deformable DETR R50 with the mask head at the settings
    of configs/deformable_mask_head/deformable_mask_head_R_50.yaml for
    `coco` (entered by hand; the CLI phase reads the file itself), bf16
    compute, seeded random weights, in eval mode."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model

    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "coco"
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.SHIFT_CLASS_NEURON = True
    cfg.MODEL.LOSS.SEGM_MASK_COEF = 8.0
    cfg.MODEL.LOSS.SEGM_DICE_COEF = 8.0
    cfg.MODEL.LOSS.MASK_AUX_LOSS = list(mask_aux)
    cfg.MODEL.NUM_QUERIES = COCO_NQ
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = enc_layers
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = dec_layers
    cfg.SOLVER.FROZEN_PARAMS = ["class_embed"]
    cfg.SOLVER.BASE_LR = 0.00002
    cfg.SOLVER.LR_BACKBONE = 0.00001
    cfg.SOLVER.BACKBONE_NAMES = ["backbone.0", "input_proj"]
    cfg.SOLVER.LR_MASK_HEAD_MULT = 10
    cfg.SOLVER.EPOCHS = 25
    cfg.SOLVER.STEPS = [15]
    cfg.TEST.NUM_OUT = COCO_OUT
    cfg.TEST.EVAL_BATCH_SIZE = 1
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.MAX_INSTANCES = COCO_SLOTS
    cfg.freeze()
    t0 = time.perf_counter()
    model = build_model(COCO_CLASSES, cfg, seed=SEED)
    move_taps_off_the_grid(torch, model, dev, box_noise)
    log(f"model: Deformable DETR R50 + mask head (COCO), {enc_layers}+{dec_layers} layers, bf16, "
        f"{sum(p.numel() for p in model.parameters())} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model


def coco_ops():
    """The wrappers the image model's paths may launch: K8, K6, K9, K7, K4, K10."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import deform_conv2d, modulated_deform_conv2d
    return [K.msda_proj, K.msda_rows, K.msda_taps_bwd, K.msda_rows_bwd,
            modulated_deform_conv2d, deform_conv2d]


def zero_coco_counts(ops):
    """Zeroes the wrappers' counts and the q-major op's plain calls (it
    launches K6 and K9, which count for themselves)."""
    from devis_torch.ops.ms_deform_attn_cuda import msda_taps
    for fn in ops:
        fn.launches = fn.plain_calls = 0
    msda_taps.plain_calls = 0


def check_coco_counts(ops, wants):
    from devis_torch.ops.ms_deform_attn_cuda import msda_taps
    check_counts(ops, wants)
    if msda_taps.plain_calls:
        raise AssertionError(f"msda_taps: {msda_taps.plain_calls} plain calls")


class _Collect:
    """Stands for the COCO evaluator: keeps every image's result and the
    time it arrived."""

    def __init__(self):
        self.results, self.times = {}, []

    def update(self, res):
        self.results.update(res)
        self.times.append(time.perf_counter())

    def summarize(self):
        return {"images": len(self.results)}


def eval_images(torch, card, cfg, model, what="COCO inference path"):
    """`evaluate_coco` over 3 seeded 800x1216 images after a warm-up image,
    the counts zeroed just before and read just after: an image launches K8
    once an encoder layer and at decoder layer 0, K6 at the other decoder
    layers, K4 once a mask-head layer, and no plain path; the results
    checked. Returns (dataset, launches, image ms)."""
    import numpy as np

    from devis_torch.inference import evaluate_coco
    from devis_torch.models.segmentation import ModulatedDeformableConv
    from devis_torch.util.synthetic import SyntheticImageDataset

    log(f"{what}: evaluate_coco, 1 warm-up image, then 3 images")
    evaluate_coco(model, SyntheticImageDataset(SEED + 4, [COCO_HW]), cfg, _Collect(),
                  verbose=False)                          # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    dataset = SyntheticImageDataset(SEED + 5, [COCO_HW] * 3)
    ops = coco_ops()
    zero_coco_counts(ops)
    collect = _Collect()
    t0 = time.perf_counter()
    summary = evaluate_coco(model, dataset, cfg, collect, verbose=False)
    lat = (np.diff([t0] + collect.times) * 1e3).tolist()
    launches = {fn.__name__: fn.launches for fn in ops}
    log(f"  launches over 3 images: {launches}; plain calls: "
        f"{ {fn.__name__: fn.plain_calls for fn in ops} }")
    n_enc, n_dec = cfg.MODEL.TRANSFORMER.ENCODER_LAYERS, cfg.MODEL.TRANSFORMER.DECODER_LAYERS
    n_dcn = sum(isinstance(m, ModulatedDeformableConv) for m in model.modules())
    check_coco_counts(ops, (3 * (n_enc + 1), 3 * (n_dec - 1), 0, 0, 3 * n_dcn, 0))
    if summary != {"images": 3}:
        raise AssertionError(f"evaluate_coco returned {summary}")
    for image_id, r in sorted(collect.results.items()):
        oh, ow = COCO_HW
        if (r["scores"].shape != (COCO_OUT,) or r["boxes"].shape != (COCO_OUT, 4)
                or len(r["masks"]) != COCO_OUT
                or any(m.shape != COCO_HW or m.dtype != bool for m in r["masks"])):
            raise AssertionError(f"image {image_id}: malformed result")
        b = r["boxes"]
        if not (np.isfinite(r["scores"]).all() and np.isfinite(b).all()
                and ((r["scores"] >= 0) & (r["scores"] <= 1)).all()
                and (np.diff(r["scores"]) <= 0).all()
                and ((r["labels"] >= 1) & (r["labels"] <= COCO_CLASSES)).all()  # 91 logits, + 1
                and (b >= 0).all() and (b[:, 0::2] <= ow).all() and (b[:, 1::2] <= oh).all()
                and (b[:, 2:] >= b[:, :2]).all()):
            raise AssertionError(f"image {image_id}: non-finite or out-of-range outputs")
    image_ms = float(np.mean(lat))
    log(f"  image latency {[round(v, 3) for v in lat]} ms (the first waits for its forward, "
        f"each later one overlaps the next image's), mean {image_ms:.3f} ms = "
        f"{1e3 / image_ms:.3f} images/s; mask pixels set: "
        f"{np.mean([m.mean() for r in collect.results.values() for m in r['masks']]):.3f} ({card})")
    return dataset, launches, image_ms


def coco_vs_plain(torch, dev, model, sample):
    """One image (`sample` on its canvas) through the kernels and through
    their plain versions on the card, held to the image path's gates.
    Returns the errors."""
    import numpy as np

    from devis_torch.inference import pack_mask_bits
    from devis_torch.models import attention as attn_mod
    from devis_torch.models import segmentation as seg_mod
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import modulated_deform_conv2d_plain
    from devis_torch.ops.ms_deform_attn import ms_deform_attn

    x = torch.zeros((1,) + COCO_CANVAS + (3,), device=dev)
    x[0, :COCO_HW[0], :COCO_HW[1]] = torch.from_numpy(sample["image"]).to(dev)
    pad = torch.ones((1,) + COCO_CANVAS, dtype=torch.bool, device=dev)
    pad[0, :COCO_HW[0], :COCO_HW[1]] = False
    with torch.inference_mode():
        out_k = model(x, pad)
        saved = (attn_mod.msda_proj, attn_mod.msda_taps, seg_mod.modulated_deform_conv2d)
        attn_mod.msda_proj = K.msda_proj_plain
        attn_mod.msda_taps = ms_deform_attn
        seg_mod.modulated_deform_conv2d = modulated_deform_conv2d_plain
        try:
            out_p = model(x, pad)
        finally:
            attn_mod.msda_proj, attn_mod.msda_taps, seg_mod.modulated_deform_conv2d = saved
        # bf16 end to end through 12 attention layers and 6 DCNv2 layers: the
        # two paths round at different places. Each limit is relative to the
        # largest magnitude of what it compares (a seeded model's class
        # probabilities are all below 0.1, so an absolute limit would say
        # nothing): probabilities and top-k scores to 5e-2 of the largest
        # probability, normalized boxes to 2e-2 (five bf16 steps just below 1),
        # the mask logits of the (query, class) pairs in both top-k lists to
        # 5e-2 of their largest magnitude; a packed mask bit may flip where
        # the upsampled logit lies within that error of 0: at most 2 % of the
        # bits; at most 5 of the 50 pairs may fall on the other side of the cut
        errs = {}
        prob_k, prob_p = (torch.sigmoid(o["pred_logits"].float()) for o in (out_k, out_p))
        top = prob_p.max().item()
        errs["pred_logits / max"] = ((prob_k - prob_p).abs().max() / top).item()
        tk, tp = out_k["top_k"], out_p["top_k"]
        errs["scores / max"] = ((tk["scores"] - tp["scores"]).abs().max() / top).item()
        box_err = (out_k["pred_boxes"].float() - out_p["pred_boxes"].float()).abs().max().item()
        # pair the two top-k lists by (query, class): near-equal scores may
        # come out in another order or fall on the other side of the cut
        n_cls = out_k["pred_logits"].shape[-1]
        key_k = (tk["query_top_k_indexes"][0] * n_cls + tk["labels"][0]).tolist()
        key_p = (tp["query_top_k_indexes"][0] * n_cls + tp["labels"][0]).tolist()
        both = [k for k in key_k if k in key_p]
        ik = torch.tensor([key_k.index(k) for k in both], device=dev)
        ip = torch.tensor([key_p.index(k) for k in both], device=dev)
        mk, mp = tk["masks"][0][ik].float(), tp["masks"][0][ip].float()
        errs["masks / max|masks|"] = ((mk - mp).abs().max() / mp.abs().max()).item()
        bits_k = pack_mask_bits(mk[None], COCO_CANVAS)
        bits_p = pack_mask_bits(mp[None], COCO_CANVAS)
        flipped = (bits_k ^ bits_p).cpu().numpy()
        bit_share = float(np.unpackbits(flipped).mean())
    log(f"  kernel path vs plain path on the card, max abs diff over the largest plain value "
        f"({top:.4f} for probabilities): {errs} (limit 5e-2); pred_boxes {box_err:.3e} (limit "
        f"2e-2); {len(both)} of {COCO_OUT} top-k (query, class) pairs are in both lists (limit "
        f"{COCO_OUT - 5}); packed mask bits that differ: {bit_share:.5f} (limit 2e-2)")
    if (not all(v <= 5e-2 for v in errs.values()) or box_err > 2e-2 or bit_share > 2e-2
            or len(both) < COCO_OUT - 5):
        raise AssertionError("kernel path disagrees with the plain path")
    return dict(errs, pred_boxes=box_err, mask_bits=bit_share, pairs=len(both))


def coco_infer_path(torch, dev, card, cfg, model, results):
    from devis_torch.inference import evaluate_coco
    from devis_torch.models.segmentation import ModulatedDeformableConv
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import deform_conv2d
    from devis_torch.util.synthetic import SyntheticImageDataset

    dataset, launches, image_ms = eval_images(torch, card, cfg, model)
    n_dcn = sum(isinstance(m, ModulatedDeformableConv) for m in model.modules())
    # One image with the plain versions on the card, against the kernels; the
    # kernel forward's inputs of the mask-head layers and encoder layer 0 kept
    dcn_inputs = {}
    hooks = [mod.register_forward_pre_hook(
        lambda m, args, name=name: dcn_inputs.setdefault(name, args[0]))
        for name, mod in model.mask_head.named_modules()
        if isinstance(mod, ModulatedDeformableConv)]
    enc0 = {}
    hooks.append(model.def_detr.transformer.encoder.layers[0].self_attn
                 .register_forward_pre_hook(lambda m, args: enc0.setdefault("a", args)))
    try:
        coco_vs_plain(torch, dev, model, dataset[0])
    finally:
        for h in hooks:
            h.remove()

    # K2 with an empty temporal part: the window the JAX `_fwd_call_proj`
    # computes for the encoder's first layer, on that layer's real inputs
    with torch.inference_mode():
        attn = model.def_detr.transformer.encoder.layers[0].self_attn
        query, ref, _, shapes = enc0["a"][:4]
        ref = ref.float().contiguous()
        c_off = attn.sampling_offsets(query).contiguous()
        t_off = c_off.new_zeros(c_off.shape[:2] + (0,))
        got = K.msda_tap_window(shapes, ref, c_off, t_off, M)
        want = K.msda_tap_window_plain(shapes, ref, c_off, t_off, M)
        ms = device_ms(lambda: K.msda_tap_window(shapes, ref, c_off, t_off, M),
                       "msda_tap_window_kernel")
        op_ms = cuda_time(lambda: K.msda_tap_window(shapes, ref, c_off, t_off, M), 20)
    log(f"K2 msda_tap_window at F = 1 on COCO encoder layer 0's inputs (Q={ref.shape[1]}, "
        f"{tuple(got.shape)} windows): equal {bool(torch.equal(got, want))}, live share "
        f"{(want[..., 1] >= 0).float().mean().item():.3f}, {ms:.4f} ms of device time on grid "
        f"{k2_grid(torch, c_off, ref.shape[1], ref.shape[0], 0)} (blocks, warps a block), the "
        f"op {op_ms:.4f} ms a call by CUDA events")
    if not torch.equal(got, want):
        raise AssertionError("K2 windows at F = 1 differ from the plain version")
    results["K2"]["coco_f1"] = dict(ms=ms, op_ms=op_ms,
                                    grid=k2_grid(torch, c_off, ref.shape[1], ref.shape[0], 0))

    # K10's path: the public op on given fields recomputes the image's six
    # mask-head layers (fields by cuDNN convolutions) and is held against K4
    log("K10 path: deform_conv2d from given fields on the image's six mask-head layers, vs K4")
    deform_conv2d.launches = deform_conv2d.plain_calls = 0
    with torch.inference_mode():
        F = torch.nn.functional
        for name, mod in model.mask_head.named_modules():
            if not isinstance(mod, ModulatedDeformableConv):
                continue
            xin = dcn_inputs[name]
            dt = xin.dtype
            offset = F.conv2d(xin, mod.offset_conv.weight.to(dt), mod.offset_conv.bias.to(dt),
                              padding=mod.padding)
            mask = 2.0 * torch.sigmoid(F.conv2d(xin, mod.modulator_conv.weight.to(dt),
                                                mod.modulator_conv.bias.to(dt),
                                                padding=mod.padding))
            got = deform_conv2d(xin, offset, mask,
                                mod.regular_conv.weight.permute(2, 3, 1, 0).to(dt).contiguous(),
                                mod.regular_conv.bias, mod.padding)
            # bf16: the fields are rounded to bf16 here and kept in f32 by K4
            compare(f"{name} {tuple(xin.shape)}", got, mod(xin), 3e-2)
    k10_launches = deform_conv2d.launches
    if k10_launches != n_dcn or deform_conv2d.plain_calls:
        raise AssertionError(f"K10 launched {k10_launches} times")
    profile_run(torch, "COCO image", lambda: evaluate_coco(
        model, SyntheticImageDataset(SEED + 4, [COCO_HW]), cfg, _Collect(), verbose=False))
    return launches, k10_launches, image_ms


def coco_train_batch(batch, n_slots, n_instances):
    from devis_torch.util.synthetic import synthetic_image_batch
    return synthetic_image_batch(SEED + 6, COCO_CANVAS, COCO_HW, n_instances, n_slots,
                                 COCO_CLASSES - 1, batch=batch)


def coco_train_path(torch, dev, card, cfg, model):
    """1 warm-up and 3 timed steps of the image model through
    `make_train_step` at full width and depth."""
    import numpy as np

    from devis_torch.engine import create_train_state, make_train_step, param_labels
    from devis_torch.models.segmentation import ModulatedDeformableConv

    log(f"COCO train path: make_train_step, {COCO_BATCH} images a step, {COCO_INSTANCES} "
        f"instances in {COCO_SLOTS} slots each, dropout {cfg.MODEL.DROPOUT}")
    state = create_train_state(cfg, model, steps_per_epoch=100)
    step = make_train_step(model, cfg)
    batch = coco_train_batch(COCO_BATCH, COCO_SLOTS, COCO_INSTANCES)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    labels = param_labels(model, cfg)
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch, gen)               # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ops = coco_ops()
    zero_coco_counts(ops)
    n_steps = 3
    state, step_ms = timed_steps(torch, step, state, batch, gen, n_steps)
    launches = {fn.__name__: fn.launches for fn in ops}
    log(f"  launches over {n_steps} steps: {launches}; plain calls: "
        f"{ {fn.__name__: fn.plain_calls for fn in ops} }")
    n_enc, n_dec = cfg.MODEL.TRANSFORMER.ENCODER_LAYERS, cfg.MODEL.TRANSFORMER.DECODER_LAYERS
    n_dcn = sum(isinstance(m, ModulatedDeformableConv) for m in model.modules())
    n_mask = 1 + len(cfg.MODEL.LOSS.MASK_AUX_LOSS)
    # K8: encoder layers and decoder layer 0; K6: the other decoder layers and
    # the DCNv2 layers of each mask level; K9 backs the decoder's K6, K7 backs
    # K8 and the DCNv2 layers; K4 and K10 have no gradient and never run
    check_coco_counts(ops, [n_steps * c for c in (
        n_enc + 1, n_dec - 1 + n_dcn * n_mask, n_dec - 1, n_enc + 1 + n_dcn * n_mask, 0, 0)])
    if state.step != 1 + n_steps:
        raise AssertionError(f"{state.step} updates after {1 + n_steps} steps")
    check_parameters_moved(torch, model, labels, before)
    if labels["def_detr.class_embed.0.weight"] != "frozen":
        raise AssertionError("SOLVER.FROZEN_PARAMS did not freeze class_embed")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean_ms = float(np.mean(step_ms))
    log(f"  COCO train step {[round(v, 3) for v in step_ms]} ms, mean {mean_ms:.3f} ms; "
        f"peak memory {peak:.3f} GiB ({card})")
    profile_run(torch, "COCO train step", lambda: step(state, batch, gen))
    return launches, mean_ms, peak


def coco_train_compare(torch, dev):
    """The image model: 1 encoder and 2 decoder layers at full width, the
    mask loss on both decoder levels, 1 image with 10 target slots (the plain
    versions keep every gathered tap for their backward)."""
    log("COCO kernel path against plain path, one train step, 1+2 layers at full width")
    cfg, model = build_coco(torch, dev, 1, 2, mask_aux=(0,), box_noise=False)
    compare_train_paths(torch, cfg, model, coco_train_batch(1, 10, 4), coco_ops(),
                        {"msda_proj": "msda_proj_plain", "msda_taps": "ms_deform_attn",
                         "msda_rows": "ms_deform_attn"})


# ---------------------------------------------------------------------------
# The CLI from files
# ---------------------------------------------------------------------------

CLI_COCO_CONFIG = "configs/deformable_mask_head/deformable_mask_head_R_50.yaml"
CLI_VIS_CONFIG = "configs/devis/YT-19/devis_R_50_YT-19.yaml"
VIS_CLI_STEPS = 4
CLI_COCO_TRAIN = 9                    # train images: 8 with objects, 4 steps of 2 an epoch
CLI_SITES = (("devis_torch.models.attention", "msda_temporal_proj"),
             ("devis_torch.models.attention", "msda_temporal"),
             ("devis_torch.models.attention", "msda_proj"),
             ("devis_torch.models.attention", "msda_taps"),
             ("devis_torch.ops.deform_conv", "msda_rows"),
             ("devis_torch.models.segmentation", "modulated_deform_conv2d"))


class _Timed:
    """Wraps a callable: the host seconds of each call, synchronised with
    the card, and an optional hook run before each call."""

    def __init__(self, torch, fn, before=None):
        self.torch, self.fn, self.before, self.secs = torch, fn, before, []

    def __call__(self, *args, **kwargs):
        if self.before is not None:
            self.before(*args)
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        self.torch.cuda.synchronize()
        self.secs.append(time.perf_counter() - t0)
        return out


class _FirstCalls:
    """Keeps the arguments of the first call of each op where the models
    call it (`CLI_SITES`: the name bound in the calling module, so the
    wrappers and their launch counts stay as they are) and passes every
    call through. In a CLI run the first calls are those of the first train
    step (or evaluated image or clip): layer 0 of the encoder's and the
    decoder's attention, decoder layer 1's q-major op, mask-head layer 0."""

    def __init__(self, torch):
        self.torch, self.args, self.saved = torch, {}, []

    def __enter__(self):
        import importlib
        for mod_name, name in CLI_SITES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._grab(name, fn))
        return self

    def _grab(self, name, fn):
        def grab(*args):
            if name not in self.args:
                self.args[name] = tuple(a.detach() if self.torch.is_tensor(a) else a
                                        for a in args)
            return fn(*args)
        return grab

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _batch_cut(t, nbytes_per_item, limit=1.5e9):
    """How many leading items of `t` the plain version takes: all where
    their f32 copy stays under `limit` bytes."""
    return max(1, min(t.shape[0], int(limit // nbytes_per_item)))


def cli_kernel_checks(torch, dev, calls, train, where):
    """Each kernel of a CLI run on the inputs the run gave it first (see
    `_FirstCalls`), against its plain version: K2's windows equal and K1's
    `count` mode reading no corner from global memory outside them; the
    forwards (K1, K3, K6, K8, K4) in bf16 to 2e-2 of max|plain|; after a
    train run the backwards (K5, K7, K9) on a seeded output gradient as
    `bwd_compare` holds them. The mask head's K6/K7 and K4 are held at as
    many masks as keep the plain version's f32 copy under 1.5 GB. Returns
    {kernel: max_abs_err}."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.deform_conv import (modulated_deform_conv2d,
                                             modulated_deform_conv2d_plain)
    from devis_torch.ops.ms_deform_attn import ms_deform_attn

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    errs = {}

    def keep(key, err):
        errs[key] = max(errs.get(key, 0.0), err)

    def grad_for(out):
        """A seeded output gradient shaped and typed as `out`."""
        return torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)

    log(f"{where}: the kernels on the run's first inputs against their plain versions")
    with torch.no_grad():
        if "msda_temporal_proj" in calls:             # encoder layer 0: K2, K1; K5
            args = calls["msda_temporal_proj"]
            value, shapes, ref, c_off, t_off, c_logit, t_logit, rule = args
            Tn, Q, M, D = ref.shape[0], ref.shape[1], value.shape[2], value.shape[3]
            L = len(shapes)
            P = c_off.shape[-1] // (M * L * 2)
            log(f"  encoder layer 0: T={Tn} Q={Q} levels {list(shapes)}")
            win = K.msda_tap_window(shapes, ref, c_off, t_off, M)
            if not torch.equal(win, K.msda_tap_window_plain(shapes, ref, c_off, t_off, M)):
                raise AssertionError(f"{where}: K2 windows differ from the plain version")
            keep("K2", 0.0)
            plan = K.window_plan(shapes, value.dtype, D, P)
            _, reads = K.launch_k1(*args, win, plan, "count")
            log(f"  K2 windows equal; K1 corners read from global memory {reads.tolist()} "
                f"(in fitted windows, over capacity)")
            if reads[0].item() != 0:
                raise AssertionError(f"{where}: a K2 window missed a tap of K1")
            keep("K1", compare("  K1 bf16", K.msda_temporal_proj(*args),
                               K.msda_temporal_proj_plain(*args), 2e-2))
            if train:
                loc = K.temporal_proj_locations(shapes, ref, c_off, t_off, M).contiguous()
                att = K.temporal_proj_weights(c_logit, t_logit, M, L).contiguous()
                g = grad_for(value.new_empty(Tn, Q, M * D))
                keep("K5", bwd_compare(torch, "  K5 (encoder)", K.msda_temporal_bwd,
                                       K.msda_temporal_bwd_plain, None,
                                       (value, shapes, loc, att, g, rule)))
                del loc, att, g
            del args, value, ref, c_off, t_off, c_logit, t_logit, win
            torch.cuda.empty_cache()
        if "msda_temporal" in calls:                  # decoder layer 0: K3; K5
            value, shapes, loc, att, rule = args = calls["msda_temporal"]
            log(f"  decoder layer 0: T={loc.shape[0]} Q={loc.shape[1]}")
            out = K.msda_temporal(*args)
            keep("K3", compare("  K3 bf16", out, K.ms_deform_attn_temporal_plain(*args), 2e-2))
            if train:
                keep("K5", bwd_compare(torch, "  K5 (decoder)", K.msda_temporal_bwd,
                                       K.msda_temporal_bwd_plain, None,
                                       (value, shapes, loc, att, grad_for(out), rule)))
            del args, value, loc, att, out
        if "msda_proj" in calls:                      # encoder layer 0: K8; K7
            value, shapes, ref, off, logit = args = calls["msda_proj"]
            M, L = value.shape[2], len(shapes)
            log(f"  encoder layer 0: B={ref.shape[0]} Q={ref.shape[1]} levels {list(shapes)}")
            out = K.msda_proj(*args)
            keep("K8", compare("  K8 bf16", out, K.msda_proj_plain(*args), 2e-2))
            if train:
                loc = K.proj_locations(shapes, ref, off, M).contiguous()
                att = K.proj_weights(logit, M, L).contiguous()
                keep("K7", bwd_compare(torch, "  K7 (K8's backward)", K.msda_rows_bwd,
                                       K.msda_rows_bwd_plain, None,
                                       (value, shapes, loc, att, grad_for(out))))
                del loc, att
            del args, value, ref, off, logit, out
            torch.cuda.empty_cache()
        if "msda_taps" in calls:                      # decoder layer 1: K6; K9
            value, shapes, loc, att = args = calls["msda_taps"]
            log(f"  decoder layer 1: B={loc.shape[0]} Q={loc.shape[1]}")
            out = K.msda_taps(*args)
            keep("K6", compare("  K6 bf16", out, ms_deform_attn(*args), 2e-2))
            if train:
                g = grad_for(out)
                idx, wt = K.taps(shapes, loc, att)
                got = K.msda_taps_bwd(value, shapes, idx, wt, g)
                want = K.msda_taps_bwd_plain(value.float(), shapes, idx, wt, g.float())
                keep("K9", compare("  K9 bf16 grad_value", got[0], want[0], 1e-2))
                compare("  K9 bf16 grad_wt", got[1], want[1], 1e-4)
                del g, idx, wt, got, want
            del args, value, loc, att, out
        if "msda_rows" in calls:                      # mask-head layer 0 (route): K6; K7
            u, shapes, loc, att = calls["msda_rows"]
            nb = _batch_cut(u, u[0].numel() * 4)
            cut = (u[:nb], shapes, loc[:nb], att[:nb])
            log(f"  mask-head layer 0 (the route under a gradient): B={u.shape[0]} "
                f"level {shapes[0]} D={u.shape[-1]}, held at {nb}")
            out = K.msda_rows(u, shapes, loc, att)
            keep("K6", compare("  K6 bf16", out[:nb], ms_deform_attn(*cut), 2e-2))
            if train:
                keep("K7", bwd_compare(torch, "  K7 (route)", K.msda_rows_bwd,
                                       K.msda_rows_bwd_plain, None,
                                       cut + (grad_for(out[:nb]),)))
            del u, loc, att, cut, out
            torch.cuda.empty_cache()
        if "modulated_deform_conv2d" in calls:        # mask-head layer 0: K4
            x, *rest = calls["modulated_deform_conv2d"]
            nb = _batch_cut(x, x[0].numel() * 4 * 4)
            log(f"  mask-head layer 0: K4 at B={x.shape[0]} {tuple(x.shape[1:])}, held at {nb}")
            keep("K4", compare("  K4 bf16", modulated_deform_conv2d(x, *rest)[:nb],
                               modulated_deform_conv2d_plain(x[:nb], *rest), 2e-2))
            del x, rest
    calls.clear()
    torch.cuda.empty_cache()
    return errs


def run_cli(torch, argv, ops, wants, first_step=None, **kwargs):
    """`devis_torch.main.main(argv)` with the launch counts of `ops` zeroed
    just before and read just after (each must equal its entry of `wants`,
    no plain path); the CLI's evaluation calls and train steps are timed, and
    so is each wait of the epoch loop for its next batch; the first call of
    each op keeps its arguments (`_FirstCalls`). Returns main's `result`,
    `launches` by op, `eval_s`, `step_s`, each step's `canvas` (h, w),
    `waits` for a batch and the first `calls`."""
    import types

    import devis_torch.datasets as datasets
    import devis_torch.engine as engine
    import devis_torch.inference as inference
    from devis_torch import main as cli

    evals = {}
    steps, canvases, waits = [], [], []
    saved = (inference.evaluate_coco, inference.inference_vis, engine.make_train_step,
             datasets.TrainLoader.__iter__)
    inference.evaluate_coco = evals["coco"] = _Timed(torch, saved[0])
    inference.inference_vis = evals["vis"] = _Timed(torch, saved[1])

    def before_step(state, batch, gen=None):
        canvases.append(tuple(batch["images"].shape[-3:-1]))
        if first_step is not None:
            first_step(state, batch, gen)

    def make_train_step(model, cfg):
        fn = _Timed(torch, saved[2](model, cfg), before=before_step)
        steps.append(fn)
        return fn

    def timed_iter(loader):
        it = saved[3](loader)
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    return
                waits.append(time.perf_counter() - t0)
                yield batch
        finally:
            it.close()
    engine.make_train_step = make_train_step
    datasets.TrainLoader.__iter__ = timed_iter
    zero_coco_counts(ops)
    try:
        with _FirstCalls(torch) as first:
            result = cli.main(argv, **kwargs)
    finally:
        (inference.evaluate_coco, inference.inference_vis, engine.make_train_step,
         datasets.TrainLoader.__iter__) = saved
    launches = {fn.__name__: fn.launches for fn in ops}
    log(f"  launches: {launches}")
    check_coco_counts(ops, wants)
    step_s = [t for fn in steps for t in fn.secs]
    if step_s:
        log(f"  steps {[round(v, 4) for v in step_s]} s on canvases {canvases}; waits for a "
            f"batch {[round(v, 4) for v in waits]} s")
    return types.SimpleNamespace(
        result=result, launches=launches, eval_s=sum(evals["coco"].secs) + sum(evals["vis"].secs),
        step_s=step_s, canvas=canvases, waits=waits, calls=first.args)


def seen_canvas_steps(*runs):
    """The step times of `runs`, in order, whose canvas an earlier step had.
    The caching allocator and the launch plans' caches live as long as the
    process, so only such a step meets no new shape."""
    step_s = [t for run in runs for t in run.step_s]
    canvas = [c for run in runs for c in run.canvas]
    return [t for i, (t, c) in enumerate(zip(step_s, canvas)) if c in canvas[:i]]


def check_finite(what, tree):
    import numpy as np
    flat = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (float, int)):
            flat.append(float(x))
    walk(tree)
    if not flat or not np.isfinite(flat).all():
        raise AssertionError(f"{what}: non-finite or empty stats {tree}")


def data_pipeline_seconds(torch, argv, n_batches=3):
    """Host seconds a training batch takes to decode, transform and collate
    (`TrainLoader.make_batch`, no prefetch), the CLI's dataset and loader."""
    from devis_torch.datasets import build_dataset
    from devis_torch.main import build_train_loader, parse_args, setup_cfg
    cfg = setup_cfg(parse_args(argv))
    ds, _ = build_dataset("TRAIN", cfg)
    loader = build_train_loader(cfg, ds)
    secs = []
    for idxs in loader.batch_indices()[:n_batches]:
        t0 = time.perf_counter()
        batch = loader.make_batch(idxs)
        secs.append(time.perf_counter() - t0)
    return secs, tuple(batch["images"].shape)


def cli_phase(torch, dev, card):
    """`python -m devis_torch.main` from seeded files on disk at full width
    and depth (bf16, seeded random weights): the COCO mask-head model
    (--eval-only; train with the periodic evaluation; --resume) and DeVIS
    R50 YT-19 (train with the periodic evaluation; --eval-only), each run
    with the launch counts zeroed before and read after."""
    import tempfile

    from devis_torch.util import checkpoint as ckpt
    from devis_torch.util.fixtures import tree_summary, write_coco_tree, write_vis_tree

    t_phase = time.perf_counter()
    coco_ops_, vis_ops = coco_ops(), kernel_ops()
    with tempfile.TemporaryDirectory(prefix="devis_cli_") as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        write_coco_tree(data, seed=SEED, n_train=CLI_COCO_TRAIN, n_val=4,
                        sizes=((480, 640), (640, 480)))
        write_vis_tree(data, seed=SEED, n_train=2, n_val=2, n_frames=12, size=VIDEO_HW)
        log(f"CLI phase: fixture trees written in {time.perf_counter() - t0:.1f} s: "
            f"{tree_summary(data)}")
        base = ["TPU.COMPUTE_DTYPE", "bfloat16", "MODEL.WEIGHTS", "", "DATASETS.DATA_PATH", data]
        n_enc = n_dec = 6
        n_dcn, n_mask = 6, 2                  # mask-head DCNv2 layers; mask loss on 2 levels

        # --- COCO -----------------------------------------------------------
        coco_out = os.path.join(tmp, "coco")
        coco_file = ["--config-file", os.path.join(HERE, CLI_COCO_CONFIG)]
        coco = base + ["OUTPUT_DIR", coco_out, "SOLVER.BATCH_SIZE", "2",
                       "TEST.EVAL_BATCH_SIZE", "1"]
        img = (n_enc + 1, n_dec - 1, 0, 0, n_dcn, 0)                  # K8 K6 K9 K7 K4 K10
        step = (n_enc + 1, n_dec - 1 + n_dcn * n_mask, n_dec - 1, n_enc + 1 + n_dcn * n_mask, 0, 0)
        n_steps = (CLI_COCO_TRAIN - 1) // 2   # the last train image has no object
        log("CLI COCO --eval-only: 4 images of 480x640 and 640x480")
        run = run_cli(torch, coco_file + ["--eval-only"] + coco, coco_ops_, [4 * c for c in img])
        checks = {"coco_eval": cli_kernel_checks(torch, dev, run.calls, False, "COCO --eval-only")}
        res = run.result
        check_finite("COCO eval", res["eval"])
        if set(res["eval"]) != {"bbox", "segm"}:
            raise AssertionError(f"COCO eval gave {sorted(res['eval'])}")
        coco_images_per_s = 4 / run.eval_s
        log(f"  bbox {res['eval']['bbox']}; {coco_images_per_s:.3f} images/s ({card})")
        runs = [run]

        log(f"CLI COCO train: 1 epoch ({n_steps} steps of 2), eval once, checkpoints")
        coco_train = run_cli(
            torch, coco_file + coco + ["SOLVER.EPOCHS", "1", "TEST.START_EVAL_EPOCH", "1"],
            coco_ops_, [n_steps * a + 4 * b for a, b in zip(step, img)])
        checks["coco_train"] = cli_kernel_checks(torch, dev, coco_train.calls, True, "COCO train")
        ep = coco_train.result["epochs"][0]
        check_finite("COCO train", ep["train"])
        check_finite("COCO periodic eval", ep["eval"])
        for d in ("checkpoint", "checkpoint_epoch_0", "checkpoint_best_coco_ap"):
            if not os.path.exists(os.path.join(coco_out, d, ckpt.STATE_FILE)):
                raise AssertionError(f"no {d}/ written")
        with open(os.path.join(coco_out, "checkpoint", "meta.json")) as f:
            meta = json.load(f)
        if meta["epoch"] != 0 or "coco_ap" not in meta["best_stats"]:
            raise AssertionError(f"meta.json: {meta}")

        log("CLI COCO --resume: epoch 1 from checkpoint/, no eval")
        saved = ckpt.load_checkpoint(os.path.join(coco_out, "checkpoint"))
        seen = []

        def first_step(state, batch, gen=None):
            if seen:
                return
            seen.append(state.step)
            for k, v in state.model.state_dict().items():
                if not torch.equal(v.cpu(), saved["model"][k]):
                    raise AssertionError(f"resumed model differs from the checkpoint at {k}")
        coco_resume = run_cli(
            torch, coco_file + ["--resume", os.path.join(coco_out, "checkpoint")] + coco
            + ["SOLVER.EPOCHS", "2", "TEST.START_EVAL_EPOCH", "3"], coco_ops_,
            [n_steps * a for a in step], first_step=first_step)
        res = coco_resume.result
        if (res["start_epoch"] != 1 or seen != [saved["step"]]
                or res["epochs"][0]["step"] != 2 * n_steps):
            raise AssertionError(f"resume: start {res['start_epoch']}, steps {seen}, "
                                 f"{res['epochs'][0]['step']}")
        check_finite("COCO resumed train", res["epochs"][0]["train"])
        runs += [coco_train, coco_resume]

        # --- VIS --------------------------------------------------------------
        vis_out = os.path.join(tmp, "vis")
        vis_file = ["--config-file", os.path.join(HERE, CLI_VIS_CONFIG)]
        vis = base + ["OUTPUT_DIR", vis_out]
        clips = 2 * 3                         # 2 videos of 12 frames: 3 clips of 6 at stride 4
        vstep = (6, 6, 6, 12, 12, 12, 0)                  # K1 K2 K3 K5 K6 K7 K4
        vclip = (6, 6, 6, 0, 0, 0, 6)
        log(f"CLI VIS train: {VIS_CLI_STEPS} steps of epoch 0, then the periodic evaluation")
        vis_train = run_cli(
            torch, vis_file + vis + ["SOLVER.EPOCHS", "1", "TEST.START_EVAL_EPOCH", "1"], vis_ops,
            [VIS_CLI_STEPS * a + clips * b for a, b in zip(vstep, vclip)],
            max_steps=VIS_CLI_STEPS)
        checks["vis_train"] = cli_kernel_checks(torch, dev, vis_train.calls, True, "VIS train")
        ep = vis_train.result["epochs"][0]
        check_finite("VIS train", ep["train"])
        check_finite("VIS periodic eval", ep["eval"]["eval"])
        if ep["step"] != VIS_CLI_STEPS or not os.path.exists(os.path.join(vis_out, "checkpoint_best_vis_ap")):
            raise AssertionError(f"VIS train: {ep['step']} steps or no best checkpoint")

        log("CLI VIS --eval-only: build_tracker + inference_vis over 2 videos")
        vis_eval = run_cli(
            torch, vis_file + ["--eval-only"] + vis
            + ["MODEL.WEIGHTS", os.path.join(vis_out, "checkpoint")],
            vis_ops, [clips * b for b in vclip])
        checks["vis_eval"] = cli_kernel_checks(torch, dev, vis_eval.calls, False,
                                               "VIS --eval-only")
        res = vis_eval.result
        check_finite("TrackMAP", res["eval"]["eval"])
        with open(os.path.join(vis_out, "eval_results", "results.json")) as f:
            tracks = json.load(f)
        sizes = {tuple(s["size"]) for t in tracks for s in t["segmentations"] if s}
        if not tracks or sizes != {VIDEO_HW}:
            raise AssertionError(f"{len(tracks)} tracks; segmentation sizes {sizes}")
        log(f"  {len(tracks)} tracks; TrackMAP {res['eval']['eval']}; "
            f"{24 / vis_eval.eval_s:.3f} frames/s of the eval call ({card})")
        runs += [vis_train, vis_eval]

        coco_pipe, coco_shape = data_pipeline_seconds(torch, coco_file + coco)
        vis_pipe, vis_shape = data_pipeline_seconds(torch, vis_file + vis)
        log(f"  host data pipeline a batch (decode, transform, collate): COCO "
            f"{[round(v, 4) for v in coco_pipe]} s {coco_shape}, VIS "
            f"{[round(v, 4) for v in vis_pipe]} s {vis_shape}")

    wall = time.perf_counter() - t_phase
    cli = {
        "coco_eval_images_per_s": coco_images_per_s,
        "coco_train_step_s": coco_train.step_s + coco_resume.step_s,
        "coco_step_canvas": coco_train.canvas + coco_resume.canvas,
        "coco_seen_canvas_step_s": seen_canvas_steps(coco_train, coco_resume),
        "vis_train_step_s": vis_train.step_s,
        "coco_batch_wait_s": coco_train.waits + coco_resume.waits,
        "vis_batch_wait_s": vis_train.waits,
        "vis_eval_frames_per_s": 24 / vis_eval.eval_s,
        "coco_data_s_per_batch": coco_pipe, "vis_data_s_per_batch": vis_pipe,
        "coco_batch_shape": coco_shape, "vis_batch_shape": vis_shape,
        "phase_s": wall, "card": card, "kernel_checks": checks}
    log(f"CLI phase: {wall:.1f} s")
    launches = {}
    for run in runs:
        for k, v in run.launches.items():
            launches[k] = launches.get(k, 0) + v
    return cli, launches, checks


# ---------------------------------------------------------------------------
# The Swin-L configurations
# ---------------------------------------------------------------------------

SWIN_VIS_CONFIG = "configs/devis/YT-19/devis_Swin_L_YT-19.yaml"
SWIN_COCO_CONFIG = "configs/deformable_mask_head/deformable_mask_head_SwinL.yaml"
# the Swin backbone's own kernels, by a substring of their lower-case names
# (cuBLAS names the f32 window-logit product `sm80_xmma_gemm_f32f32_...`,
# which the fallback's "xmma" would count as a convolution)
SWIN_GROUPS = {"f32 matmuls (window logits)": "gemm_f32f32", "softmax": "softmax",
               "layer norm": "layer_norm", "gelu": "gelu", "roll": "roll",
               "bias-table gather": "index"}


def build_from_file(torch, dev, path, num_classes, opts=(), box_noise=True):
    """(cfg, model) of a config file of the repo as the port's YAML reader
    gives it, with `opts` and bf16 compute, seeded random weights (the
    noise of `move_taps_off_the_grid`), in eval mode."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(HERE, path))
    cfg.merge_from_list(list(opts) + ["TPU.COMPUTE_DTYPE", "bfloat16"])
    cfg.freeze()
    t0 = time.perf_counter()
    model = build_model(num_classes, cfg, seed=SEED)
    move_taps_off_the_grid(torch, model, dev, box_noise)
    log(f"model: {path}, backbone {cfg.MODEL.BACKBONE}, "
        f"{cfg.MODEL.TRANSFORMER.ENCODER_LAYERS}+{cfg.MODEL.TRANSFORMER.DECODER_LAYERS} layers, "
        f"bf16, {sum(p.numel() for p in model.parameters())} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model


def set_remat(model, on: bool):
    """TPU.SWIN_GRADIENT_CHECKPOINT and TPU.TRANSFORMER_GRADIENT_CHECKPOINT
    of a built model."""
    model.def_detr.backbone[0].body.use_checkpoint = on
    model.def_detr.transformer.remat_layers = on


def swin_clip_phase(torch, dev, card, rec):
    """DeVIS Swin-L (`SWIN_VIS_CONFIG`): 3 clips through `VISInferFn`
    (`infer_clips`), the kernels on the path's first inputs against their
    plain versions (`cli_kernel_checks`), one clip through the kernels and
    through the plain versions (`clip_vs_plain`), one clip profiled beside
    the Swin backbone alone on that clip's input. Returns the launches."""
    cfg, model = build_from_file(torch, dev, SWIN_VIS_CONFIG, NUM_CLASSES)
    with _FirstCalls(torch) as first:
        infer, video, launches, lat = infer_clips(torch, card, cfg, model,
                                                  "Swin-L clip inference path")
    rec["clip_kernel_errs"] = cli_kernel_checks(torch, dev, first.args, False,
                                                "Swin-L clip inference path")
    x, pad = clip_input(torch, dev, infer, video)
    rec["clip_vs_plain"] = clip_vs_plain(torch, model, x, pad)
    busy, wall, groups = profile_run(torch, "Swin-L clip", lambda: infer(video, 0),
                                     {**KERNEL_GROUPS, **SWIN_GROUPS})
    body = model.def_detr.backbone[0].body
    with torch.inference_mode():
        swin_busy, _, swin_groups = profile_run(
            torch, "Swin-L backbone alone on the clip's input",
            lambda: body(x.permute(0, 3, 1, 2)), SWIN_GROUPS)
    log(f"  Swin-L clip: device busy {busy:.3f} ms of {wall:.3f} ms wall, of which the Swin "
        f"backbone {swin_busy:.3f} ms (profiled alone) and the rest {busy - swin_busy:.3f} ms")
    rec.update(clip_ms=lat, clip_busy_ms=busy, clip_wall_ms=wall,
               clip_idle_share=max(0.0, 1 - busy / wall), clip_groups_ms=groups,
               backbone_busy_ms=swin_busy, backbone_groups_ms=swin_groups)
    del model, infer
    torch.cuda.empty_cache()
    return launches


def swin_step_compare(torch, dev, cfg, model, batch):
    """A step with both recomputation flags and one without, from the same
    weights, batch and dropout generator seed, dropout 0.1 and drop path up
    to 0.3 on: losses to 1e-2 and each gradient to GRAD_TOL of its own norm
    + GRAD_FLOOR of the whole (`report_step_difference`), the generator's state
    after the step equal. Leaves the weights as they were."""
    from devis_torch.engine import create_train_state, make_train_step

    log("Swin-L clip train step with both recomputation flags against one without, "
        "dropout and drop path on")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    out, gen_states = [], []
    for on in (True, False):
        model.load_state_dict(start)
        set_remat(model, on)
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        state = create_train_state(cfg, model, steps_per_epoch=100)
        _, metrics = make_train_step(model, cfg)(state, batch, gen)
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: p.grad.float().clone() for k, p in model.named_parameters()}))
        gen_states.append(gen.get_state())
    model.load_state_dict(start)
    set_remat(model, False)
    del start
    report_step_difference(torch, out, "the step with recomputation disagrees with the "
                                       "step without")
    same_gen = bool(torch.equal(gen_states[0], gen_states[1]))
    log(f"  dropout generator state after the step equal: {same_gen}")
    if not same_gen:
        raise AssertionError("recomputation moved the dropout generator")
    (m_on, g_on), (m_off, g_off) = out
    total = torch.sqrt(sum(g.double().square().sum() for g in g_off.values())).item()
    diff = torch.sqrt(sum((g_on[k] - g_off[k]).double().square().sum()
                          for k in g_off)).item()
    return dict(loss_on=m_on["loss"], loss_off=m_off["loss"], grad_diff_share=diff / total,
                generator_equal=same_gen)


def swin_train_phase(torch, dev, card, rec):
    """DeVIS Swin-L training at the train path's shapes (`train_batch`:
    one 384x640 clip, 4 instances in 10 slots), dropout 0.1, drop path to
    0.3: the flags compare (`swin_step_compare`), then 1 warm-up and 3 timed
    steps with both flags off and with both on, the counts zeroed before
    and read after the timed steps (a layer recomputed in the backward
    launches its forward kernels again: K1, K2, K3 twice a layer with the
    flags), every loss finite and every trained tensor moved, the peak
    memory of each, one more step of each profiled; the kernels of the
    flagged run on its first inputs against their plain versions. Returns
    the launches of each run."""
    import contextlib

    from devis_torch.engine import create_train_state, make_train_step, param_labels
    from devis_torch.models.segmentation import ModulatedDeformableConv

    cfg, model = build_from_file(torch, dev, SWIN_VIS_CONFIG, NUM_CLASSES)
    batch = train_batch(N_SLOTS)
    rec["step_compare"] = swin_step_compare(torch, dev, cfg, model, batch)
    torch.cuda.empty_cache()
    labels = param_labels(model, cfg)
    n_enc = cfg.MODEL.TRANSFORMER.ENCODER_LAYERS
    n_dec = cfg.MODEL.TRANSFORMER.DECODER_LAYERS
    n_dcn = sum(isinstance(m, ModulatedDeformableConv) for m in model.modules())
    n_mask = 1 + len(cfg.MODEL.LOSS.MASK_AUX_LOSS)
    n_steps = 3
    runs = {}
    for on in (False, True):
        tag = "remat" if on else "plain"
        log(f"Swin-L clip train path, recomputation {'on' if on else 'off'}: make_train_step, "
            f"{N_INSTANCES} instances in {N_SLOTS} slots, dropout {cfg.MODEL.DROPOUT}")
        set_remat(model, on)
        state = create_train_state(cfg, model, steps_per_epoch=100)
        step = make_train_step(model, cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        torch.cuda.reset_peak_memory_stats()
        state, _ = step(state, batch, gen)                   # warm-up
        torch.cuda.synchronize()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ops = kernel_ops()
        for fn in ops:
            fn.launches = fn.plain_calls = 0
        with _FirstCalls(torch) if on else contextlib.nullcontext() as first:
            state, step_ms = timed_steps(torch, step, state, batch, gen, n_steps)
        launches = {fn.__name__: fn.launches for fn in ops}
        log(f"  launches over {n_steps} steps: {launches}; plain calls: "
            f"{ {fn.__name__: fn.plain_calls for fn in ops} }")
        k = 2 if on else 1
        check_counts(ops, [n_steps * c for c in (k * n_enc, k * n_enc, k * n_dec, n_enc + n_dec,
                                                 n_dcn * n_mask, n_dcn * n_mask, 0)])
        check_parameters_moved(torch, model, labels, before)
        del before
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  Swin-L train step, recomputation {'on' if on else 'off'}: "
            f"{[round(v, 3) for v in step_ms]} ms, mean {sum(step_ms) / n_steps:.3f} ms; "
            f"peak memory {peak:.3f} GiB ({card})")
        rec[f"train_{tag}_step_ms"] = step_ms
        rec[f"train_{tag}_peak_gib"] = peak
        busy, wall, _ = profile_run(torch, f"Swin-L train step, recomputation "
                                           f"{'on' if on else 'off'}",
                                    lambda: step(state, batch, gen),
                                    {**KERNEL_GROUPS, **SWIN_GROUPS})
        rec[f"train_{tag}_busy_ms"], rec[f"train_{tag}_wall_ms"] = busy, wall
        runs[tag] = launches
        if on:
            rec["train_kernel_errs"] = cli_kernel_checks(
                torch, dev, first.args, True, "Swin-L clip train step (both flags)")
    set_remat(model, False)
    del model, state, step
    torch.cuda.empty_cache()
    return runs


def swin_image_phase(torch, dev, card, rec):
    """The COCO image model on Swin-L (`SWIN_COCO_CONFIG` for 'coco'): 3
    images through `evaluate_coco` (`eval_images`), the kernels on the
    path's first inputs against their plain versions, one image through the
    kernels and through the plain versions (`coco_vs_plain`). Returns the
    launches."""
    cfg, model = build_from_file(torch, dev, SWIN_COCO_CONFIG, COCO_CLASSES,
                                 ["DATASETS.TYPE", "coco", "TEST.EVAL_BATCH_SIZE", "1"])
    with _FirstCalls(torch) as first:
        dataset, launches, image_ms = eval_images(torch, card, cfg, model,
                                                  "COCO Swin-L inference path")
    rec["image_kernel_errs"] = cli_kernel_checks(torch, dev, first.args, False,
                                                 "COCO Swin-L inference path")
    rec["image_vs_plain"] = coco_vs_plain(torch, dev, model, dataset[0])
    rec["image_ms"] = image_ms
    del model
    torch.cuda.empty_cache()
    return launches


def swin_phase(torch, dev, card):
    """The Swin-L configurations at full width and depth, bf16, seeded
    random weights: DeVIS Swin-L clip inference, its clip train step with
    and without recomputation, the COCO Swin-L image model. Returns (the
    `swin` record, launches by path)."""
    t0 = time.perf_counter()
    rec = {"card": card}
    launches = {"clip": swin_clip_phase(torch, dev, card, rec)}
    train = swin_train_phase(torch, dev, card, rec)
    launches["train"], launches["remat_train"] = train["plain"], train["remat"]
    launches["image"] = swin_image_phase(torch, dev, card, rec)
    rec["phase_s"] = time.perf_counter() - t0
    log(f"Swin-L phase: {rec['phase_s']:.1f} s")
    return rec, launches


# ---------------------------------------------------------------------------
# The paper's ablation configurations
# ---------------------------------------------------------------------------

ABLATION_DIR = "configs/devis/ablations"
ABLATION_CONFIGS = {"0": "devis_ablation0_deformable_vistr.yaml",
                    "1": "devis_ablation1_deformable_vistr_wo_temp_conn.yaml",
                    "2": "devis_ablation2_single-scale.yaml",
                    "2-5": "devis_ablation2-5_single-scale_wo_temp_conn.yaml",
                    "3": "devis_ablation3_increased-spatial-inputs.yaml",
                    "4": "devis_ablation4_instance-aware.yaml"}


def ablation_temporal_kernels(torch, model, x, pad):
    """K2 and K1 on encoder layer 0's inputs and K3 on decoder layer 0's at
    the ablation's geometry (W = T - 1 under the rule "all", L levels),
    each against its plain version in f32 (TF32 off, 1e-4) and bf16 (2e-2);
    the windows' sizes per stage and the corners K1 reads from global
    memory; device times beside the bounds (section 6's rule). Returns the
    record."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.ms_deform_attn import temporal_frame_table

    enc, query, ref, src, shapes, padding, c_off, t_off = capture_encoder0(model, x, pad)
    Tn, Q, L, _ = ref.shape
    W = Tn - 1
    value = enc._value(src, padding).contiguous()
    Mh, Dh = value.shape[2], value.shape[3]
    Pn = c_off.shape[-1] // (Mh * L * 2)
    c_logit = enc.attention_weights(query).contiguous()
    t_logit = enc.temporal_attention_weights(query).contiguous()
    rule = ("all",)
    log(f"K2 and K1 on encoder layer 0's inputs: T={Tn} Q={Q} levels {list(shapes)} "
        f"W={W} Lf={(1 + W) * L} P={Pn}")
    win = K.msda_tap_window(shapes, ref, c_off, t_off, Mh)
    if not torch.equal(win, K.msda_tap_window_plain(shapes, ref, c_off, t_off, Mh)):
        raise AssertionError("K2 windows differ from the plain version")
    plan = K.window_plan(shapes, value.dtype, Dh, Pn)
    stats = window_stats(torch, win, plan, L)
    a16 = (value, shapes, ref, c_off, t_off, c_logit, t_logit, rule)
    a32 = tuple(t.float() if torch.is_tensor(t) else t for t in a16)
    compare("  K1 f32 ", K.msda_temporal_proj(*a32), K.msda_temporal_proj_plain(*a32), 1e-4)
    k1_err = compare("  K1 bf16", K.msda_temporal_proj(*a16), K.msda_temporal_proj_plain(*a16),
                     2e-2)
    _, reads = K.launch_k1(*a16, win, plan, "count")
    log(f"  corners read from global memory {reads.tolist()} (in fitted windows, in windows "
        f"over capacity; plan {tuple(plan)})")
    if reads[0].item() != 0:
        raise AssertionError("a K2 window missed a tap of K1")
    table = torch.as_tensor(temporal_frame_table(rule, Tn), device=x.device)
    frames = torch.cat([torch.arange(Tn, device=x.device)[:, None], table], 1)
    loc = K.temporal_proj_locations(shapes, ref, c_off, t_off, Mh)
    k1_bytes = (sum(t.numel() * t.element_size() for t in a16[2:] if torch.is_tensor(t))
                + Tn * Q * Mh * Dh * 2 + corner_stats(loc, shapes, frames)[2] * Dh * 2)
    k1_flops = Tn * Q * Mh * (1 + W) * L * Pn * (8 * Dh + 40)
    k1 = dict(ms=device_ms(lambda: K.launch_k1(*a16, win, plan), "msda_temporal_proj_win"),
              op_ms=cuda_time(lambda: K.msda_temporal_proj(*a16), 20),
              plain_ms=cuda_time(lambda: K.msda_temporal_proj_plain(*a16), 2, 1),
              k2_ms=device_ms(lambda: K.msda_tap_window(shapes, ref, c_off, t_off, Mh),
                              "msda_tap_window_kernel"),
              max_abs_err=k1_err, reads=reads.tolist(), windows=stats, Q=Q, W=W, L=L,
              bound_ms=max(k1_bytes / HBM_BYTES_PER_S, k1_flops / F32_FLOPS) * 1e3)
    del a32, loc, win
    dvalue, dshapes, dloc, datt, drule = capture_decoder0(model, x, pad)
    Qd = dloc.shape[1]
    log(f"K3 on decoder layer 0's inputs: T={Tn} Q={Qd} Lf={dloc.shape[3]} P={dloc.shape[4]}")
    v32 = dvalue.float()
    compare("  K3 f32 ", K.msda_temporal(v32, dshapes, dloc, datt, drule),
            K.ms_deform_attn_temporal_plain(v32, dshapes, dloc, datt, drule), 1e-4)
    k3_err = compare("  K3 bf16", K.msda_temporal(dvalue, dshapes, dloc, datt, drule),
                     K.ms_deform_attn_temporal_plain(dvalue, dshapes, dloc, datt, drule), 2e-2)
    k3_bytes = (corner_stats(dloc, dshapes, frames)[2] * Dh * 2 + dloc.numel() * 4
                + datt.numel() * 4 + Tn * Qd * Mh * Dh * 2)
    k3_flops = Tn * Qd * Mh * dloc.shape[3] * dloc.shape[4] * 8 * Dh
    k3 = dict(ms=device_ms(lambda: K.msda_temporal(dvalue, dshapes, dloc, datt, drule),
                           "msda_temporal_kernel"),
              op_ms=cuda_time(lambda: K.msda_temporal(dvalue, dshapes, dloc, datt, drule), 50),
              plain_ms=cuda_time(lambda: K.ms_deform_attn_temporal_plain(
                  dvalue, dshapes, dloc, datt, drule), 3, 1),
              max_abs_err=k3_err, Q=Qd, W=W, L=L, grid=k3_grid(torch, dloc),
              bound_ms=max(k3_bytes / HBM_BYTES_PER_S, k3_flops / F32_FLOPS) * 1e3)
    for name, r in (("K1", k1), ("K3", k3)):
        log(f"  {name} at W={W} L={L}: {r['ms']:.4f} ms of device time (op {r['op_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.3f} ms), bound {r['bound_ms']:.5f} ms")
    return dict(K1=k1, K3=k3)


def ablation_k5(torch, calls):
    """K5's device time and bound (section 6's rule) on the train step's
    encoder-layer-0 inputs (kept by `_FirstCalls`) with a seeded output
    gradient; `cli_kernel_checks` holds it against its plain version."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.ms_deform_attn import temporal_frame_table

    value, shapes, ref, c_off, t_off, c_logit, t_logit, rule = calls["msda_temporal_proj"]
    Tn, Q, L, _ = ref.shape
    Mh, Dh = value.shape[2], value.shape[3]
    gen = torch.Generator(device=value.device).manual_seed(SEED + 21)
    with torch.no_grad():
        loc = K.temporal_proj_locations(shapes, ref, c_off, t_off, Mh).contiguous()
        att = K.temporal_proj_weights(c_logit, t_logit, Mh, L).contiguous()
        g = torch.randn(Tn, Q, Mh * Dh, generator=gen, device=value.device).to(value.dtype)
        args = (value, shapes, loc, att, g, rule)
        table = torch.as_tensor(temporal_frame_table(rule, Tn), device=value.device)
        frames = torch.cat([torch.arange(Tn, device=value.device)[:, None], table], 1)
        nbytes, flops, corners = backward_cost(loc, att, value, shapes, frames, Dh)
        ms = device_profile(lambda: K.msda_temporal_bwd(*args), 10, "k5_bwd")[0]
        op_ms = cuda_time(lambda: K.msda_temporal_bwd(*args), 10)
        plain_ms = cuda_time(lambda: K.msda_temporal_bwd_plain(*args), 1, 1)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    log(f"K5 on the train step's encoder layer 0 inputs, W={Tn - 1} L={L}: {ms:.4f} ms of "
        f"device time (op {op_ms:.4f} ms, plain {plain_ms:.3f} ms), bound {bound:.5f} ms; "
        f"{corners} live corners")
    return dict(ms=ms, op_ms=op_ms, plain_ms=plain_ms, bound_ms=bound, Q=Q, W=Tn - 1, L=L)


def ablation_train(torch, dev, card, cfg, model, key, hw, canvas, rec):
    """One warm-up and one counted train step through `make_train_step` on
    one seeded clip of the config's T frames at the test canvas, 4
    instances in 10 slots, dropout as the config sets it: `clip_wants`
    launches, no plain path, finite losses, the step's ms and peak memory.
    Returns (launches, the step's first calls)."""
    from devis_torch.engine import create_train_state, make_train_step
    from devis_torch.util.synthetic import synthetic_clip_batch

    Tn = cfg.MODEL.DEVIS.NUM_FRAMES
    batch = synthetic_clip_batch(SEED + 22, Tn, canvas, hw, N_INSTANCES, N_SLOTS,
                                 NUM_CLASSES - 1)
    log(f"ablation {key} train step: make_train_step, one clip of {Tn} frames on the "
        f"{canvas[0]}x{canvas[1]} canvas, {N_INSTANCES} instances in {N_SLOTS} slots")
    state = create_train_state(cfg, model, steps_per_epoch=100)
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    state, _ = step(state, batch, gen)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops = clip_ops()
    zero_coco_counts(ops)
    with _FirstCalls(torch) as first:
        state, step_ms = timed_steps(torch, step, state, batch, gen, 1)
    launches = {fn.__name__: fn.launches for fn in ops}
    log(f"  launches: {launches}")
    check_coco_counts(ops, clip_wants(cfg, model, train=True))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  ablation {key} train step {step_ms[0]:.3f} ms, peak memory {peak:.3f} GiB ({card})")
    rec.update(step_ms=step_ms[0], peak_gib=peak)
    model.eval()
    del state, step
    return launches, first.args


def ablation_config(torch, dev, card, key, n_clips, rec, train=False, kernels=False,
                    heads_profile=False):
    """One ablation config file at full width and depth, bf16, seeded random
    weights: `n_clips` clips through `VISInferFn` with their launches, one
    clip through the plain versions held to the clip path's gates, one clip
    profiled (and with `heads_profile` the plain-conv and 3-d heads alone
    on that clip's inputs); with `kernels` the temporal kernels on the path's
    inputs (`ablation_temporal_kernels`); with `train` one train step
    (`ablation_train`), then its kernels on their first inputs against
    their plain versions (`cli_kernel_checks`; K5 also timed with
    `kernels`, `ablation_k5`). Returns the launches by path."""
    cfg, model = build_from_file(torch, dev, os.path.join(ABLATION_DIR, ABLATION_CONFIGS[key]),
                                 NUM_CLASSES)
    with _FirstCalls(torch) as first:
        infer, video, launches, lat = infer_clips(torch, card, cfg, model, f"ablation {key}",
                                                  n_clips)
    rec["clip_kernel_errs"] = cli_kernel_checks(torch, dev, first.args, False,
                                                f"ablation {key} clip")
    x, pad = clip_input(torch, dev, infer, video)
    rec["clip_vs_plain"] = clip_vs_plain(torch, model, x, pad)
    if kernels:
        with torch.inference_mode():
            rec["kernels_w"] = ablation_temporal_kernels(torch, model, x, pad)
    busy, wall, by_group = profile_run(torch, f"ablation {key} clip", lambda: infer(video, 0))
    rec.update(clip_ms=lat, clip_busy_ms=busy, clip_wall_ms=wall,
               clip_idle_share=max(0.0, 1 - busy / wall), clip_groups_ms=by_group)
    if heads_profile:
        held = {}
        hooks = [mod.register_forward_pre_hook(
            lambda m, args, kwargs, name=name: held.setdefault(name, (args, kwargs)),
            with_kwargs=True)
            for name, mod in (("mask", model.mask_head), ("3d", model.conv_head_3d))]
        with torch.inference_mode():
            model(x, pad)
        for h in hooks:
            h.remove()
        with torch.inference_mode():
            mask_ms, _, _ = profile_run(torch, f"ablation {key} plain-conv mask head alone",
                                        lambda: model.mask_head(*held["mask"][0],
                                                                **held["mask"][1]))
            head3d_ms, _, _ = profile_run(torch, f"ablation {key} 3-d conv head alone",
                                          lambda: model.conv_head_3d(*held["3d"][0]))
        del held
        log(f"  ablation {key} clip: device busy {busy:.3f} ms, of which the plain-conv mask "
            f"head {mask_ms:.3f} ms and the 3-d head {head3d_ms:.3f} ms (profiled alone)")
        rec.update(mask_head_busy_ms=mask_ms, conv3d_head_busy_ms=head3d_ms)
    out = {"clip": launches}
    if train:
        from devis_torch.datasets.transforms import get_size_with_aspect_ratio
        from devis_torch.inference import make_eval_buckets
        del infer
        hw = get_size_with_aspect_ratio(VIDEO_HW, cfg.INPUT.MIN_SIZE_TEST,
                                        cfg.INPUT.MAX_SIZE_TEST)
        canvas = make_eval_buckets(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)[0]
        out["train"], calls = ablation_train(torch, dev, card, cfg, model, key, hw, canvas, rec)
        k5 = ablation_k5(torch, calls) if kernels else None
        rec["train_kernel_errs"] = cli_kernel_checks(torch, dev, calls, True,
                                                     f"ablation {key} train step")
        if k5 is not None:
            rec["kernels_w"]["K5"] = dict(k5, max_abs_err=rec["train_kernel_errs"]["K5"])
    del model
    torch.cuda.empty_cache()
    return out


def ablation_step_compare(torch, dev):
    """Ablation 1 (no temporal connections, 36 frames): one train step with
    1 encoder and 2 decoder layers at full width, the kernels (K8, K6, K7,
    K9) against the plain versions on the card, dropout off, as
    `train_compare` holds it."""
    from devis_torch.datasets.transforms import get_size_with_aspect_ratio
    from devis_torch.inference import make_eval_buckets
    from devis_torch.util.synthetic import synthetic_clip_batch

    log("ablation 1: kernel path against plain path, one train step, 1+2 layers at full "
        "width, 36 frames")
    cfg, model = build_from_file(
        torch, dev, os.path.join(ABLATION_DIR, ABLATION_CONFIGS["1"]), NUM_CLASSES,
        ["MODEL.TRANSFORMER.ENCODER_LAYERS", "1", "MODEL.TRANSFORMER.DECODER_LAYERS", "2"],
        box_noise=False)
    hw = get_size_with_aspect_ratio(VIDEO_HW, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    canvas = make_eval_buckets(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)[0]
    batch = synthetic_clip_batch(SEED + 22, cfg.MODEL.DEVIS.NUM_FRAMES, canvas, hw,
                                 N_INSTANCES, N_SLOTS, NUM_CLASSES - 1)
    compare_train_paths(torch, cfg, model, batch, clip_ops(),
                        {"msda_proj": "msda_proj_plain", "msda_taps": "ms_deform_attn"})
    del model
    torch.cuda.empty_cache()


def ablation_phase(torch, dev, card):
    """The paper's ablation configurations at full width and depth, bf16,
    seeded random weights, each from its config file: ablation 0 (36-frame
    clips, temporal attention over 35 frames at one level) and ablation 1
    (36 frames, no temporal connections) with 2 clips, the path's kernels
    and a train step each, ablation 1's kernel-path against plain-path
    step; ablations 2, 2-5, 3 and 4 (6 frames) with 3 clips each, ablation
    3's heads profiled. Returns (the `ablations` record, launches by path)."""
    t0 = time.perf_counter()
    rec, launches = {"card": card}, {}
    for key, kw in (("0", dict(n_clips=2, train=True, kernels=True)),
                    ("1", dict(n_clips=2, train=True)),
                    ("2", dict(n_clips=3)), ("2-5", dict(n_clips=3)),
                    ("3", dict(n_clips=3, heads_profile=True)), ("4", dict(n_clips=3))):
        rec[key] = {}
        for path, n in ablation_config(torch, dev, card, key, rec=rec[key], **kw).items():
            launches[f"ablation{key}_{path}"] = n
        if key == "1":
            ablation_step_compare(torch, dev)
    rec["phase_s"] = time.perf_counter() - t0
    log(f"ablation phase: {rec['phase_s']:.1f} s")
    return rec, launches


# ---------------------------------------------------------------------------
# training over many steps, and across processes
# ---------------------------------------------------------------------------

OVERFIT_STEPS = 1000


def overfit_phase(torch, dev, card):
    """`devis_torch.overfit_synthetic` with the MDC head (T = 4 at 128x192,
    2 + 2 layers, 24 queries, f32): OVERFIT_STEPS train steps, the counts
    zeroed just before and read just after (a step: K1 and K2 once an
    encoder layer, K3 once a decoder layer, K5 once a layer, K6 and K7 once
    a DCNv2 layer a mask level, K4 never); then `build_tracker` +
    `inference_vis` over its two synthetic videos, counted the same way (a
    clip: K1-K3 as above, K4 once a DCNv2 layer, no backward). The loss
    must halve and the tracks must not collapse. Before the steps, one
    step of a copy of the model on the first clip, kernel path against
    plain path at the train path's gates (`compare_train_paths`), and the
    kernels on that step's first inputs against their plain versions; after
    tracking, the kernels on the tracker's first inputs the same way
    (`cli_kernel_checks`). Returns (record, launches by path)."""
    import copy

    from devis_torch import overfit_synthetic as ov
    from devis_torch.models.segmentation import ModulatedDeformableConv

    t0 = time.perf_counter()
    cfg, model, clips = ov.build(mdc=True, device=dev)
    log("overfit phase: kernel path against plain path, one train step on the first clip")
    ops = kernel_ops()
    with _FirstCalls(torch) as first:
        step_diff = compare_train_paths(
            torch, cfg, copy.deepcopy(model), ov.clip_batch(clips[0]), ops,
            {"msda_temporal_proj": "msda_temporal_proj_plain",
             "msda_temporal": "ms_deform_attn_temporal_plain", "msda_rows": "ms_deform_attn"})
    train_errs = cli_kernel_checks(torch, dev, first.args, True, "overfit train step")
    n_enc = cfg.MODEL.TRANSFORMER.ENCODER_LAYERS
    n_dec = cfg.MODEL.TRANSFORMER.DECODER_LAYERS
    n_dcn = sum(isinstance(m, ModulatedDeformableConv) for m in model.modules())
    n_mask = 1 + len(cfg.MODEL.LOSS.MASK_AUX_LOSS)
    log(f"overfit phase: devis_torch.overfit_synthetic, MDC head, {OVERFIT_STEPS} steps over "
        f"{len(clips)} clips, then tracking and TrackMAP")
    for fn in ops:
        fn.launches = fn.plain_calls = 0
    losses, sec_per_step, final = ov.train(cfg, model, clips, OVERFIT_STEPS,
                                           log=lambda msg, **_: log("  " + msg))
    train_launches = {fn.__name__: fn.launches for fn in ops}
    log(f"  launches over {OVERFIT_STEPS} steps: {train_launches}")
    check_counts(ops, [OVERFIT_STEPS * c for c in (n_enc, n_enc, n_dec, n_enc + n_dec,
                                                   n_dcn * n_mask, n_dcn * n_mask, 0)])
    for fn in ops:
        fn.launches = fn.plain_calls = 0
    t1 = time.perf_counter()
    with _FirstCalls(torch) as first:
        out = ov.evaluate(cfg, model, verbose=False)
        torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    eval_launches = {fn.__name__: fn.launches for fn in ops}
    n_clips = sum(len(v) for v in ov.val_dataset(cfg).videos)
    log(f"  launches over the tracker's {n_clips} clips: {eval_launches}")
    check_counts(ops, [n_clips * c for c in (n_enc, n_enc, n_dec, 0, 0, 0, n_dcn)])
    eval_errs = cli_kernel_checks(torch, dev, first.args, False, "overfit tracking")
    result = ov.report(cfg, model, clips, losses, sec_per_step, out,
                       log=lambda msg, **_: log("  " + msg), final=final)
    ov.check(result)
    record = {"steps": OVERFIT_STEPS, "sec_per_step": sec_per_step, "eval_s": eval_s,
              "loss_curve": losses, "final_losses": final,
              **{k: result["eval"][k] for k in ("AP", "AP50", "AP75")},
              "pred_pred_iou": result["diagnostics"]["pred_pred_iou"],
              "best_gt_iou": result["diagnostics"]["best_gt_iou"],
              "train_mask_iou": result["diagnostics"]["train_mask_iou"],
              "collapsed": result["diagnostics"]["collapsed"],
              "step_vs_plain": step_diff, "train_kernel_errs": train_errs,
              "eval_kernel_errs": eval_errs,
              "max_abs_err": max(list(train_errs.values()) + list(eval_errs.values())),
              "phase_s": time.perf_counter() - t0, "card": card}
    log(f"  overfit phase: {record['phase_s']:.1f} s, {sec_per_step * 1e3:.3f} ms a step "
        f"({card})")
    del model
    torch.cuda.empty_cache()
    return record, {"overfit_train": train_launches, "overfit_eval": eval_launches}


def allreduce_calls(torch, fn):
    """Calls of the process group's all-reduce (the profiler's
    `nccl:all_reduce` host events) in one call of `fn`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if "all_reduce" in e.key.lower()
               and getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU)


def ddp_phase(torch, dev, card):
    """DDP over NCCL at world size 1, in this process (the card has one GPU;
    more ranks are tested on the CPU with gloo): `init_process_group` from a
    torchrun-like environment, then the train path's full-width DeVIS R50
    clip step on the train path's batch, unwrapped and wrapped in
    `DistributedDataParallel` (`parallel.data_parallel`), each from the same
    weights and dropout seed. The first steps are held to each other at the
    train path's gates (every loss to 1e-2, each gradient to 5e-2 of its
    norm + 1e-5 of the whole);
    then 3 timed steps of each, the wrapped ones with the counts zeroed just
    before and read just after, and one profiled step of each, where the
    wrapped step must call the all-reduce more often (DDP's buckets) than
    the unwrapped one (the normaliser and the metrics). Returns (record,
    launches)."""
    import copy
    import socket

    import numpy as np

    from devis_torch.engine import create_train_state, make_train_step
    from devis_torch.parallel import data_parallel, destroy_process_group, init_process_group

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        got = init_process_group(dev)
        if got is None or torch.distributed.get_backend() != "nccl":
            raise AssertionError(f"no NCCL process group ({got})")
        log(f"DDP phase: NCCL process group, world size {torch.distributed.get_world_size()}, "
            f"device {got}")
        cfg, model0 = build(torch, dev)
        weights = copy.deepcopy(model0.state_dict())
        batch = train_batch(N_SLOTS)
        ops = kernel_ops()
        firsts, times, calls, record = [], {}, {}, {}
        launches = {}
        for tag in ("unwrapped", "ddp"):
            model = model0 if tag == "unwrapped" else copy.deepcopy(model0)
            model.load_state_dict(weights)
            state = create_train_state(cfg, model, steps_per_epoch=100)
            wrapped = data_parallel(model, got) if tag == "ddp" else model
            if tag == "ddp" and not isinstance(wrapped,
                                               torch.nn.parallel.DistributedDataParallel):
                raise AssertionError("data_parallel did not wrap the model")
            step = make_train_step(wrapped, cfg)
            gen = torch.Generator(device=dev).manual_seed(SEED + 3)
            state, metrics = step(state, batch, gen)
            firsts.append(({k: float(v) for k, v in metrics.items()},
                           {k: p.grad.float().clone() for k, p in model.named_parameters()}))
            for fn in ops:
                fn.launches = fn.plain_calls = 0
            state, step_ms = timed_steps(torch, step, state, batch, gen, 3)
            launches[tag] = {fn.__name__: fn.launches for fn in ops}
            times[tag] = float(np.mean(step_ms))
            calls[tag] = allreduce_calls(torch, lambda: step(state, batch, gen))
            log(f"  {tag} step {[round(v, 3) for v in step_ms]} ms, mean {times[tag]:.3f} ms; "
                f"{calls[tag]} all-reduce calls a step; launches over 3 steps {launches[tag]}")
            del state, step, wrapped
            torch.cuda.empty_cache()
        n_enc = cfg.MODEL.TRANSFORMER.ENCODER_LAYERS
        n_dec = cfg.MODEL.TRANSFORMER.DECODER_LAYERS
        from devis_torch.models.segmentation import ModulatedDeformableConv
        n_dcn = sum(isinstance(m, ModulatedDeformableConv) for m in model0.modules())
        n_mask = 1 + len(cfg.MODEL.LOSS.MASK_AUX_LOSS)
        for fn, want in zip(ops, (n_enc, n_enc, n_dec, n_enc + n_dec, n_dcn * n_mask,
                                  n_dcn * n_mask, 0)):
            if launches["ddp"][fn.__name__] != 3 * want:
                raise AssertionError(f"DDP steps: {fn.__name__} launched "
                                     f"{launches['ddp'][fn.__name__]} times, want {3 * want}")
        diff = report_step_difference(torch, firsts,
                                      what="DDP step disagrees with the unwrapped step")
        if not calls["ddp"] > calls["unwrapped"] >= 1:
            raise AssertionError(f"all-reduce calls: {calls} (DDP's buckets missing)")
        record = {"world_size": torch.distributed.get_world_size(), "backend": "nccl",
                  "ddp_step_ms": times["ddp"], "step_ms": times["unwrapped"],
                  "allreduce_calls": calls, "vs_unwrapped": diff, "card": card}
        log(f"  DDP step {times['ddp']:.3f} ms against the unwrapped step "
            f"{times['unwrapped']:.3f} ms ({card})")
        del model0, model, firsts
        torch.cuda.empty_cache()
        return record, launches["ddp"]
    finally:
        destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# the visualizers
# ---------------------------------------------------------------------------

VIZ_CONFIG = "configs/devis/devis_R_50_visualization_YT-21.yaml"
VIZ_VIDEOS = ("4b1a561480", "c34989e3")      # the config's TEST.VIZ.VIDEO_NAMES
VIZ_QUERIES = 3


def viz_phase(torch, dev, card):
    """The visualizers at the visualization config's full width (180
    queries, 6 + 6 layers, bf16) on a seeded YouTube-VIS 2021 tree whose two
    validation videos (12 frames of 360x640, 3 clips each) carry the
    config's `VIDEO_NAMES`, one set of seeded weights (the noise of
    `move_taps_off_the_grid`) saved as a checkpoint of the port for both
    runs. (1) `devis_torch.main --config-file <the config> --eval-only`
    with DATASETS.DATA_PATH, MODEL.WEIGHTS and the output paths set: K1-K4
    6 launches a clip and no plain path, the kernels held to their plain
    versions on the run's first inputs (`cli_kernel_checks`), one merged
    overlay a frame of each named video. (2) `visualize_att_maps.main(...
    --per-level)` on the same tree and weights, 3 queries a video: K1-K4 6
    launches a video, a merged overlay and one a level a (query, frame),
    and its capture (the last decoder layer's current-frame locations and
    weights) held to the capture of the same forward through the plain
    versions (`plain_forward`) within the clip path's gates:
    locations 2e-2 (normalized, as boxes), weights 5e-2 of their largest
    value. Returns (record, launches by op over both runs)."""
    import tempfile
    import types

    import cv2

    from devis_torch import visualize_att_maps
    from devis_torch.config import get_cfg_defaults
    from devis_torch.datasets import build_dataset
    from devis_torch.models import build_model
    from devis_torch.util import checkpoint as ckpt
    from devis_torch.util.fixtures import tree_summary, write_vis_tree

    t_phase = time.perf_counter()
    ops = kernel_ops()
    cfg_file = os.path.join(HERE, VIZ_CONFIG)
    rec = {"card": card}
    with tempfile.TemporaryDirectory(prefix="devis_viz_") as tmp:
        data = os.path.join(tmp, "data")
        write_vis_tree(data, seed=SEED, n_train=1, n_val=2, n_frames=12, size=VIDEO_HW,
                       version="2021", val_names=VIZ_VIDEOS)
        log(f"visualization phase: YouTube-VIS 2021 tree {tree_summary(data)}")
        common = ["DATASETS.DATA_PATH", data, "TPU.COMPUTE_DTYPE", "bfloat16"]
        cfg = get_cfg_defaults()
        cfg.merge_from_file(cfg_file)
        cfg.merge_from_list(common + ["MODEL.WEIGHTS", ""])
        model = build_model(build_dataset("VAL", cfg)[1], cfg, device=dev, seed=cfg.SEED)
        move_taps_off_the_grid(torch, model, dev, box_noise=True)
        weights = os.path.join(tmp, "weights")
        ckpt.save_checkpoint(weights, types.SimpleNamespace(
            model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.0), step=0))
        del model
        torch.cuda.empty_cache()
        common += ["MODEL.WEIGHTS", weights]

        viz_out = os.path.join(tmp, "visual_results")
        log(f"visualization config --eval-only: {len(VIZ_VIDEOS)} named videos, merged tracks")
        t0 = time.perf_counter()
        run = run_cli(torch, ["--config-file", cfg_file, "--eval-only"] + common
                      + ["OUTPUT_DIR", os.path.join(tmp, "out"), "TEST.VIZ.OUT_VIZ_PATH", viz_out],
                      ops, [2 * 3 * b for b in (6, 6, 6, 0, 0, 0, 6)])
        rec["cli_s"] = time.perf_counter() - t0
        rec["kernel_checks"] = cli_kernel_checks(torch, dev, run.calls, False,
                                                 "visualization config --eval-only")
        check_finite("visualization config eval", run.result["eval"]["eval"])
        overlays = {}
        for name in VIZ_VIDEOS:
            folder = os.path.join(viz_out, name)
            files = sorted(os.listdir(folder)) if os.path.isdir(folder) else []
            shapes = {getattr(cv2.imread(os.path.join(folder, f)), "shape", None)
                      for f in files}
            if len(files) != 12 or shapes != {VIDEO_HW + (3,)}:
                raise AssertionError(f"{name}: overlays {files} of shapes {shapes}")
            overlays[name] = len(files)
        if sorted(os.listdir(viz_out)) != sorted(VIZ_VIDEOS):
            raise AssertionError(f"renders for {os.listdir(viz_out)}")
        rec["overlays"] = overlays
        log(f"  overlays {overlays}; {rec['cli_s']:.1f} s ({card})")

        maps = {}
        def maps_argv(out):
            return ["--config-file", cfg_file, "--videos", "2", "--queries", str(VIZ_QUERIES),
                    "--per-level", "--out-dir", os.path.join(tmp, out)] + common

        zero_coco_counts(ops)
        t0 = time.perf_counter()
        maps["kernels"] = visualize_att_maps.main(maps_argv("maps"))
        torch.cuda.synchronize()
        rec["att_maps_s"] = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in ops}
        check_coco_counts(ops, [2 * b for b in (6, 6, 6, 0, 0, 0, 6)])
        with plain_forward():
            maps["plain"] = visualize_att_maps.main(maps_argv("maps_plain"))
        errs = {"loc": 0.0, "att / max": 0.0}
        n_files = 0
        for vid, got in maps["kernels"].items():
            want = maps["plain"][vid]
            errs["loc"] = max(errs["loc"], float(abs(got["loc"] - want["loc"]).max()))
            errs["att / max"] = max(errs["att / max"], float(
                abs(got["att"] - want["att"]).max() / abs(want["att"]).max()))
            T, _, _, L = got["loc"].shape[:4]
            if len(got["paths"]) != VIZ_QUERIES * T * (1 + L) or \
                    any(not os.path.getsize(p) for p in got["paths"]):
                raise AssertionError(f"video {vid}: {len(got['paths'])} maps written")
            n_files += len(got["paths"])
        log(f"  visualize_att_maps --per-level: {n_files} maps, {rec['att_maps_s']:.1f} s "
            f"({card}); launches {launches}; capture against the plain path: {errs} "
            f"(limits 2e-2, 5e-2)")
        if errs["loc"] > 2e-2 or errs["att / max"] > 5e-2:
            raise AssertionError("the attention maps' capture disagrees with the plain path")
        rec.update(att_map_files=n_files, capture_errs=errs)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"visualization phase: {rec['phase_s']:.1f} s")
    total = dict(run.launches)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return rec, total


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
    temporal_bwd_phase(torch, dev, gen, results)
    rows_phase(torch, dev, gen, results)
    coco_kernel_phases(torch, dev, gen, results)
    determinism_phase(torch, dev, gen, results)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        probe_phase(torch, dev, gen, results)
    for fn in probe_ops():
        fn.launches = fn.plain_calls = 0
    torch.cuda.empty_cache()
    cfg, model = build(torch, dev)
    launches, clip_ms = main_path(torch, dev, card, cfg, model, results)
    check_probes_idle("the clip inference path")
    e2e, e2e_launches = e2e_phase(torch, dev, card, cfg, model)
    check_probes_idle("the e2e phase")
    train_launches, step_ms, peak_gib = train_path(torch, dev, card, cfg, model)
    check_probes_idle("the clip train path")
    del model
    torch.cuda.empty_cache()
    train_compare(torch, dev)
    torch.cuda.empty_cache()
    coco_cfg, coco_model = build_coco(torch, dev)
    coco_launches, k10_launches, image_ms = coco_infer_path(torch, dev, card, coco_cfg,
                                                            coco_model, results)
    coco_train_launches, coco_step_ms, coco_peak_gib = coco_train_path(
        torch, dev, card, coco_cfg, coco_model)
    del coco_model
    torch.cuda.empty_cache()
    coco_train_compare(torch, dev)
    torch.cuda.empty_cache()
    cli, cli_launches, cli_checks = cli_phase(torch, dev, card)
    torch.cuda.empty_cache()
    swin, swin_launches = swin_phase(torch, dev, card)
    torch.cuda.empty_cache()
    ablations, ablation_launches = ablation_phase(torch, dev, card)
    torch.cuda.empty_cache()
    overfit, overfit_launches = overfit_phase(torch, dev, card)
    torch.cuda.empty_cache()
    ddp, ddp_launches = ddp_phase(torch, dev, card)
    torch.cuda.empty_cache()
    viz, viz_launches = viz_phase(torch, dev, card)
    probe_launches = check_probes_idle("every model path")

    # K1-K4: launches of the clip inference path's 3 clips; K5-K7: of the clip
    # train path's 3 steps (which also launched K1 and K3: `train_launches`);
    # K8: of the COCO inference path's 3 images; K9: of the COCO train path's
    # 3 steps; K10: of the public op's path over one image's six layers
    counts = {"K1": launches["msda_temporal_proj"], "K2": launches["msda_tap_window"],
              "K3": launches["msda_temporal"], "K4": launches["modulated_deform_conv2d"],
              "K5": train_launches["msda_temporal_bwd"], "K6": train_launches["msda_rows"],
              "K7": train_launches["msda_rows_bwd"], "K8": coco_launches["msda_proj"],
              "K9": coco_train_launches["msda_taps_bwd"], "K10": k10_launches,
              "K12a": probe_launches["tent_band"], "K12b": probe_launches["corner_gather"],
              "K12c": probe_launches["mma_probe"]}   # over every model path: 0
    results["K12c"]["sync"]["launches"] = probe_launches["mma_probe_sync"]
    kernels = []
    for key in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10",
                "K12a", "K12b", "K12c"):
        r = results[key]
        bound_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = r["flops"] / r["flop_rate"] * 1e3
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": counts[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": r["library_ms"], "redesigned": key in REDESIGNED,
            "repeat_equal": r.get("repeat_equal"),
            "train_launches": train_launches.get(r["name"], 0),
            "coco_image_launches": coco_launches.get(r["name"], 0),
            "coco_train_launches": coco_train_launches.get(r["name"], 0),
            "e2e_launches": e2e_launches.get(r["name"], 0),
            "cli_launches": cli_launches.get(r["name"], 0),
            "cli_max_abs_err": max((c[key] for c in cli_checks.values() if key in c),
                                   default=None),
            **{f"swin_{path}_launches": n.get(r["name"], 0) for path, n in swin_launches.items()},
            "swin_max_abs_err": max((swin[c][key] for c in ("clip_kernel_errs", "train_kernel_errs",
                                                            "image_kernel_errs")
                                     if key in swin[c]), default=None),
            **{f"{path}_launches": n.get(r["name"], 0) for path, n in ablation_launches.items()},
            "ablation_max_abs_err": max(
                (ablations[k][c][key] for k in ABLATION_CONFIGS
                 for c in ("clip_kernel_errs", "train_kernel_errs") if key in ablations[k].get(c, {})),
                default=None),
            **{f"{path}_launches": n.get(r["name"], 0) for path, n in overfit_launches.items()},
            "overfit_max_abs_err": max((overfit[c][key] for c in ("train_kernel_errs",
                                                                  "eval_kernel_errs")
                                        if key in overfit[c]), default=None),
            "ddp_launches": ddp_launches.get(r["name"], 0),
            "viz_launches": viz_launches.get(r["name"], 0),
            **({"ablation0_w35": ablations["0"]["kernels_w"][key]}
               if key in ablations["0"]["kernels_w"] else {}),
            **{k: r[k] for k in ("device_ms", "determinism",
                                 "coco_shapes", "route_ms", "layers", "op_ms",
                                 "k2_ms", "windows", "lab", "random_refs", "path_inputs",
                                 "script_shape", "shapes", "hmma_in_sass", "max_sm_clock_mhz",
                                 "hgmma_in_sass", "sync", "library_48_ms", "method_floor_ms",
                                 "method_flops", "grid", "raster_ms", "random_ms",
                                 "coco_f1", "breakdown")
               if k in r}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"clip_ms": clip_ms, "fps": STRIDE / clip_ms * 1e3, "card": card}))
    print(json.dumps({"train_step_ms": step_ms, "train_peak_gib": peak_gib, "card": card}))
    print(json.dumps({"coco_image_ms": image_ms, "coco_images_per_s": 1e3 / image_ms,
                      "card": card}))
    print(json.dumps({"coco_train_step_ms": coco_step_ms, "coco_train_peak_gib": coco_peak_gib,
                      "coco_batch": COCO_BATCH, "card": card}))
    print(json.dumps(e2e))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"swin": swin}))
    print(json.dumps({"ablations": ablations}))
    print(json.dumps({"overfit": overfit}))
    print(json.dumps({"ddp": ddp}))
    print(json.dumps({"viz": viz}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
