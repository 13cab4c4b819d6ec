"""The decoder's deformable-attention sampling maps (port of
`devis_tpu/visualize_att_maps.py`; reference `visualize_att_maps.py`,
TrackerAttMaps and run_demo).

Runs the DeVIS clip model on the first clip of validation videos with the
decoder's sampling capture on (`models.attention.capture_sampling`), then
draws the top trajectories' sampling points of one decoder layer over the
frames: one merged overlay a (query, frame) and, with `--per-level`, one a
level beside it.

    python -m devis_torch.visualize_att_maps --config-file cfg.yaml \\
        [--videos N] [--queries K] [--layer I] [--per-level] [--out-dir DIR] \\
        [--device cpu] [KEY VALUE ...]

It runs on the GPU (K1-K4), and raises without one unless `--device cpu`
asks for the CPU. The network sees the clip as the tracker feeds it
(`inference.VISInferFn`: the canvas of `make_eval_buckets`, the frames
normalized on the device); the overlays are drawn on the raw frames.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser("visualize-att-maps")
    p.add_argument("--config-file", default="")
    p.add_argument("--videos", type=int, default=1)
    p.add_argument("--queries", type=int, default=3)
    p.add_argument("--layer", type=int, default=-1)
    p.add_argument("--per-level", action="store_true",
                   help="also write one overlay per resolution level (reference "
                        "att_maps_viz.py:208-818 per-level mode) beside the merged one")
    p.add_argument("--out-dir", default="att_maps_viz")
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU; by default the GPU, which must exist")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    """Writes the overlays; returns {video_id: dict(loc, att, queries,
    paths)}: the drawn layer's captured current-frame locations
    (T, Lq, M, L, P, 2) and weights (T, Lq, M, L, P) as numpy f32, the top
    queries and the files written."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from .config import get_cfg_defaults
    from .datasets import build_dataset, pick_canvas
    from .inference import IMAGENET_MEAN, IMAGENET_STD, make_eval_buckets
    from .main import load_initial_weights
    from .models import build_model
    from .models.attention import capture_sampling
    from .util.misc import resolve_device
    from .util.visualization import decoder_attention, render_sampling_points, write_rgb

    device = resolve_device(args.device)
    cfg = get_cfg_defaults()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    if cfg.DATASETS.TYPE != "vis":
        raise ValueError("attention maps are a VIS-mode tool")

    dataset, num_classes = build_dataset("VAL", cfg)
    model = build_model(num_classes, cfg, device=device, seed=cfg.SEED)
    load_initial_weights(cfg, model)
    model.eval()
    T = cfg.MODEL.DEVIS.NUM_FRAMES
    buckets = make_eval_buckets(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    out = {}
    for vi in range(min(args.videos, len(dataset))):
        video = dataset[vi]
        frames = video.load_clip(0)                      # (T, h, w, 3) uint8
        h, w = frames.shape[1:3]
        Hc, Wc = pick_canvas(h, w, buckets)
        images = np.zeros((T, Hc, Wc, 3), np.uint8)
        images[:, :h, :w] = frames
        pad = np.ones((T, Hc, Wc), bool)
        pad[:, :h, :w] = False
        x = (torch.from_numpy(images).to(device).float() / 255.0 - mean) / std
        with torch.inference_mode(), capture_sampling(model) as records:
            _, res = model(x, torch.from_numpy(pad).to(device))
        loc, att = decoder_attention(records, layer=args.layer)
        top_queries = res["query_top_k_indexes"].cpu().numpy()[:args.queries]
        paths = []
        n_levels = loc.shape[3]
        for qi, q in enumerate(top_queries):
            for t in range(T):
                img = frames[t]
                targets = [(None, f"v{video.video_id}_q{qi}_t{t}.jpg")]
                if args.per_level:
                    targets += [(lvl, f"v{video.video_id}_q{qi}_t{t}_lvl{lvl}.jpg")
                                for lvl in range(n_levels)]
                for lvl, name in targets:
                    paths.append(os.path.join(args.out_dir, name))
                    write_rgb(paths[-1], render_sampling_points(img, loc, att, int(q), t,
                                                                level=lvl))
        out[video.video_id] = dict(loc=loc, att=att, queries=top_queries, paths=paths)
        print(f"video {video.video_id}: wrote attention maps for {len(top_queries)} queries "
              f"to {args.out_dir}")
    return out


if __name__ == "__main__":
    main()
