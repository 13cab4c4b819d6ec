"""Augmented training clips with their ground truth (port of
`devis_tpu/visualize_dataset.py`; reference `visualize_dataset.py`).

    python -m devis_torch.visualize_dataset --config-file cfg.yaml \\
        [--samples N] [--out-dir DIR] [KEY VALUE ...]

A sample of an image dataset (COCO) is drawn as a clip of one frame. Runs on
the host alone: the data pipeline and OpenCV.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    """Writes the renders; returns the paths written, a list a sample."""
    p = argparse.ArgumentParser("visualize-dataset")
    p.add_argument("--config-file", default="")
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--out-dir", default="dataset_viz")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    from .config import get_cfg_defaults
    from .datasets import build_dataset
    from .util.visualization import visualize_dataset_sample

    cfg = get_cfg_defaults()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    dataset, _ = build_dataset("TRAIN", cfg)
    written = []
    for i in range(min(args.samples, len(dataset))):
        sample = dataset[i]
        if "images" not in sample:          # an image dataset: a clip of one frame
            sample = {"images": sample["image"][None], "labels": sample["labels"],
                      "boxes": sample["boxes"][:, None], "masks": sample["masks"][:, None],
                      "valid": sample["valid"][:, None]}
        written.append(visualize_dataset_sample(sample, args.out_dir, idx=i))
        print(f"sample {i}: wrote {len(written[-1])} frames to {args.out_dir}")
    return written


if __name__ == "__main__":
    main()
