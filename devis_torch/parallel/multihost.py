"""Gathering evaluation results over ranks (port of
`devis_tpu/parallel/multihost.py`).

The reference gathers per-rank prediction lists with pickle over NCCL
(`src/util/misc.py:85-125`) and drops the videos that the padded sampler gave
to more than one rank (`accumulate_results`, `misc.py:129-139`).
"""
from __future__ import annotations

from typing import Dict, List

import torch.distributed as dist

from .mesh import is_distributed, world_size


def all_gather_objects(obj) -> List:
    """Every rank's picklable `obj`, in rank order."""
    if not is_distributed():
        return [obj]
    out: List = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def accumulate_results(per_process_results: List[List[Dict]]) -> List[Dict]:
    """Merges per-rank tracker outputs, keeping for each video id the
    records of the FIRST rank that has it (the sampler pads videos over
    ranks, reference misc.py:129-139)."""
    seen = set()
    merged: List[Dict] = []
    for records in per_process_results:
        fresh = {r["video_id"] for r in records} - seen
        merged.extend(r for r in records if r["video_id"] in fresh)
        seen |= fresh
    return merged
