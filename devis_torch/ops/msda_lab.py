"""The encoder kernel lab: K1's cost-isolation variants and capacity plans.

The port's counterpart of `benchmarks/kernel_lab.py`, the JAX package's
harness for finding what bounds the encoder kernel. It is a measurement
tool: no model path calls it. Every variant is K1 (`csrc/ms_deform_attn.cu`)
compiled with another `MODE`, on windows that K2 (`msda_tap_window`)
computed, with per-level staging capacities from `window_plan`:

  full      the path's kernel (`kernel_lab.py` `base`)
  nostage   no window: every corner is read from global memory; equals
            `full` bit for bit, so the difference in time is what the
            window buys
  noloc     fixed dummy taps and weights: no location or softmax math
            (`noentries`)
  nogather  no staging and no corner reads; the tap math and the
            accumulation stay (`nowbuild`)
  noacc     corners read but not accumulated (`nomxu`)
  count     `full`, counting the corners read from global memory in windows
            that fit their capacity (must be 0) and in windows that do not

`kernel_lab.py`'s `_ranges_kernel_ml` and `_kernel_ml` (one static window
size per level) are K2 and `full` under another `window_plan`
(`blocks_per_sm`). Its `batched` variant has no counterpart: K1 already
computes each stage's taps in one pass over (query, point).

On the CPU `lab_temporal_proj` runs the windowed plain version for the
modes that compute K1's function (`full`, `nostage`, `count`) and raises
for the others, which have no plain version.
"""
from __future__ import annotations

from . import ms_deform_attn_cuda as K

MODES = K.K1_MODES


def lab_temporal_proj(value, spatial_shapes, ref, c_off, t_off, c_logit, t_logit,
                      rule, windows, plan, mode: str = "full"):
    """K1 in `mode` on K2's `windows` with per-level capacities `plan`.
    Returns (out, reads); reads is the `count` mode's pair of counters (the
    windowed plain version's on the CPU), else None."""
    if mode not in MODES:
        raise ValueError(f"lab mode {mode!r} is not one of {MODES}")
    spatial_shapes = K.normalize_shapes(spatial_shapes)
    if not value.is_cuda:
        if mode not in ("full", "nostage", "count"):
            raise ValueError(f"lab mode {mode!r} runs only on a CUDA device")
        lab_temporal_proj.plain_calls += 1
        caps = (0,) * len(spatial_shapes) if mode == "nostage" else plan
        out, reads = K.msda_temporal_proj_windowed_plain(
            value, spatial_shapes, ref, c_off, t_off, c_logit, t_logit, rule, windows, caps)
        return out, reads if mode == "count" else None
    out = K.launch_k1(value, spatial_shapes, ref, c_off, t_off, c_logit, t_logit, rule,
                      windows, plan, mode)
    lab_temporal_proj.launches += 1
    return out


lab_temporal_proj.launches = 0
lab_temporal_proj.plain_calls = 0
