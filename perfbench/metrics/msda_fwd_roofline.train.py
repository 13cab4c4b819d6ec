"""The deformable-attention forward ops' share of their roofline over the
profiled span, as `msda_bwd_roofline.train` (K2 counts with K1, whose
windows it builds)."""
LAYER = "deformable-attention forward, K1, K2, K3, K6, K8 (ops/ms_deform_attn_cuda.py, csrc/ms_deform_attn*.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
DIRECTION = "fwd"
TAGS = ("msda_temporal_proj_win_kernel", "msda_tap_window_kernel", "msda_temporal_kernel",
        "msda_rows_kernel", "msda_proj_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    dev = sum(e - s for n, s, e in tr["kernels"] if any(t in n.lower() for t in TAGS)) / 1e9
    bound = sum(c["bound_s"] for c in ctx["traced_calls"] if c["dir"] == DIRECTION)
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
