"""The deformable-attention backward ops' share of their roofline over the
profiled span, as `msda_fwd_op_roofline.train`, through the outermost
backward op spans (`msda.K5_temporal_bwd`, `msda.K7_rows_bwd`,
`msda.K9_taps_bwd`)."""
LAYER = "deformable-attention backward, K5, K7, K9 (ops/ms_deform_attn_cuda.py, csrc/msda_bwd.cuh)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
DIRECTION = "bwd"


def read(ctx):
    import progtrace
    a = progtrace.read_span()
    dev = a["op_ns"][DIRECTION] / 1e9 if a.get("steps") else 0.0
    bound = sum(c["bound_s"] for c in ctx["traced_calls"] if c["dir"] == DIRECTION)
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
