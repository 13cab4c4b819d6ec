"""The deformable-attention forward ops' share of their roofline over the
profiled span: the sum of each call's least time (`counts/msda.py`) over
the device time of everything launched inside the outermost forward op
spans (`msda.K1_temporal_proj` with K2 inside it, `msda.K3_temporal`,
`msda.K6_rows`, `msda.K8_proj`: each op's glue included), found through
the program's spans rather than kernel names."""
LAYER = "deformable-attention forward, K1, K2, K3, K6, K8 (ops/ms_deform_attn_cuda.py, csrc/ms_deform_attn*.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
DIRECTION = "fwd"


def read(ctx):
    import progtrace
    a = progtrace.read_span()
    dev = a["op_ns"][DIRECTION] / 1e9 if a.get("steps") else 0.0
    bound = sum(c["bound_s"] for c in ctx["traced_calls"] if c["dir"] == DIRECTION)
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
