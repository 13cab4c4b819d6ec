"""The deformable-attention backward ops' share of their roofline over the
profiled span: the sum of each call's least time (`counts/msda.py`, from
the configuration and the collated canvas) over the device time of the
ops' kernels, found by these name tags."""
LAYER = "deformable-attention backward, K5, K7, K9 (ops/ms_deform_attn_cuda.py, csrc/msda_bwd.cuh)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
DIRECTION = "bwd"
TAGS = ("k5_bwd", "k7_bwd", "k9_bwd")


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    dev = sum(e - s for n, s, e in tr["kernels"] if any(t in n.lower() for t in TAGS)) / 1e9
    bound = sum(c["bound_s"] for c in ctx["traced_calls"] if c["dir"] == DIRECTION)
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
