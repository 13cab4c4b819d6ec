"""The device's idle share of a step of the unprofiled window: 100 x (1 -
the union of device activity a step, over a profiled span of CUDA activity
alone, / the window's mean step time on the host clock). The profiler
itself slows a host-bound step, so the span's own wall time would read the
device idler than the timed loop leaves it."""
LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"


def read(ctx):
    tr, n_traced, steps = ctx.get("trace"), ctx.get("traced_steps", 0), ctx["window_steps"]
    if not tr or tr["busy_s"] <= 0 or not n_traced or not steps or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - (tr["busy_s"] / n_traced) / (ctx["window_s"] / len(steps)))
