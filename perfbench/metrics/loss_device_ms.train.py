"""Device ms a step of the work launched inside the `step.loss` spans (the
matcher's cost, the host LSA's copies, the losses and their weighted
total), as `fwd_device_ms.train`."""
LAYER = "train step (engine.make_train_step)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
PHASE = "step.loss"


def read(ctx):
    import progtrace
    a = progtrace.read_span()
    return progtrace.per_step(a, a["device_ns"][PHASE]) if a.get("steps") else None
