"""Device ms a step of the work launched inside the `step.update` spans
(the finite check, the global norm, the clip and AdamW), as
`fwd_device_ms.train`."""
LAYER = "train step (engine.make_train_step)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
PHASE = "step.update"


def read(ctx):
    import progtrace
    a = progtrace.read_span()
    return progtrace.per_step(a, a["device_ns"][PHASE]) if a.get("steps") else None
