"""Device ms a step of the kernels, copies and sets launched inside the
train step's `step.forward` spans (`engine.make_train_step`: the batch to
the card and the model's forward), over the profiled span of CUDA activity
after the window (`progtrace.py`: each activity given to the span open at
the runtime call that launched it, by correlation id)."""
LAYER = "train step (engine.make_train_step)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
PHASE = "step.forward"


def read(ctx):
    import progtrace
    a = progtrace.read_span()
    return progtrace.per_step(a, a["device_ns"][PHASE]) if a.get("steps") else None
