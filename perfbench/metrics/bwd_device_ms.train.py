"""Device ms a step of the work launched inside the `step.backward` spans
(autograd's device thread launches it while the loop waits in
`.backward()`), as `fwd_device_ms.train`."""
LAYER = "train step (engine.make_train_step)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
PHASE = "step.backward"


def read(ctx):
    import progtrace
    a = progtrace.read_span()
    return progtrace.per_step(a, a["device_ns"][PHASE]) if a.get("steps") else None
