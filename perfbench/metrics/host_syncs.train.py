"""Runtime calls a step that block the host until the device has caught up
(`cudaStreamSynchronize`, `cudaDeviceSynchronize`, `cudaEventSynchronize`,
synchronous `cudaMemcpy`), inside the loop's spans (`loop.step`,
`loop.metrics_read`), over the profiled span of CUDA activity after the
window; the harness's own synchronisations lie outside them."""
LAYER = "train loop (engine.train_one_epoch)"
UNIT = "count"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"


def read(ctx):
    import progtrace
    a = progtrace.read_span()
    return sum(a["syncs"].values()) / a["steps"] if a.get("steps") else None
