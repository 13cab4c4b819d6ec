"""Host ms a batch that `TrainLoader`'s thread spends building it (its
`loader.batch` spans: the samples, the canvas, `collate_clip` /
`collate_images`), over the profiled span after the window."""
LAYER = "input (datasets.TrainLoader, collate_clip / collate_images)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "train_frames_per_s"


def read(ctx):
    import progtrace
    a = progtrace.read_span()
    return a["loader_ns"] / 1e6 / a["loader_batches"] if a.get("loader_batches") else None
