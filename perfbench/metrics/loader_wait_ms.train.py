"""The mean wait a step, in ms, of the epoch loop for its next batch
(`TrainLoader`'s thread, `collate_clip` / `collate_images`), timed around
each `next()` by the harness's feed over the traced window."""
LAYER = "input (datasets.TrainLoader, collate_clip / collate_images)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "train_frames_per_s"


def read(ctx):
    waits = [s["wait_s"] for s in ctx["window_steps"]]
    return 1e3 * sum(waits) / len(waits) if waits else None
