"""The 95th percentile, in ms, of the intervals between successive batch
requests of the epoch loop over the traced window: a step, its metrics
read and its wait for the next batch."""
import statistics

LAYER = "train loop (engine.train_one_epoch)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "train_frames_per_s"


def read(ctx):
    t = [s["request_t"] for s in ctx["window_steps"]] + [ctx["window_end_t"]]
    gaps = [b - a for a, b in zip(t[:-1], t[1:])]
    if len(gaps) < 2:
        return None
    return 1e3 * statistics.quantiles(gaps, n=20, method="inclusive")[18]
