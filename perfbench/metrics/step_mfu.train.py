"""The training step's share of the card's bf16 peak: the model FLOPs of
every step completed in the window (`counts/flops.py`, each item at its
content size) over the window's seconds times 989 TFLOP/s (bf16 dense,
H100 SXM, at its 700 W limit; the run prints the card's limit beside it)."""
LAYER = "train step (engine.make_train_step)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_frames_per_s"
PEAK_FLOPS = 989e12


def read(ctx):
    steps = ctx["window_steps"]
    if not steps or ctx["window_s"] <= 0:
        return None
    flops = sum(ctx["step_flops"].step(s["sizes"]) for s in steps)
    return 100.0 * flops / (ctx["window_s"] * PEAK_FLOPS)
