"""The training entry: the CLI's own loader and `engine.train_one_epoch`
over the cell's traffic, compared with the plain reference (`harness.run`).
An entry module is named by a cell's `entry` and gives `run(cell, seed,
seconds, trace, device, t_start, log)`, which returns the result line's
object with `checks` last."""
from harness import run  # noqa: F401
