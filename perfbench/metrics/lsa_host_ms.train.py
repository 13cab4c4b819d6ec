"""Host ms a step in the matcher's assignment (`ops/hungarian.lsa`): its
`matcher.lsa` spans less their `matcher.lsa.wait` (the blocking copy of
the cost to the host), over the profiled span after the window."""
LAYER = "matcher and loss (models/matcher.py, ops/hungarian.py, models/criterion.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "train_frames_per_s"


def read(ctx):
    import progtrace
    a = progtrace.read_span()
    return progtrace.per_step(a, a["lsa_host_ns"]) if a.get("lsa_calls") else None
