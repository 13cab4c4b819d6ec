"""The readings a cell's limits are set from, in one process on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--out FILE] [--leaves FILE] \\
        [--look REGEX --look-seeds 1,2 --look-out PREFIX]

For each seed: the program's first steps, set up as a run sets them up (no
window), and the plain reference's; the compared numbers of the program
(`harness.numbers`), and how many target slots of each step each side
matched to another query (the assignments of every level, in the order
both sides solve them). For each control seed also: the control's numbers,
the reference with every product's operands rounded to float8 (e4m3, scaled
per tensor), the nearest precision below the configuration's bfloat16; and
the same with bfloat16 operands (the configuration's own precision computed
plainly, a second witness beside the program). One JSON line a seed on
standard output and in `--out`; `--leaves` gets every leaf's norms. For
each look seed, `PREFIX.<seed>.pt` gets, for every leaf whose name matches
`--look`, its seeded start and, for each side, AdamW's two moments after
every compared step and the leaf after the last.
"""
import argparse
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


class Assignments:
    """Records each assignment a side solves: its valid rows' columns."""

    def __init__(self, solve):
        self.solve, self.rows = solve, []

    def __call__(self, cost_t):
        cols = self.solve(cost_t)
        valid = (cost_t < 1e5 - 1).any(1)
        self.rows.append(cols[valid].cpu().tolist())
        return cols


def flips(a, b, calls, steps):
    """Target slots matched to different queries in each step (`calls`
    assignments a step)."""
    return [sum(sum(x != y for x, y in zip(ra, rb))
                for ra, rb in zip(a[k * calls:(k + 1) * calls], b[k * calls:(k + 1) * calls]))
            for k in range(steps)]


def keeper(pattern, n, store, side):
    """A `watch` that keeps, for the leaves `pattern` matches, AdamW's
    moments after each step and the leaf after step `n`."""
    rx = re.compile(pattern)

    def watch(k, params, moments):
        for name, p in params.items():
            if rx.search(name) and name in moments:
                for key in ("exp_avg", "exp_avg_sq"):
                    store[f"{side}|{name}|{key}|{k}"] = moments[name][key].detach().float().cpu().clone()
                if k == n:
                    store[f"{side}|{name}|param|{k}"] = p.detach().float().cpu().clone()
    return watch


def main(argv=None) -> int:
    p = argparse.ArgumentParser("perfbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    p.add_argument("--leaves", default="")
    p.add_argument("--look", default="")
    p.add_argument("--look-seeds", default="")
    p.add_argument("--look-out", default="")
    args = p.parse_args(argv)
    import torch
    dev = "cuda"
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    import harness
    from devis_torch.models import matcher as port_matcher
    from reference import train as RT
    log = lambda m: print(m, file=sys.stderr, flush=True)
    harness.build_kernels(dev, log)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    looks = {int(s) for s in args.look_seeds.split(",") if s}
    solve = port_matcher.lsa
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        look = {} if seed in looks else None
        watch = lambda side, n: None if look is None else keeper(args.look, n, look, side)
        wl = harness.load("workloads", args.workload)
        n = wl["compare_steps"]
        su = harness.Setup(args.workload, seed, dev, watch=watch("program", n))
        if look is not None:
            rx = re.compile(args.look)
            look.update({f"start|{k}": p.detach().float().cpu().clone()
                         for k, p in su.model.named_parameters() if rx.search(k)})
        port_matcher.lsa = prog_asg = Assignments(solve)
        try:
            su.first_steps(n)
        finally:
            port_matcher.lsa = solve
        prog = su.program_numbers()
        conf, ds, sd = su.conf, su.ds, su.sd
        su.close()
        a = conf["reference"]
        calls = a["dec_layers"]
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        ref_asg = Assignments(RT.scipy_assign)
        ref = harness.reference_steps(conf, ds, sd, n, dev, assign_fn=ref_asg,
                                      watch=watch("reference", n))
        line = {"seed": seed, "program": harness.numbers(prog, ref),
                "program_s": t_prog, "reference_s": time.perf_counter() - t,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "flips": flips(prog_asg.rows, ref_asg.rows, calls, n),
                "slots": [sum(len(r) for r in ref_asg.rows[k * calls:(k + 1) * calls])
                          for k in range(n)],
                "losses": {"program": prog["losses"], "reference": ref["losses"]},
                "worst": {k: harness.worst_leaves(prog, ref, k) for k in ("grad", "change")}}
        leaves = {"program": prog, "reference": ref}
        if seed in controls:
            for name, dtype in (("control", torch.float8_e4m3fn), ("bf16", torch.bfloat16)):
                asg = Assignments(RT.scipy_assign)
                other = harness.reference_steps(conf, ds, sd, n, dev, dtype=dtype, assign_fn=asg,
                                                watch=watch(name, n))
                line[name] = harness.numbers(other, ref)
                line["losses"][name] = other["losses"]
                line[f"flips_{name}"] = flips(asg.rows, ref_asg.rows, calls, n)
                line[f"worst_{name}"] = {k: harness.worst_leaves(other, ref, k)
                                         for k in ("grad", "change")}
                leaves[name] = other
        if look is not None and args.look_out:
            torch.save(look, f"{args.look_out}.{seed}.pt")
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        if args.leaves:
            with open(args.leaves, "a") as f:
                f.write(json.dumps({"seed": seed, **leaves}) + "\n")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
