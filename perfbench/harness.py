"""One run of one cell of the port's benchmark (see `run.py`).

A cell is `workloads/<cell>.json`: its configuration (`configs/<name>.json`),
its traffic (`traffic/<name>.json`), its entry (`entries/<entry>.py`; this
module is the training entry's), the steps set-up takes and compares, the
steps each traced span covers, each op's kernel launches a step and the
limits of the comparison. Set-up builds the CLI's own objects:
`devis_torch.main.build_train_loader` over the traffic's in-memory dataset,
the model of `devis_torch.models.build_model` with the seed's weights
(`weights.py`), `engine.create_train_state` and `engine.make_train_step`;
it drives that one state through its first steps with
`engine.train_one_epoch`, noting what the comparison reads; the window then
runs `train_one_epoch` on the same state and feed until its seconds are up.
Afterwards the plain reference (`reference/`) follows the first steps from
the same seed and `judge` holds the program's numbers to it.
"""
from __future__ import annotations

import ast
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
for p in (HERE, CHECKOUT):
    if p not in sys.path:
        sys.path.insert(0, p)

import devtrace                                   # noqa: E402
import weights                                    # noqa: E402
from counts import msda                           # noqa: E402
from counts.flops import StepFlops                # noqa: E402
from reference import model as RM                 # noqa: E402
from reference import train as RT                 # noqa: E402
from traffic import generate                      # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "devis_tpu")
BETA1 = 0.9


def load(kind: str, name: str) -> Dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def manifest() -> Dict:
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def seeds(seed: int) -> Dict[str, int]:
    """Independent streams of one `--seed`: weights, dropout, the traffic's
    content and the loader's shuffle (numpy's RandomState takes 32 bits)."""
    w, d, x = np.random.SeedSequence(int(seed)).generate_state(3, dtype=np.uint64)
    shuffle = int(np.random.SeedSequence([int(seed), 7]).generate_state(1)[0] >> 1)
    return {"weights": int(w >> np.uint64(1)), "dropout": int(d >> np.uint64(1)),
            "data": int(x >> np.uint64(1)), "shuffle": shuffle}


# ---------------------------------------------------------------------------
# the program's objects
# ---------------------------------------------------------------------------

def port_cfg(conf: Dict, shuffle_seed: int):
    from devis_torch.config import get_cfg_defaults
    cfg = get_cfg_defaults()
    cfg.merge_from_other_cfg(conf["cfg"])
    cfg.SEED = shuffle_seed
    cfg.freeze()
    check_cfg(cfg, conf)
    return cfg


def check_cfg(cfg, conf: Dict) -> None:
    """The configuration the program runs is the one the reference states."""
    from devis_torch.main import TRAIN_SCALES
    a, s = conf["reference"], conf["reference"]["solver"]
    m, t, ls = cfg.MODEL, cfg.MODEL.TRANSFORMER, cfg.MODEL.LOSS
    pairs = {
        "kind": "clip" if cfg.DATASETS.TYPE == "vis" else cfg.DATASETS.TYPE,
        "hidden_dim": m.HIDDEN_DIM, "heads": t.N_HEADS, "levels": m.NUM_FEATURE_LEVELS,
        "enc_layers": t.ENCODER_LAYERS, "dec_layers": t.DECODER_LAYERS,
        "enc_points": t.ENC_N_POINTS, "dec_points": t.DEC_N_POINTS,
        "dim_feedforward": m.DIM_FEEDFORWARD, "dropout": m.DROPOUT,
        "num_queries": m.NUM_QUERIES, "bbx_gradient_prop": m.BBX_GRADIENT_PROP,
        "focal_alpha": ls.FOCAL_ALPHA, "cost_class": m.MATCHER.CLASS_COST,
        "cost_bbox": m.MATCHER.BBX_L1_COST, "cost_giou": m.MATCHER.BBX_GIOU_COST,
        "use_sum_l1": m.MATCHER.USE_SUM_L1_DISTANCE, "class_coef": ls.CLASS_COEF,
        "bbx_l1_coef": ls.BBX_L1_COEF, "bbx_giou_coef": ls.BBX_GIOU_COEF,
        "segm_mask_coef": ls.SEGM_MASK_COEF, "segm_dice_coef": ls.SEGM_DICE_COEF,
        "aux_loss_weighting": ls.AUX_LOSS_WEIGHTING, "mask_aux_loss": list(ls.MASK_AUX_LOSS),
        "batch_size": cfg.SOLVER.BATCH_SIZE,
        "train_scales": [int(cfg.INPUT.SCALE_FACTOR_TRAIN * x) for x in TRAIN_SCALES],
        "max_size": int(cfg.INPUT.SCALE_FACTOR_TRAIN * 1333),
        "slots": min(cfg.TPU.MAX_INSTANCES, m.NUM_QUERIES // cfg.MODEL.DEVIS.NUM_FRAMES),
        "num_frames": cfg.MODEL.DEVIS.NUM_FRAMES,
    }
    solver = {"base_lr": cfg.SOLVER.BASE_LR, "lr_backbone": cfg.SOLVER.LR_BACKBONE,
              "frozen_params": list(cfg.SOLVER.FROZEN_PARAMS),
              "backbone_names": list(cfg.SOLVER.BACKBONE_NAMES),
              "linear_proj_names": list(cfg.SOLVER.LR_LINEAR_PROJ_NAMES),
              "lr_linear_proj_mult": cfg.SOLVER.LR_LINEAR_PROJ_MULT,
              "mask_head_names": list(cfg.SOLVER.LR_MASK_HEAD_NAMES),
              "lr_mask_head_mult": cfg.SOLVER.LR_MASK_HEAD_MULT,
              "temporal_linear_proj_names": list(cfg.SOLVER.DEVIS.LR_TEMPORAL_LINEAR_PROJ_NAMES),
              "lr_temporal_linear_proj_mult": cfg.SOLVER.DEVIS.LR_TEMPORAL_LINEAR_PROJ_MULT,
              "weight_decay": cfg.SOLVER.WEIGHT_DECAY,
              "grad_clip_max_norm": cfg.SOLVER.GRAD_CLIP_MAX_NORM,
              "steps": list(cfg.SOLVER.STEPS), "gamma": cfg.SOLVER.GAMMA}
    bad = [k for k, v in pairs.items() if a[k] != v]
    bad += [f"solver.{k}" for k, v in solver.items() if s[k] != v]
    if a["num_logits"] != conf["num_classes"] or cfg.TPU.COMPUTE_DTYPE != "bfloat16" \
            or not m.WITH_BBX_REFINE or not m.MASK_ON or not m.MASK_HEAD.USE_MDC:
        bad.append("num_logits / compute dtype / box refinement / mask head")
    if bad:
        raise ValueError(f"the configuration the program runs differs from the reference's: {bad}")


def build_program(conf: Dict, cfg, device, weight_seed: int):
    """The port's model on `device` with the seed's weights: built on the
    meta device (no initialisation), materialised, then filled."""
    from devis_torch.models import build_model
    with torch.device("meta"):
        model = build_model(conf["num_classes"], cfg, device="meta", seed=0)
    model = model.to_empty(device=device)
    weights.fill(weights.named_tensors(model), conf["init"], weight_seed)
    return model


class Feed:
    """The loader as `train_one_epoch` reads it: each `next()` timed, with
    the batch's canvas and content sizes noted; `take(n)` yields n batches,
    `until(deadline)` yields while the clock is before it, calls
    `on_window_end`, then, for each (profiler span, n, annotate) it is
    given, n more batches with that span on (`annotate`: the harness's own
    `bench.*` ranges too)."""

    def __init__(self, loader, frames_per_item: int):
        self.it = iter(loader)
        self.frames_per_item = frames_per_item
        self.annotate = False
        self.steps: List[Dict] = []
        self.end_t: Optional[float] = None
        self.on_window_end = None

    def _next(self, phase: str) -> Dict:
        t = time.perf_counter()
        with torch.profiler.record_function("bench.loader_wait") if self.annotate else nullcontext():
            batch = next(self.it)
        sizes = [tuple(int(v) for v in hw) for hw in np.asarray(batch["sizes"]).reshape(-1, 2)]
        self.steps.append(dict(phase=phase, request_t=t, wait_s=time.perf_counter() - t,
                               canvas=tuple(int(v) for v in batch["images"].shape[-3:-1]),
                               items=len(sizes), sizes=sizes,
                               frames=len(sizes) * self.frames_per_item))
        return batch

    def take(self, n: int):
        for _ in range(n):
            yield self._next("setup")

    def until(self, deadline: float, spans=()):
        while time.perf_counter() < deadline:
            yield self._next("window")
        self.end_t = time.perf_counter()
        if self.on_window_end is not None:
            self.on_window_end()
        for span, n, annotate in spans:
            self.annotate = annotate
            span.start()
            for _ in range(n):
                yield self._next(span.name)
            span.stop()
        self.annotate = False

    def close(self) -> None:
        self.it.close()


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    norms = torch._foreach_norm([tensors[n].float() for n in names])
    return dict(zip(names, torch.stack(norms).cpu().tolist()))


def kernel_ops(names) -> Dict:
    """The port's op wrappers by `module.function` under `devis_torch.ops`."""
    out = {}
    for name in names:
        mod, fn = name.rsplit(".", 1)
        out[name] = getattr(importlib.import_module("devis_torch.ops." + mod), fn)
    return out


def reset_counts(ops: Dict) -> None:
    for fn in ops.values():
        fn.plain_calls = 0
        if hasattr(fn, "launches"):
            fn.launches = 0


def counts(ops: Dict) -> Dict:
    """Each op's (kernel launches, or None where it has no counter of its
    own; calls of its plain version)."""
    return {n: (getattr(fn, "launches", None), fn.plain_calls) for n, fn in ops.items()}


def launch_checks(got: Dict, per_step: Dict, steps: int) -> Dict[str, List[float]]:
    """`plain_calls`: the plain versions' calls over the window; `launch_gap`:
    how far each op's kernel launches lie from `per_step` times the
    window's steps, summed. Both have to be 0 on the card."""
    plain = sum(p for _, p in got.values())
    gap = sum(abs(n_launch - per_step[n] * steps) for n, (n_launch, _) in got.items()
              if per_step[n] is not None)
    return {"plain_calls": [float(plain), 0.0], "launch_gap": [float(gap), 0.0]}


class Recorder:
    """Wraps the step through set-up: each step's loss; after the first, the
    gradient each trained parameter gave the optimizer (AdamW's first moment
    after one step is (1 - beta1) times it); after `compare` steps, each
    parameter's change from its seeded start."""

    def __init__(self, step_fn, model, conf: Dict, weight_seed: int, compare: int, watch=None):
        self.step_fn, self.model, self.conf = step_fn, model, conf
        self.weight_seed, self.compare, self.watch = weight_seed, compare, watch
        self.losses: List[float] = []
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}

    def __call__(self, state, batch, generator=None):
        state, metrics = self.step_fn(state, batch, generator)
        self.losses.append(float(metrics["loss"]))
        k = len(self.losses)
        params = dict(self.model.named_parameters())
        if k == 1:
            by_id = {id(p): n for n, p in params.items()}
            moments = {by_id[id(p)]: st["exp_avg"] for p, st in state.optimizer.state.items()}
            self.grad = {n: v / (1 - BETA1) for n, v in leaf_norms(moments).items()}
        if k == self.compare:
            start = [(n, torch.empty_like(t)) for n, t in weights.named_tensors(self.model)]
            weights.fill(start, self.conf["init"], self.weight_seed)
            start = dict(start)
            with torch.no_grad():
                self.change = leaf_norms({n: p - start[n] for n, p in params.items()})
            del start
        if self.watch is not None and k <= self.compare:
            by_id = {id(p): n for n, p in params.items()}
            self.watch(k, params, {by_id[id(p)]: st for p, st in state.optimizer.state.items()})
        return state, metrics


# ---------------------------------------------------------------------------
# the reference and the comparison
# ---------------------------------------------------------------------------

def reference_steps(conf: Dict, ds, sd: Dict, n: int, device, dtype=torch.float32,
                    assign_fn=RT.scipy_assign, watch=None) -> Dict:
    """The plain reference's first `n` steps from the seed: losses, the
    first gradient of each trained parameter (clipped, as AdamW gets it) and
    each parameter's change after `n` steps. `dtype` below float32 rounds
    every product's operands (the control). `watch(k, params, moments)`, if
    given, sees the parameters and AdamW's moments after step k."""
    a = conf["reference"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = RM.build(a, device, RT.quantizer(dtype))
    weights.fill(weights.named_tensors(model), conf["init"], sd["weights"])
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    model.train()
    RM.set_dropout_generator(model, torch.Generator(device=device).manual_seed(sd["dropout"]))
    opt = RT.AdamW(model, a)
    order = RT.epoch_order(len(ds), a["batch_size"], sd["shuffle"])
    out = {"losses": [], "grad": {}, "change": {}}
    for k in range(n):
        items = RT.collate([ds[int(i)] for i in order[k]], a["slots"], a["train_scales"],
                           a["max_size"])
        model.zero_grad(set_to_none=True)
        out["losses"].append(float(RT.batch_loss(model, items, a, device, assign_fn)))
        opt.step()
        if k == 0:
            out["grad"] = {m: v / (1 - BETA1) for m, v in leaf_norms(opt.m).items()}
        if watch is not None:
            watch(k + 1, dict(model.named_parameters()),
                  {m: {"exp_avg": opt.m[m], "exp_avg_sq": opt.v[m]} for m in opt.m})
    with torch.no_grad():
        out["change"] = leaf_norms({m: p - start[m] for m, p in model.named_parameters()})
    return out


def judge(prog: Dict, ref: Dict, limits: Dict[str, float]) -> Dict[str, List[float]]:
    """The numbers the cell compares (those `limits` names), each with its
    limit."""
    got = numbers(prog, ref)
    return {k: [got[k], lim] for k, lim in limits.items()}


def worst_leaves(prog: Dict, ref: Dict, key: str, top: int = 5) -> List[List]:
    """The leaves that read the widest gaps of `key` ("grad" or "change"):
    [name, gap over the larger of its and the median leaf's norm, the
    program's norm, the reference's norm]."""
    med = statistics.median(ref[key].values())
    rows = [[n, abs(prog[key].get(n, 0.0) - r) / max(r, med), prog[key].get(n, 0.0), r]
            for n, r in ref[key].items()]
    return sorted(rows, key=lambda x: -x[1])[:top]


def leaf_gaps(prog: Dict, ref: Dict, key: str, names: List[str],
              scale: float = 1.0) -> List[float]:
    """Each leaf's gap between the program's norm of `key`, times `scale`,
    and the reference's, over the larger of the reference's norm of that
    leaf and of the median leaf."""
    med = statistics.median(ref[key][n] for n in names)
    return [abs(scale * prog[key].get(n, 0.0) - ref[key][n]) / max(ref[key][n], med)
            for n in names]


def clip_scale(prog: Dict, ref: Dict, names: List[str]) -> float:
    """The median over leaves of the reference's first-gradient norm over
    the program's: the ratio of the two sides' clip factors (every step
    clips, so one leaf's gradient moves every leaf's by the global norm).
    1 where the program holds no gradient."""
    ratios = [ref["grad"][n] / prog["grad"][n] for n in names if prog["grad"].get(n, 0.0) > 0]
    return statistics.median(ratios) if ratios else 1.0


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a run can compare: each step's loss gap relative to the
    reference's loss; the first gradient's gap by the worst leaf and by the
    leaf at the 95th percentile, and at the 75th percentile with the clip
    factor's ratio taken out (`clip_scale`); the change's by the worst leaf
    and by the median leaf (`leaf_gaps`). The change leaves out leaves whose first
    gradient in the reference is under a thousandth of the median leaf's
    (they move by round-off alone). Which of them a cell compares, and the
    readings its limits were set from, is in PERF.md."""
    out = {}
    for k, (p, r) in enumerate(zip(prog["losses"], ref["losses"])):
        out[f"loss_{k + 1}"] = abs(p - r) / abs(r)
    names = sorted(ref["grad"])
    g_med = statistics.median(ref["grad"][n] for n in names)
    moved = [n for n in names if ref["grad"][n] >= 1e-3 * g_med]
    n = len(ref["losses"])
    g, c = leaf_gaps(prog, ref, "grad", names), leaf_gaps(prog, ref, "change", moved)
    out.update({"grad_1": max(g), f"change_{n}": max(c),
                "grad_q95_1": float(np.quantile(g, 0.95)),
                "grad_shape_q75_1": float(np.quantile(
                    leaf_gaps(prog, ref, "grad", names, clip_scale(prog, ref, names)), 0.75)),
                f"change_median_{n}": statistics.median(c)})
    return out


def isolation_findings() -> List[str]:
    """Loaded modules whose top-level name is banned; for the reference's
    modules also the program's package, by their imports and globals."""
    found = sorted({m for m in sys.modules if m.split(".")[0] in BANNED})
    ref_dir = os.path.join(HERE, "reference")     # HERE is read at call time
    for fn in sorted(os.listdir(ref_dir)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, fn)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for n in names:
                if n.split(".")[0] in BANNED + ("devis_torch",):
                    found.append(f"reference/{fn} imports {n}")
    for mod in (RM, RT):
        for v in vars(mod).values():
            name = getattr(v, "__module__", None) or getattr(v, "__name__", "")
            if isinstance(name, str) and name.split(".")[0] in BANNED + ("devis_torch",):
                found.append(f"{mod.__name__} holds {name}")
    return found


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def per_layer_readers(cell: str, reported: List[str]) -> Dict:
    """The per-layer metrics of BENCHMARK.json that this cell reports: those
    listing it, or listing no cells and moving a metric it reports."""
    out = {}
    for m in manifest()["per_layer"]:
        if cell in m.get("workloads", [cell] if m["moves"] in reported else []):
            spec = importlib.util.spec_from_file_location(
                "metric_" + m["name"].replace(".", "_"),
                os.path.join(HERE, "metrics", m["name"] + ".py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out[m["name"]] = mod
    return out


def end_to_end_names(cell: str) -> List[str]:
    return [m["name"] for m in manifest()["end_to_end"]
            if cell in m.get("workloads", [cell])]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

class Setup:
    """The program's objects of one run, built from the seed: loader,
    model, train state, step, dropout generator, the timed feed and the
    recorder of the first steps."""

    def __init__(self, cell: str, seed: int, device, watch=None):
        from devis_torch import engine
        from devis_torch.main import build_train_loader
        self.engine = engine
        self.device = torch.device(device)
        self.wl = load("workloads", cell)
        self.conf = load("configs", self.wl["config"])
        self.traffic = generate.load(self.wl["traffic"])
        self.sd = seeds(seed)
        cfg = port_cfg(self.conf, self.sd["shuffle"])
        self.ds = generate.Dataset(self.traffic, self.sd["data"])
        loader = build_train_loader(cfg, self.ds)
        self.ds.assign(loader.batch_indices())
        t = time.perf_counter()
        self.ds.fill()
        self.fill_s = time.perf_counter() - t
        self.model = build_program(self.conf, cfg, self.device, self.sd["weights"])
        self.state = engine.create_train_state(cfg, self.model, len(loader))
        self.step_fn = engine.make_train_step(self.model, cfg)
        self.gen = torch.Generator(device=self.device).manual_seed(self.sd["dropout"])
        a = self.conf["reference"]
        self.feed = Feed(loader, a["num_frames"])
        self.rec = Recorder(self.step_fn, self.model, self.conf, self.sd["weights"],
                            self.wl["compare_steps"], watch)

    def first_steps(self, n: int) -> None:
        """The first `n` steps through `train_one_epoch`, recorded."""
        self.engine.train_one_epoch(self.rec, self.state, self.feed.take(n), generator=self.gen,
                                    print_freq=10 ** 9)

    def program_numbers(self) -> Dict:
        return {"losses": self.rec.losses[:self.wl["compare_steps"]], "grad": self.rec.grad,
                "change": self.rec.change}

    def close(self) -> None:
        """Stops the loader and frees the program's state."""
        self.feed.close()
        for k in ("rec", "step_fn", "state", "model", "feed"):
            setattr(self, k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def build_kernels(device, log) -> None:
    if torch.device(device).type == "cuda":
        from devis_torch.ops import _build
        t = time.perf_counter()
        _build.build_all()
        log(f"kernels ready in {time.perf_counter() - t:.3f} s")


def run(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: Optional[float] = None, log=print) -> Dict:
    """One run of `cell` (module docstring). Returns the result line's
    object; `log` gets the lines for standard error. On the card the
    port's op wrappers' counters are read over the window: every
    deformable-attention op has to launch its kernel as often as the cell
    states and no plain version may run. With `trace`, after the window a
    span of CUDA activity alone gives the device's busy time, the kernels'
    time and the rooflines; a short span with the host's operations too
    names the longest idle gaps."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    build_kernels(device, log)
    su = Setup(cell, seed, device)
    log(f"traffic drawn in {su.fill_s:.3f} s")
    wl, conf = su.wl, su.conf
    on_card = device.type == "cuda"
    ops = kernel_ops(wl["kernel_launches_per_step"]) if on_card else {}
    window_counts: Dict = {}
    attempted = failed = 0
    try:
        su.first_steps(wl["setup_steps"])
        spans = []
        if trace:
            spans = [(devtrace.Span(device, "span", cpu=False), wl["trace_steps"], False),
                     (devtrace.Span(device, "gaps", cpu=True), wl["gap_steps"], True)]
        step_fn, feed = su.step_fn, su.feed

        def timed(s, b, g=None):
            with torch.profiler.record_function("bench.step") if feed.annotate else nullcontext():
                return step_fn(s, b, g)
        feed.on_window_end = lambda: window_counts.update(counts(ops))
        sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        reset_counts(ops)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        try:
            su.engine.train_one_epoch(timed, su.state, feed.until(t0 + seconds, spans),
                                      generator=su.gen, print_freq=10 ** 9)
        except FloatingPointError as e:
            failed += 1
            log(f"non-finite loss in the window: {e}")
        sync(device)
        steps = feed.steps
        window = [s for s in steps if s["phase"] == "window"]
        attempted = len(window)
        t_end = feed.end_t if feed.end_t is not None else time.perf_counter()
        window_s = t_end - t0
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    finally:
        prog = su.program_numbers()
        su.close()
    done = window[:-1] if failed else window
    metrics: Dict[str, Dict] = {}
    result_device = {"platform": "gpu" if on_card else device.type,
                     "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                     "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if not trace:
        metrics["train_frames_per_s"] = {"value": sum(s["frames"] for s in done) / window_s,
                                         "unit": "frames/s"}
        metrics["train_peak_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        tr, tr_gaps = spans[0][0].read(), spans[1][0].read()
        traced = [s for s in steps if s["phase"] == "span"]
        ctx = {"arch": conf["reference"], "window_steps": done, "window_s": window_s,
               "window_end_t": t_end, "trace": tr, "traced_steps": len(traced),
               "step_flops": StepFlops(conf["reference"]),
               "traced_calls": [c for s in traced for c in
                                msda.step_calls(conf["reference"], s["canvas"], s["items"])]}
        for name, mod in per_layer_readers(cell, end_to_end_names(cell)).items():
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
        result_device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = {"device_ops": devtrace.device_ops(tr), "idle_gaps": devtrace.idle_gaps(tr_gaps)}
        log(f"traced: {len(traced)} steps, busy {tr['busy_s']:.4f} s of {tr['window_s']:.4f} s "
            f"(CUDA activity only); the span naming gaps {tr_gaps['window_s']:.4f} s "
            f"for {wl['gap_steps']} steps")
    t_req = [s["request_t"] for s in done] + [t_end]
    gaps = sorted(b - a for a, b in zip(t_req[:-1], t_req[1:]))
    log(f"card {card() if on_card else 'cpu'}; window {window_s:.3f} s, "
        f"{attempted} steps, canvases {sorted({s['canvas'] for s in done})}; step s "
        f"min {gaps[0]:.3f} median {gaps[len(gaps) // 2]:.3f} max {gaps[-1]:.3f}"
        if gaps else f"window {window_s:.3f} s, no step")
    if on_card:
        log(f"kernel launches and plain calls over the window: {window_counts}")
    t = time.perf_counter()
    ref = reference_steps(conf, su.ds, su.sd, wl["compare_steps"], device)
    log(f"reference: {wl['compare_steps']} steps in {time.perf_counter() - t:.3f} s")
    checks = judge(prog, ref, wl["limits"])
    if on_card:
        checks.update(launch_checks(window_counts, wl["kernel_launches_per_step"], len(window))
                      if window_counts else {"plain_calls": [math.nan, 0.0]})
    correct = failed == 0 and attempted > 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out
