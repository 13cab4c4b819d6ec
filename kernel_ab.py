#!/usr/bin/env python3
"""Device times of K2 (`msda_tap_window`), K3 (`msda_temporal`), K5
(`msda_temporal_bwd`), K6 (`msda_rows`), K7 (`msda_rows_bwd`), K8
(`msda_proj`), K9 (`msda_taps_bwd`) and the probes K12a
(`tent_band`), K12b (`corner_gather`) and K12c (`mma_probe`, and
`mma_probe_sync` where a checkout has it) in several checkouts of the port,
on one card and on the same inputs.

    python3 kernel_ab.py DIR [DIR ...]

Each DIR is the root of a checkout that holds `devis_torch/`: `.` for this
one, or an older commit unpacked with `git archive` into a git-ignored
directory. Only the kernels' wrappers come from DIR; the inputs and the
timing code are this checkout's (`chip_smoke.py` beside this file), bf16:

* K2 on clip encoder layer 0's inputs from the main path (`path`), at the
  encoder's raster references and at random ones (`chip_smoke.encoder_inputs`),
  and at F = 1 on the COCO encoder's pyramid (`f1`: its references, the
  reference init's offset biases plus N(0, 1) pixels, one image);
* K3 on decoder layer 0's inputs from the main path (`path`) and at Q 10
  (random locations, as `chip_smoke.msda_phases` makes them);
* K8 at the image encoder (Q = S = 23 205; 1 image, and the train step's
  2) and at decoder layer 0 (Q 300), random references and offsets as
  `chip_smoke.coco_kernel_phases` makes them;
* K6 at the clip mask head's six layers (B 60, `chip_smoke.mask_head_rows`)
  and the image mask head's (50 masks, `chip_smoke.dcn_route_loc`), called
  as the DCN route calls it (with its query grid), and at the image decoder
  (Q 300, 1 and 2 images, `chip_smoke.image_decoder_rows`);
* K9 at the image train step's decoder layers (2 images, Q 300: the taps of
  `chip_smoke.image_decoder_rows`' locations, a N(0, 1) output gradient);
* K5 at the clip encoder (Q = S = 5 100) at raster references (K1's inputs,
  `chip_smoke.encoder_inputs`) and at random ones, and at the decoder (Q 10);
  K7 at the clip mask head's six layers (B 60), the image mask head's (50
  masks) and the image encoder (Q = S, 2 images). K5, K7 and K9 are timed as
  ops: every kernel and memset a call by device time (the atomic form's
  zero, kernel and cast; the fixed-order form's entries, sort, gather and
  tap gradients), split by stage (`chip_smoke.device_stages`: entries,
  sort, bounds, gather, tap gradients, memsets and fills), the op by CUDA
  events, 5 calls checked for equal bits (`repeat_equal`), and a SHA-256
  digest of each output's bytes (grad_value, grad_loc, grad_att; K9's
  grad_value, grad_wt); the last line says, per case, whether each DIR's
  digests equal the first DIR's. Beside K5's sort stage at the clip
  encoder, `torch.sort(keys, stable=True)` of that case's keys (its
  corners' value rows, `ms_deform_attn_cuda._tap_entries` on the card) is
  timed in this checkout as the stage's yardstick (`sort_library_ms`); the
  port never calls it;
* K12a and K12b at `chip_smoke.BAND_SHAPES` (the JAX script's C 16 and C
  512, N 96 Wp), f32, as `chip_smoke.probe_phase` makes their inputs;
* K12c at `chip_smoke.MMA_SHAPES` (`benchmarks/mxu_probe.py:79-86`'s eight
  (n_dots, K, N), grid 912), bf16.

K2 and K3's inputs are made once, in this process (they come from the clip
model's path), and saved; K6, K8, K9 and the probes' are made in each DIR's
process from seeded generators on the card, the same in every process. Then each DIR is
timed in a process of its own, in the order given (parent, change, change,
parent compares two commits): each kernel's device time by
`chip_smoke.device_ms` (torch.profiler) and its op's time a call by CUDA
events. K2 must equal its plain version, and K3, K6 and K8 agree with
theirs to 2e-2 of max|plain| (K6 at the image mask head on its first
`chip_smoke.COCO_MASK_CMP_B` masks where the f32 copy of U passes 1.5 GB),
K5, K7 and K9 to 1e-2 (value gradient) and 1e-4 (location, weight and tap
weight gradients) of the plain version on the upcast inputs (K7 at the
image mask head on its first masks as K6), K12a and K12b to 1e-5 and K12c to 2e-2, in each DIR. Prints one JSON line a
DIR, the card's name and power limit, and last one JSON object of every
run. Needs one CUDA card.
"""
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def make_inputs(torch, cs, path):
    """Every case's inputs, saved to `path` on the CPU."""
    from devis_torch.inference import VISInferFn, make_eval_buckets
    from devis_torch.models.attention import sampling_offsets_bias_init
    from devis_torch.models.transformer import encoder_reference_points
    from devis_torch.ops import _build

    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    bf = torch.bfloat16
    k2, k3 = {}, {}
    with torch.inference_mode():
        _, model = cs.build(torch, dev)
        infer = VISInferFn(model, cs.T, make_eval_buckets(*cs.VIDEO_HW))
        x, pad = cs.clip_input(torch, dev, infer, cs._Video(cs.T, cs.SEED))
        _, _, ref, _, shapes, _, c_off, t_off = cs.capture_encoder0(model, x, pad)
        k2["path"] = (shapes, ref, c_off, t_off)
        value, shapes, loc, att, rule = cs.capture_decoder0(model, x, pad)
        k3["path"] = (value, shapes, loc, att, rule)
        del model
        for refs in ("raster", "random"):
            a = cs.encoder_inputs(torch, dev, gen, refs)
            k2[refs] = (cs.SHAPES, a[2], a[3].to(bf), a[4].to(bf))
        L = len(cs.COCO_SHAPES)
        Q = sum(h * w for h, w in cs.COCO_SHAPES)
        ref = encoder_reference_points(cs.COCO_SHAPES, torch.ones(1, L, 2, device=dev))
        bias = torch.from_numpy(sampling_offsets_bias_init(cs.M, L, cs.P)).to(dev)
        c_off = (bias + torch.randn(1, Q, bias.numel(), generator=gen, device=dev)).to(bf)
        k2["f1"] = (cs.COCO_SHAPES, ref.contiguous(), c_off, c_off.new_zeros(1, Q, 0))
        W, L = cs.T - 1, len(cs.SHAPES)
        Qd = cs.NQ // cs.T
        S = sum(h * w for h, w in cs.SHAPES)
        loc = torch.rand(cs.T, Qd, cs.M, (1 + W) * L, cs.P, 2, generator=gen,
                         device=dev) * 1.2 - 0.1
        att = torch.softmax(torch.randn(cs.T, Qd, cs.M, (1 + W) * L * cs.P, generator=gen,
                                        device=dev), -1).reshape(loc.shape[:-1])
        value = torch.randn(cs.T, S, cs.M, cs.D, generator=gen, device=dev).to(bf)
        k3["q10"] = (value, cs.SHAPES, loc, att, ("all",))
    cpu = lambda a: tuple(t.cpu() if torch.is_tensor(t) else t for t in a)  # noqa: E731
    torch.save({"K2": {k: cpu(v) for k, v in k2.items()},
                "K3": {k: cpu(v) for k, v in k3.items()}}, path)


def time_checkout(root, path):
    """Times K2, K3, K6, K8, K9 and K12a of the checkout at `root`, K2 and
    K3 on the inputs at `path`."""
    import torch
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(root))
    from devis_torch.ops import ms_deform_attn_cuda as K
    if not K.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"devis_torch came from {K.__file__}, not from {root}")
    dev = torch.device("cuda")
    cases = torch.load(path)
    out = {"dir": root, "K2": {}, "K3": {}}
    with torch.inference_mode():
        for name, a in cases["K2"].items():
            shapes, ref, c_off, t_off = (t.to(dev) if torch.is_tensor(t) else t for t in a)
            op = lambda: K.msda_tap_window(shapes, ref, c_off, t_off, cs.M)  # noqa: E731
            if not torch.equal(op(), K.msda_tap_window_plain(shapes, ref, c_off, t_off, cs.M)):
                raise AssertionError(f"K2 ({name}) differs from its plain version in {root}")
            out["K2"][name] = dict(ms=cs.device_ms(op, "msda_tap_window_kernel"),
                                   op_ms=cs.cuda_time(op, 20))
        for name, a in cases["K3"].items():
            value, shapes, loc, att, rule = (t.to(dev) if torch.is_tensor(t) else t for t in a)
            op = lambda: K.msda_temporal(value, shapes, loc, att, rule)  # noqa: E731
            err = cs.compare(f"K3 ({name})", op(),
                             K.ms_deform_attn_temporal_plain(value, shapes, loc, att, rule),
                             2e-2)
            out["K3"][name] = dict(ms=cs.device_ms(op, "msda_temporal_kernel"),
                                   op_ms=cs.cuda_time(op, 50), max_abs_err=err)
    out.update(rows_proj_times(torch, cs, K, dev))
    out.update(bwd_times(torch, cs, K, dev))
    out.update(taps_tent_times(torch, cs, K, dev))
    print(json.dumps(out), flush=True)


def taps_tent_times(torch, cs, K, dev):
    """K9 and the probes of a checkout (its wrappers) on inputs made here
    from seeded generators (see the module docstring)."""
    from devis_torch.ops import probes
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    res = {"K9": {}, "K12a": {}, "K12b": {}, "K12c": {}}
    B, Q = cs.COCO_BATCH, cs.COCO_NQ
    value, loc, att = cs.image_decoder_rows(torch, dev, gen, B)
    grad = torch.randn(B, Q, cs.M * cs.D, generator=gen, device=dev)
    idx, wt = K.taps(cs.COCO_SHAPES, loc, att)
    v16, g16 = value.to(torch.bfloat16), grad.to(torch.bfloat16)
    op = lambda: K.msda_taps_bwd(v16, cs.COCO_SHAPES, idx, wt, g16)  # noqa: E731
    want = K.msda_taps_bwd_plain(v16.float(), cs.COCO_SHAPES, idx, wt, g16.float())
    got = op()
    err = cs.compare("K9 (decoder) grad_value", got[0], want[0], 1e-2)
    cs.compare("K9 (decoder) grad_wt", got[1], want[1], 1e-4)
    res["K9"]["decoder B=2"] = dict(**bwd_op_times(torch, cs, op), max_abs_err=err)
    del value, loc, att, grad, idx, wt, v16, g16, got, want
    for label, C, rows in cs.BAND_SHAPES:
        N = rows * cs.BAND_WP
        u = torch.rand(C, N + cs.BAND_NCAND * cs.BAND_WP, generator=gen, device=dev)
        dy = torch.rand(N, generator=gen, device=dev) * 2 - 1
        dx = torch.rand(N, generator=gen, device=dev) * 2 - 1
        args = (u, dy, dx, cs.BAND_NCAND, cs.BAND_WP, cs.BAND_REPS)
        for key, name in (("K12a", "tent_band"), ("K12b", "corner_gather")):
            op = lambda: getattr(probes, name)(*args)  # noqa: E731
            err = cs.compare(f"{key} ({label})", op(),
                             getattr(probes, name + "_plain")(*args), 1e-5)
            res[key][f"C={C} N={N}"] = dict(ms=cs.device_ms(op, name + "_kernel"),
                                            op_ms=cs.cuda_time(op, 20), max_abs_err=err)
    forms = [f for f in ("mma_probe", "mma_probe_sync") if hasattr(probes, f)]
    for n_dots, Kd, N in cs.MMA_SHAPES:
        v = torch.randn(Kd, probes.D, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(Kd, N, generator=gen, device=dev).to(torch.bfloat16)
        want = probes.mma_probe_plain(v, w, n_dots)
        for form in forms:
            op = lambda: getattr(probes, form)(v, w, n_dots)  # noqa: E731
            err = cs.compare(f"K12c {form} ({n_dots}, {Kd}, {N})", op(), want, 2e-2)
            res["K12c"][f"{form} n_dots={n_dots} K={Kd} N={N}"] = dict(
                ms=cs.device_ms(op, "mma_probe", iters=10), max_abs_err=err)
    return res


def digest(torch, t) -> str:
    """SHA-256 of a tensor's bytes."""
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()


def bwd_op_times(torch, cs, op, iters=10):
    """A backward op's device time a call (every kernel and memset it
    launches: the atomic form's zero, kernel and cast; the fixed-order
    form's memsets, entries, sort, gather and tap gradients) and its split
    by stage, its launches a call, its CUDA-event time, whether 5 calls give
    the same bits, and the digests of the first call's outputs."""
    first = [t.clone() for t in op()]
    same = True
    for _ in range(4):
        same &= all(torch.equal(a, b) for a, b in zip(first, op()))
    dev_ms, launches, _ = cs.device_profile(op, iters)
    return dict(ms=dev_ms, launches=launches, op_ms=cs.cuda_time(op, iters),
                stages=cs.device_stages(op, iters), repeat_equal=bool(same),
                digests=[digest(torch, t) for t in first])


def sort_yardstick(torch, cs):
    """Device ms of `torch.sort(keys, stable=True)` of the clip encoder's
    corners' value rows (raster references, K5's inputs as `bwd_times`
    makes them): the yardstick of K5's sort stage. This checkout only."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    from devis_torch.ops.ms_deform_attn import temporal_frame_table
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 30)
    L, S = len(cs.SHAPES), sum(h * w for h, w in cs.SHAPES)
    a = cs.encoder_inputs(torch, dev, gen, "raster")
    loc = K.temporal_proj_locations(cs.SHAPES, a[2], a[3], a[4], cs.M).contiguous()
    att = K.temporal_proj_weights(a[5], a[6], cs.M, L).contiguous()
    del a
    frames = torch.cat([torch.arange(cs.T)[:, None],
                        torch.as_tensor(temporal_frame_table(("all",), cs.T))], 1)
    n_rows = cs.T * S * cs.M
    keys = K._tap_entries(cs.SHAPES, loc, att, frames, S, cs.M, n_rows)[0].int()
    del loc, att
    ms, launches, _ = cs.device_profile(lambda: torch.sort(keys, stable=True), 5)
    return dict(ms=ms, launches=launches, entries=keys.numel(), rows=n_rows)


def bwd_times(torch, cs, K, dev):
    """K5 and K7 of a checkout (its wrappers `K`) on inputs made here from
    seeded generators (see the module docstring), each against its plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 30)
    bf = torch.bfloat16
    res = {"K5": {}, "K7": {}}

    def timed(key, name, op, plain, tols=(1e-2, 1e-4, 1e-4), cut=None):
        got, want = op(), plain()
        err = 0.0
        for part, g, w, tol in zip(("value", "loc", "att"), got, want, tols):
            g = g if cut is None else g[:cut]
            e = cs.compare(f"{key} ({name}) grad_{part}", g, w, tol)
            err = e if part == "value" else err
        del got, want
        res[key][name] = dict(**bwd_op_times(torch, cs, op), max_abs_err=err)
        torch.cuda.empty_cache()

    L, W = len(cs.SHAPES), cs.T - 1
    S = sum(h * w for h, w in cs.SHAPES)
    for name in ("encoder raster", "encoder random", "decoder"):
        Q = cs.NQ // cs.T if name == "decoder" else S
        if name == "encoder raster":
            a = cs.encoder_inputs(torch, dev, gen, "raster")
            value = a[0]
            loc = K.temporal_proj_locations(cs.SHAPES, a[2], a[3], a[4], cs.M).contiguous()
            att = K.temporal_proj_weights(a[5], a[6], cs.M, L).contiguous()
            del a
        else:
            value = torch.randn(cs.T, S, cs.M, cs.D, generator=gen, device=dev)
            loc = torch.rand(cs.T, Q, cs.M, (1 + W) * L, cs.P, 2, generator=gen,
                             device=dev) * 1.2 - 0.1
            att = torch.softmax(torch.randn(cs.T, Q, cs.M, (1 + W) * L * cs.P, generator=gen,
                                            device=dev), -1).reshape(loc.shape[:-1])
        grad = torch.randn(cs.T, Q, cs.M * cs.D, generator=gen, device=dev)
        a16 = (value.to(bf), cs.SHAPES, loc, att, grad.to(bf), ("all",))
        up = tuple(t.float() if torch.is_tensor(t) else t for t in a16)
        timed("K5", name, lambda: K.msda_temporal_bwd(*a16),
              lambda: K.msda_temporal_bwd_plain(*up))
        del value, loc, att, grad, a16, up
    for where, B, layers in (("clip", cs.DCN_B, cs.DCN_LAYERS),
                             ("image", cs.COCO_SLOTS * cs.COCO_BATCH, cs.COCO_DCN_LAYERS)):
        for lname, _, cout, h, w in layers:
            shapes = ((h, w),) * 9
            if where == "clip":
                value, loc, att, grad = cs.mask_head_rows(torch, dev, gen, B, cout, h, w)
            else:
                value = torch.randn(B, 9 * h * w, 1, cout, generator=gen, device=dev)
                loc = cs.dcn_route_loc(torch, dev, gen, B, h, w)
                att = torch.rand(B, h * w, 1, 9, 1, generator=gen, device=dev) * 2.0
                grad = torch.randn(B, h * w, cout, generator=gen, device=dev)
            v16, g16 = value.to(bf), grad.to(bf)
            del value, grad
            nb = B if B * 9 * h * w * cout * 4 <= 1.5e9 else cs.COCO_MASK_CMP_B
            cut = (v16[:nb].float(), shapes, loc[:nb], att[:nb], g16[:nb].float())
            timed("K7", f"{where} {lname}", lambda: K.msda_rows_bwd(v16, shapes, loc, att, g16),
                  lambda: K.msda_rows_bwd_plain(*cut), cut=nb)
            del v16, g16, loc, att, cut
    Sc = sum(h * w for h, w in cs.COCO_SHAPES)
    Lc = len(cs.COCO_SHAPES)
    value = torch.randn(cs.COCO_BATCH, Sc, cs.M, cs.D, generator=gen, device=dev)
    loc = torch.rand(cs.COCO_BATCH, Sc, cs.M, Lc, cs.P, 2, generator=gen, device=dev) * 1.2 - 0.1
    att = torch.softmax(torch.randn(cs.COCO_BATCH, Sc, cs.M, Lc * cs.P, generator=gen,
                                    device=dev), -1).reshape(loc.shape[:-1])
    grad = torch.randn(cs.COCO_BATCH, Sc, cs.M * cs.D, generator=gen, device=dev)
    a16 = (value.to(bf), cs.COCO_SHAPES, loc, att, grad.to(bf))
    up = tuple(t.float() if torch.is_tensor(t) else t for t in a16)
    timed("K7", f"image encoder B={cs.COCO_BATCH}", lambda: K.msda_rows_bwd(*a16),
          lambda: K.msda_rows_bwd_plain(*up))
    return res


def rows_proj_times(torch, cs, K, dev):
    """K8 and K6 of a checkout (its wrappers `K`) on inputs made here from
    seeded generators (see the module docstring)."""
    from devis_torch.ops.ms_deform_attn import ms_deform_attn
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 10)
    bf = torch.bfloat16
    res = {"K6": {}, "K8": {}}

    def timed(kernel, name, op, got, want, kernel_name, iters=20):
        err = cs.compare(f"{kernel} ({name})", got(), want(), 2e-2)
        res[kernel][name] = dict(ms=cs.device_ms(op, kernel_name),
                                 op_ms=cs.cuda_time(op, iters), max_abs_err=err)

    with torch.inference_mode():
        S = sum(h * w for h, w in cs.COCO_SHAPES)
        for name, B, Q in (("encoder", 1, S), ("encoder B=2", 2, S),
                           ("decoder layer 0", 1, cs.COCO_NQ)):
            value, ref, off, logit = cs.k8_inputs(torch, dev, gen, B, Q)
            a = (value.to(bf), cs.COCO_SHAPES, ref, off.to(bf), logit.to(bf))
            op = lambda: K.msda_proj(*a)  # noqa: E731
            timed("K8", name, op, op, lambda: K.msda_proj_plain(*a), "msda_proj_kernel")
            del value, ref, off, logit, a
        for B in (1, 2):
            value, loc, att = cs.image_decoder_rows(torch, dev, gen, B)
            v16 = value.to(bf)
            op = lambda: K.msda_rows(v16, cs.COCO_SHAPES, loc, att)  # noqa: E731
            timed("K6", f"image decoder B={B}", op, op,
                  lambda: ms_deform_attn(v16, cs.COCO_SHAPES, loc, att), "msda_rows_kernel")
            del value, loc, att, v16
        for where, B, layers in (("clip", cs.DCN_B, cs.DCN_LAYERS),
                                 ("image", cs.COCO_SLOTS * cs.COCO_BATCH, cs.COCO_DCN_LAYERS)):
            for lname, _, cout, h, w in layers:
                shapes = ((h, w),) * 9
                if where == "clip":
                    value, loc, att, _ = cs.mask_head_rows(torch, dev, gen, B, cout, h, w)
                else:
                    value = torch.randn(B, 9 * h * w, 1, cout, generator=gen, device=dev)
                    loc = cs.dcn_route_loc(torch, dev, gen, B, h, w)
                    att = torch.rand(B, h * w, 1, 9, 1, generator=gen, device=dev) * 2.0
                v16 = value.to(bf)
                del value
                nb = B if B * 9 * h * w * cout * 4 <= 1.5e9 else cs.COCO_MASK_CMP_B
                op = lambda: K.msda_rows(v16, shapes, loc, att)  # noqa: E731
                timed("K6", f"{where} {lname}", op, lambda: op()[:nb],
                      lambda: ms_deform_attn(v16[:nb], shapes, loc[:nb], att[:nb]),
                      "msda_rows_kernel", iters=10)
                del v16, loc, att
                torch.cuda.empty_cache()
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: kernel_ab.py runs only on a GPU", file=sys.stderr)
        return 1
    if len(sys.argv) == 4 and sys.argv[1] == "--time":
        time_checkout(sys.argv[2], sys.argv[3])
        return 0
    roots = sys.argv[1:]
    if not roots or any(not os.path.isdir(os.path.join(r, "devis_torch")) for r in roots):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    cs = _chip_smoke()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        make_inputs(torch, cs, path)
        for root in roots:
            done = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", root,
                                   path], stdout=subprocess.PIPE, text=True, check=True)
            print(done.stdout, end="", flush=True)
            runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    yardstick = sort_yardstick(torch, cs)
    card = cs.card_line()
    print(card)
    print(json.dumps({"card": card, "runs": runs, "sort_library_ms": yardstick,
                      "digests_equal": digests_equal(runs)}))
    return 0


def digests_equal(runs):
    """Per DIR, per backward op and case, whether its digests equal the
    first DIR's; "all" per DIR."""
    out = []
    for run in runs:
        cases = {f"{key} {name}": rec["digests"] == runs[0][key][name]["digests"]
                 for key in ("K5", "K7", "K9") for name, rec in run.get(key, {}).items()
                 if "digests" in rec and name in runs[0].get(key, {})}
        out.append(dict(dir=run["dir"], all=all(cases.values()), cases=cases))
    return out


if __name__ == "__main__":
    sys.exit(main())
