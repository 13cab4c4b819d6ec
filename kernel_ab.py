#!/usr/bin/env python3
"""Device times of K2 (`msda_tap_window`) and K3 (`msda_temporal`) in
several checkouts of the port, on one card and on the same inputs.

    python3 kernel_ab.py DIR [DIR ...]

Each DIR is the root of a checkout that holds `devis_torch/`: `.` for this
one, or an older commit unpacked with `git archive` into a git-ignored
directory. The inputs are made once, in this process, with this checkout
(`chip_smoke.py`'s model and phases, seed 0, bf16):

* K2 on clip encoder layer 0's inputs from the main path (`path`), at the
  encoder's raster references and at random ones (`chip_smoke.encoder_inputs`),
  and at F = 1 on the COCO encoder's pyramid (raster references, one image);
* K3 on decoder layer 0's inputs from the main path (`path`) and at Q 10
  (random locations, as `chip_smoke.msda_phases` makes them).

Then each DIR is timed in a process of its own, in the order given (parent,
change, change, parent compares two commits): the kernel's device time by
`chip_smoke.device_ms` (torch.profiler) and the op's time a call by CUDA
events. K2 must equal its plain version and K3 agree with its own to 2e-2
of max|plain| in each DIR. Prints one JSON line a DIR, the card's name and
power limit, and last one JSON object of every run. Needs one CUDA card.
"""
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
    """Times K2 and K3 of the checkout at `root` on the inputs at `path`."""
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
    print(json.dumps(out), flush=True)


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
    card = cs.card_line()
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
