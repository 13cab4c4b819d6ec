"""Operations and bytes of the deformable-attention ops of one training
step, from the configuration and the batch's shapes.

The rule (PERF.md, the table of kernels): an op's least time is the larger
of its bytes at 3.35 TB/s and its operations at 67 TFLOP/s (the bilinear
taps run on the CUDA cores in float32); each input byte is read once and
each output byte written once, scratch and sort passes not counted.
A tap is one sampling point of one (query, head); it reads 4 corners of D
channels: forward 4 * D multiply-adds, backward twice that (the value's
gradient and the corner's dot with the output gradient).

`step_calls(arch, canvas, items)` lists every call of a step: name, kernel
group (the op's kernels by name, `GROUPS`), direction, operations, bytes and
bound in seconds. `step_gather_flops` gives the taps' operations alone,
which the matrix-product counter of `flops.py` cannot see.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16 = 2
F32 = 4

# the kernels of each op, by a substring of their names
GROUPS = {"K1": ("msda_temporal_proj_win_kernel", "msda_tap_window_kernel"),
          "K3": ("msda_temporal_kernel",),
          "K5": ("k5_bwd",),
          "K6": ("msda_rows_kernel",),
          "K7": ("k7_bwd",),
          "K8": ("msda_proj_kernel",),
          "K9": ("k9_bwd",)}


def pyramid(h: int, w: int) -> List[Tuple[int, int]]:
    """Feature sizes of ResNet-50 and the extra level for an (h, w) input:
    /4, /8, /16, /32, /64 (each stride-2 step rounds up)."""
    up = lambda x: -(-x // 2)
    s = [(up(up(h)), up(up(w)))]
    for _ in range(4):
        s.append((up(s[-1][0]), up(s[-1][1])))
    return s


def _call(name: str, op: str, direction: str, flops: float, nbytes: float) -> Dict:
    return dict(name=name, op=op, dir=direction, flops=flops, bytes=nbytes,
                bound_s=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS))


def attn_calls(tag: str, op_f: str, op_b: str, B: int, S: int, Q: int, M: int, D: int,
               Lt: int, P: int, fwd_in: float) -> List[Dict]:
    """One deformable attention: B items, value (B, S, M, D) in bf16, Q
    queries a head with Lt levels of P points; `fwd_in` the bytes of the
    forward's other inputs (locations and weights, or their raw
    projections)."""
    taps = B * Q * M * Lt * P
    value, out = B * S * M * D * BF16, B * Q * M * D * BF16
    if op_b == "K9":       # given its entries: 4 (index int32, weight f32) a tap in, 4 weights' gradients out
        b_in, b_out = taps * 4 * (4 + F32), taps * 4 * F32
    else:                  # locations (x, y) and weight in f32, in and their gradients out
        b_in = b_out = taps * 3 * F32
    return [_call(tag, op_f, "fwd", taps * 4 * D * 2, value + fwd_in + out),
            _call(tag, op_b, "bwd", taps * 4 * D * 4, value + b_in + out + value + b_out)]


def dcn_calls(tag: str, B: int, h: int, w: int, cout: int) -> List[Dict]:
    """One DCNv2 layer of the mask head under grad: its channel mix U
    (B, 9 * h * w, 1, cout) sampled by K6 at 9 levels of 1 point (K7
    backward)."""
    return attn_calls(tag, "K6", "K7", B, 9 * h * w, h * w, 1, cout, 9, 1,
                      B * h * w * 9 * 3 * F32)


def mask_head_calls(arch: Dict, canvas: Tuple[int, int], samples: int) -> List[Dict]:
    """The six DCNv2 layers of one mask-head evaluation over `samples`
    feature maps (slots x frames)."""
    p4, p8, p16, p32, _ = pyramid(*canvas)
    d = arch["hidden_dim"]
    layers = [("lay1", p32, d + 8), ("lay2", p32, d // 2), ("lay3", p16, d // 4),
              ("lay4", p8, d // 8), ("lay5", p4, d // 16), ("out_lay", p4, 1)]
    out = []
    for name, (h, w), cout in layers:
        out += dcn_calls(f"mask_head.{name}", samples, h, w, cout)
    return out


def step_calls(arch: Dict, canvas: Tuple[int, int], items: int) -> List[Dict]:
    """Every deformable-attention call of one training step on `items`
    clips of `canvas` (h, w)."""
    M, L, P, d = arch["heads"], arch["levels"], arch["enc_points"], arch["hidden_dim"]
    D = d // M
    levels = pyramid(*canvas)[1:]
    S = sum(h * w for h, w in levels)
    evals = 1 + len(arch["mask_aux_loss"])
    calls: List[Dict] = []
    T = arch["num_frames"]
    Lt = T * L                                   # current frame and T - 1 others
    Lq = arch["num_queries"] // T
    for c in range(items):
        raw = T * S * (L * 2 * F32 + M * Lt * P * 3 * BF16)   # ref (f32), offsets, logits
        for i in range(arch["enc_layers"]):
            calls += attn_calls(f"encoder.{i}", "K1", "K5", T, S, S, M, D, Lt, P, raw)
        for i in range(arch["dec_layers"]):
            calls += attn_calls(f"decoder.{i}", "K3", "K5", T, S, Lq, M, D, Lt, P,
                                T * Lq * M * Lt * P * 3 * F32)
        for _ in range(evals):
            calls += mask_head_calls(arch, canvas, arch["slots"] * T)
    return calls


def step_gather_flops(arch: Dict, sizes: List[Tuple[int, int]]) -> float:
    """The taps' operations (forward and backward) of one step, each item
    at its own content size."""
    return sum(c["flops"] for hw in sizes for c in step_calls(arch, hw, 1))

