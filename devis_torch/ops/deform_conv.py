"""Modulated deformable convolution (DCNv2) of the mask head: K4, K10 and
their plain versions.

The port of `devis_tpu/ops/deform_conv.py` and of the fused banded kernel in
`devis_tpu/ops/deform_conv_banded.py`. One layer, channel-first:

    offset = conv(x, w_off) + b_off            (2*K*K channels, (y, x) per k)
    mod    = 2 * sigmoid(conv(x, w_mod) + b_mod)
    out(p) = bias + sum_k mod_k(p) * bilinear(x, p + k - pad + offset_k(p)) @ W_k

x (B, Cin, H, W); w_off (K, K, Cin, 2KK); w_mod (K, K, Cin, KK);
weight (K, K, Cin, Cout); returns (B, Cout, H, W) in x's dtype. Stride and
dilation 1, zero padding outside the image.

Both versions are exact DCNv2 at any offsets (`_mdc_reference` of the JAX
package). The JAX TPU kernel drops taps outside a rebased band, so the two
agree only where every tap is in band.

`deform_conv2d(x, offset, mask, weight, bias, padding)` is the public op of
`devis_tpu/ops/deform_conv.py` on given offset and modulation fields, also
channel-first: offset (B, 2KK, H, W), (y, x) per k; mask (B, KK, H, W). With
no gradient wanted it is K10 (the kernel of K4 reading its fields from
memory); with one it runs `deform_conv2d_rows` (K6/K7), as the JAX op's
custom VJP does.

On a CUDA tensor the dtype picks the kernel: bf16 (every model path) runs
the tensor-core kernel on operands the wrapper packs for it (`mma_plan`,
`pack_x`, `pack_field_weight`, `pack_mix_weight`); it rounds each sampled
column to bf16 before the channel mix, and `modulated_deform_conv2d_emulated`
repeats its arithmetic in plain PyTorch. f32 runs the CUDA-core kernel, which
rounds nothing.

K4 and K10 have no backward. Where a gradient is wanted (grad enabled and an input
requires grad) the layer runs `modulated_deform_conv2d_rows`, the port of the
JAX package's differentiable composition (`_mdc_reference`): the two field
convolutions, the channel mix U_k = x . W_k as one matrix product BEFORE the
gather (bilinear sampling is linear and W_k is constant over space), and the
K*K kernel positions gathered as K*K levels of one single-head, one-point
attention: K6 forward, K7 backward (`msda_rows`). It is exact DCNv2 too.

`launches` counts each op's kernel launches and `plain_calls` its CPU
dispatches; each of them runs in a span (`util.trace`), `dcn.K4` or
`dcn.K10`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ..util import trace
from .ms_deform_attn_cuda import msda_rows

_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use


def _hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def _tent_corners(offset, k: int, K: int, padding: int, H: int, W: int):
    """The four bilinear corners of kernel position k at every pixel:
    [(raster index (B, H*W) long, tent weight (B, H*W) f32, 0 where the
    corner lies outside the image)], zero padding outside the image.
    offset (B, 2KK, H, W), (y, x) per k."""
    B = offset.shape[0]
    ky, kx = divmod(k, K)
    base_y = torch.arange(H, dtype=torch.float32, device=offset.device)[:, None]
    base_x = torch.arange(W, dtype=torch.float32, device=offset.device)[None, :]
    sy = base_y + (ky - padding) + offset[:, 2 * k].float()   # (B, H, W)
    sx = base_x + (kx - padding) + offset[:, 2 * k + 1].float()
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    dy = sy - y0
    dx = sx - x0
    corners = []
    for oy, ox, tw in ((0, 0, (1 - dy) * (1 - dx)), (0, 1, (1 - dy) * dx),
                       (1, 0, dy * (1 - dx)), (1, 1, dy * dx)):
        yi = (y0 + oy).clamp(-1, H).long()
        xi = (x0 + ox).clamp(-1, W).long()
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        corners.append((idx.reshape(B, -1), (tw * valid).reshape(B, -1)))
    return corners


def deform_conv2d_plain(x, offset, mask, weight, padding: int = 1):
    """Exact deformable conv, f32. x (B, Cin, H, W); offset (B, 2KK, H, W)
    (y, x) per k; mask (B, KK, H, W); weight (K, K, Cin, Cout).
    Returns (B, Cout, H, W) f32 without bias."""
    B, Cin, H, W = x.shape
    K = weight.shape[0]
    Cout = weight.shape[-1]
    flat = x.float().reshape(B, Cin, H * W)
    out = x.new_zeros((B, Cout, H * W), dtype=torch.float32)
    for k in range(K * K):
        ky, kx = divmod(k, K)
        sampled = torch.zeros_like(flat)
        for idx, tw in _tent_corners(offset, k, K, padding, H, W):
            g = torch.gather(flat, 2, idx[:, None].expand(B, Cin, H * W))
            sampled += g * tw[:, None]
        sampled *= mask[:, k].float().reshape(B, 1, -1)
        out += torch.einsum("bcq,cd->bdq", sampled, weight[ky, kx].float())
    return out.reshape(B, Cout, H, W)


def modulated_deform_conv2d_plain(x, w_off, b_off, w_mod, b_mod, weight, bias,
                                  padding: int = 1):
    """Plain K4: the field convs, then the exact deformable conv, all in f32."""
    xf = x.float()
    offset = F.conv2d(xf, _hwio_to_oihw(w_off.float()), b_off.float(),
                      padding=padding)
    mod = 2.0 * torch.sigmoid(F.conv2d(xf, _hwio_to_oihw(w_mod.float()),
                                       b_mod.float(), padding=padding))
    out = deform_conv2d_plain(xf, offset, mod, weight, padding)
    return (out + bias.float()[None, :, None, None]).to(x.dtype)


def deform_conv2d_rows(x, offset, mask, weight, bias, padding: int = 1):
    """Deformable conv with the channel mix before the gather, as
    `_deform_conv2d_pallas` of the JAX package. x (B, Cin, H, W); offset
    (B, 2KK, H, W) (y, x) per k; mask (B, KK, H, W); weight (K, K, Cin, Cout)
    in x's dtype; returns (B, Cout, H, W) in x's dtype."""
    B, Cin, H, W = x.shape
    K = weight.shape[0]
    KK = K * K
    Cout = weight.shape[-1]
    HW = H * W
    f32 = torch.float32
    off = offset.reshape(B, KK, 2, HW).to(f32)
    q = torch.arange(HW, dtype=f32, device=x.device)
    k = torch.arange(KK, device=x.device)
    base_x, base_y = q % W, torch.floor(q / W)
    ky = torch.div(k, K, rounding_mode="floor").to(f32)[:, None]
    kx = (k % K).to(f32)[:, None]
    # attention convention: pixel = loc * size - 0.5, so loc = (pixel + 0.5) / size
    ly = (base_y + (ky - padding) + off[:, :, 0] + 0.5) / H      # (B, KK, HW)
    lx = (base_x + (kx - padding) + off[:, :, 1] + 0.5) / W
    loc = torch.stack([lx, ly], -1).permute(0, 2, 1, 3).reshape(B, HW, 1, KK, 1, 2)
    att = mask.reshape(B, KK, HW).to(f32).permute(0, 2, 1).reshape(B, HW, 1, KK, 1)
    u = torch.matmul(x.reshape(B, 1, Cin, HW).transpose(2, 3),
                     weight.reshape(1, KK, Cin, Cout))           # (B, KK, HW, Cout)
    out = msda_rows(u.reshape(B, KK * HW, 1, Cout), ((H, W),) * KK,
                    loc.contiguous(), att.contiguous())          # (B, HW, Cout)
    out = out.float() + bias.float()
    return out.to(x.dtype).transpose(1, 2).reshape(B, Cout, H, W)


def modulated_deform_conv2d_rows(x, w_off, b_off, w_mod, b_mod, weight, bias,
                                 padding: int = 1):
    """The differentiable DCNv2 layer (module docstring): field convolutions
    in the dtype of their weights, then `deform_conv2d_rows`."""
    xf = x.to(w_off.dtype)
    offset = F.conv2d(xf, _hwio_to_oihw(w_off), b_off, padding=padding)
    mod = 2.0 * torch.sigmoid(F.conv2d(xf, _hwio_to_oihw(w_mod), b_mod,
                                       padding=padding))
    return deform_conv2d_rows(x, offset, mod, weight, bias, padding)


# The bf16 kernel's tiling (`csrc/deform_conv.cu`, namespace mma): a block
# owns 128 output pixels and 16 * NT output channels, two warps of 8 * NT
# across them; NT <= 9, so a Cout above 144 takes several blocks.
MMA_NT_MAX = 9
MMA_NF = 32                  # field GEMM width: 3KK <= 27 channels, zero-padded


def mma_plan(Cin: int, Cout: int):
    """(Cin_pad, NT, n_tiles) of the bf16 kernel: Cin zero-padded to a
    multiple of 16; the output channels in n_tiles blocks of 16 * NT, so
    Cout_pack = 16 * NT * n_tiles >= Cout (out_lay's 1 -> 16, lay1's 264 ->
    2 x 144)."""
    cin_pad = -(-Cin // 16) * 16
    n_tiles = -(-Cout // (16 * MMA_NT_MAX))
    nt = -(-Cout // (16 * n_tiles))
    return cin_pad, nt, n_tiles


def pack_x(x, cin_pad: int):
    """x (B, Cin, H, W) -> (B, H, W, Cin_pad), channels zero-padded: a
    corner's channels are one contiguous row."""
    B, Cin, H, W = x.shape
    if Cin == cin_pad:
        return x.permute(0, 2, 3, 1).contiguous()
    out = x.new_zeros((B, H, W, cin_pad))
    out[..., :Cin] = x.permute(0, 2, 3, 1)
    return out


def pack_mix_weight(weight, cin_pad: int, cout_pack: int):
    """weight (K, K, Cin, Cout) -> the mix's B operand (KK, Cin_pad,
    Cout_pack), zero-padded."""
    K, _, Cin, Cout = weight.shape
    out = weight.new_zeros((K * K, cin_pad, cout_pack))
    out[:, :Cin, :Cout] = weight.reshape(K * K, Cin, Cout)
    return out


def pack_field_weight(w_off, b_off, w_mod, b_mod, cin_pad: int):
    """The two field convolutions as one B operand (KK * Cin_pad, 32), row
    t * Cin_pad + c for tap t and channel c: columns 2k and 2k + 1 the
    offset (y, x) of position k, 2KK + k its modulation logit, the rest zero;
    and their bias (32,) f32."""
    K, _, Cin, _ = w_off.shape
    KK = K * K
    w = w_off.new_zeros((KK, cin_pad, MMA_NF))
    w[:, :Cin, :2 * KK] = w_off.reshape(KK, Cin, 2 * KK)
    w[:, :Cin, 2 * KK:3 * KK] = w_mod.reshape(KK, Cin, KK)
    b = torch.zeros(MMA_NF, dtype=torch.float32, device=w_off.device)
    b[:2 * KK] = b_off.float()
    b[2 * KK:3 * KK] = b_mod.float()
    return w.reshape(KK * cin_pad, MMA_NF), b


def modulated_deform_conv2d_emulated(x, w_off, b_off, w_mod, b_mod, weight,
                                     bias, padding: int = 1):
    """Plain emulation of the bf16 kernel's arithmetic (not a path of the
    models), on the operands the wrapper packs for it: the field GEMM over
    the packed x and field weights in f32, bias and sigmoid in f32; then per
    kernel position the weighted corner rows of the packed x summed in f32
    (tent weight times modulation first), rounded to bf16 where x is bf16,
    times W_k accumulated in f32; the bias, one rounding to x's dtype. For
    f32 inputs nothing is rounded and it is exact DCNv2."""
    B, Cin, H, W = x.shape
    K = weight.shape[0]
    KK = K * K
    Cout = weight.shape[-1]
    cin_pad, nt, n_tiles = mma_plan(Cin, Cout)
    xn = pack_x(x, cin_pad)
    wf, bf = pack_field_weight(w_off, b_off, w_mod, b_mod, cin_pad)
    wm = pack_mix_weight(weight, cin_pad, 16 * nt * n_tiles)
    fields = F.conv2d(xn.permute(0, 3, 1, 2).float(),
                      wf.reshape(K, K, cin_pad, MMA_NF).permute(3, 2, 0, 1).float(),
                      bf, padding=padding)
    mod = 2.0 * torch.sigmoid(fields[:, 2 * KK:3 * KK])
    flat = xn.float().reshape(B, H * W, cin_pad)
    acc = flat.new_zeros((B, H * W, wm.shape[-1]))
    for k in range(KK):
        m = mod[:, k].reshape(B, -1)
        cols = torch.zeros_like(flat)
        for idx, tw in _tent_corners(fields, k, K, padding, H, W):
            cols += torch.gather(flat, 1, idx[..., None].expand(B, H * W, cin_pad)) \
                * (tw * m)[..., None]
        if x.dtype == torch.bfloat16:
            cols = cols.to(torch.bfloat16).float()
        acc += cols @ wm[k].float()
    out = (acc[..., :Cout] + bias.float()).to(x.dtype)
    return out.transpose(1, 2).reshape(B, Cout, H, W)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dcn_layer_f32_smem_bytes": ([_I] * 3, ctypes.c_long),
    "dcn_layer_mma_smem_bytes": ([_I] * 2, ctypes.c_long),
    "dcn_layer_f32": ([_P] * 8 + [_I] * 7 + [_P], ctypes.c_int),
    "deform_conv2d_f32": ([_P] * 6 + [_I] * 7 + [_P], ctypes.c_int),
    "dcn_layer_bf16": ([_P] * 6 + [_I] * 9 + [_P], ctypes.c_int),
    "deform_conv2d_bf16": ([_P] * 6 + [_I] * 9 + [_P], ctypes.c_int),
}


def _function(name: str):
    fn = getattr(_build.library("deform_conv"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn


def _check_inputs(name, x, expect, tensors):
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    for arg, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: {arg} must be {shape} {x.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on different devices")


def _check_smem(name, nbytes):
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{name}: {nbytes} bytes of shared memory, more than a "
                         "block has")


def _mma_plan_checked(name, Cin, Cout, K):
    """`mma_plan`, after the bf16 kernel's limits (K <= 3: 3KK field
    channels fit its 32-wide field GEMM; the shared memory of a block)."""
    if K > 3:
        raise ValueError(f"{name}: the bf16 kernel takes K <= 3, got {K}")
    cin_pad, nt, n_tiles = mma_plan(Cin, Cout)
    _check_smem(name, _function("dcn_layer_mma_smem_bytes")(nt, K))
    return cin_pad, nt, n_tiles


def _launch(name, fn, *args, device):
    with torch.cuda.device(device):
        _build.check(fn(*args, torch.cuda.current_stream(device).cuda_stream), name)


def modulated_deform_conv2d(x, w_off, b_off, w_mod, b_mod, weight, bias,
                            padding: int = 1):
    """The DCNv2 layer (module docstring). Where a gradient is wanted it runs
    the differentiable rows route. Otherwise K4: CPU tensors run the plain
    version; CUDA tensors launch the kernel in `csrc/deform_conv.cu`, chosen
    by dtype: bf16 the tensor-core kernel on packed operands
    (`pack_x`, `pack_field_weight`, `pack_mix_weight`), f32 the CUDA-core one."""
    tensors = (x, w_off, b_off, w_mod, b_mod, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return modulated_deform_conv2d_rows(*tensors, padding)
    with trace.span("dcn.K4"):
        if not x.is_cuda:
            modulated_deform_conv2d.plain_calls += 1
            return modulated_deform_conv2d_plain(x, w_off, b_off, w_mod, b_mod,
                                                 weight, bias, padding)
        name = "modulated_deform_conv2d"
        B, Cin, H, W = x.shape
        K = weight.shape[0]
        Cout = weight.shape[-1]
        KK = K * K
        _check_inputs(name, x, {"w_off": (w_off, (K, K, Cin, 2 * KK)),
                                "w_mod": (w_mod, (K, K, Cin, KK)),
                                "weight": (weight, (K, K, Cin, Cout))}, tensors)
        b_off, b_mod, bias = (t.float().contiguous() for t in (b_off, b_mod, bias))
        out = torch.empty((B, Cout, H, W), dtype=x.dtype, device=x.device)
        if x.dtype == torch.bfloat16:
            cin_pad, nt, n_tiles = _mma_plan_checked(name, Cin, Cout, K)
            xn = pack_x(x, cin_pad)
            wf, bf = pack_field_weight(w_off, b_off, w_mod, b_mod, cin_pad)
            wm = pack_mix_weight(weight, cin_pad, 16 * nt * n_tiles)
            _launch(name, _function("dcn_layer_bf16"), xn.data_ptr(), wf.data_ptr(),
                    bf.data_ptr(), wm.data_ptr(), bias.data_ptr(), out.data_ptr(), B,
                    cin_pad, H, W, Cout, wm.shape[-1], nt, K, padding, device=x.device)
        else:
            _check_smem(name, _function("dcn_layer_f32_smem_bytes")(Cin, Cout, K))
            x, w_off, w_mod, weight = (t.contiguous() for t in (x, w_off, w_mod, weight))
            _launch(name, _function("dcn_layer_f32"), x.data_ptr(), w_off.data_ptr(),
                    b_off.data_ptr(), w_mod.data_ptr(), b_mod.data_ptr(),
                    weight.data_ptr(), bias.data_ptr(), out.data_ptr(), B, Cin, H, W,
                    Cout, K, padding, device=x.device)
        modulated_deform_conv2d.launches += 1
        return out


modulated_deform_conv2d.launches = 0
modulated_deform_conv2d.plain_calls = 0


def deform_conv2d(x, offset, mask, weight, bias, padding: int = 1):
    """Deformable convolution from given fields (module docstring). Where a
    gradient is wanted it runs the differentiable rows route. Otherwise K10:
    CPU tensors run the plain version; CUDA tensors launch the kernel in
    `csrc/deform_conv.cu`, chosen by dtype as K4's. Returns (B, Cout, H, W)
    in x's dtype."""
    tensors = (x, offset, mask, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return deform_conv2d_rows(x, offset, mask, weight.to(x.dtype), bias, padding)
    with trace.span("dcn.K10"):
        if not x.is_cuda:
            deform_conv2d.plain_calls += 1
            out = deform_conv2d_plain(x, offset, mask, weight, padding)
            return (out + bias.float()[None, :, None, None]).to(x.dtype)
        name = "deform_conv2d"
        B, Cin, H, W = x.shape
        K = weight.shape[0]
        KK = K * K
        Cout = weight.shape[-1]
        _check_inputs(name, x, {"offset": (offset, (B, 2 * KK, H, W)),
                                "mask": (mask, (B, KK, H, W)),
                                "weight": (weight, (K, K, Cin, Cout))}, tensors)
        offset, mask = offset.contiguous(), mask.contiguous()
        bias = bias.float().contiguous()
        out = torch.empty((B, Cout, H, W), dtype=x.dtype, device=x.device)
        if x.dtype == torch.bfloat16:
            cin_pad, nt, n_tiles = _mma_plan_checked(name, Cin, Cout, K)
            xn = pack_x(x, cin_pad)
            wm = pack_mix_weight(weight, cin_pad, 16 * nt * n_tiles)
            _launch(name, _function("deform_conv2d_bf16"), xn.data_ptr(),
                    offset.data_ptr(), mask.data_ptr(), wm.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), B, cin_pad, H, W, Cout, wm.shape[-1], nt, K, padding,
                    device=x.device)
        else:
            _check_smem(name, _function("dcn_layer_f32_smem_bytes")(Cin, Cout, K))
            x, weight = x.contiguous(), weight.contiguous()
            _launch(name, _function("deform_conv2d_f32"), x.data_ptr(), offset.data_ptr(),
                    mask.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                    B, Cin, H, W, Cout, K, padding, device=x.device)
        deform_conv2d.launches += 1
        return out


deform_conv2d.launches = 0
deform_conv2d.plain_calls = 0
