"""Modulated deformable convolution (DCNv2) of the mask head: K4 and its plain
version.

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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use


def _hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def deform_conv2d_plain(x, offset, mask, weight, padding: int = 1):
    """Exact deformable conv, f32. x (B, Cin, H, W); offset (B, 2KK, H, W)
    (y, x) per k; mask (B, KK, H, W); weight (K, K, Cin, Cout).
    Returns (B, Cout, H, W) f32 without bias."""
    B, Cin, H, W = x.shape
    K = weight.shape[0]
    Cout = weight.shape[-1]
    flat = x.float().reshape(B, Cin, H * W)
    base_y = torch.arange(H, dtype=torch.float32, device=x.device)[:, None]
    base_x = torch.arange(W, dtype=torch.float32, device=x.device)[None, :]
    out = x.new_zeros((B, Cout, H * W), dtype=torch.float32)
    for k in range(K * K):
        ky, kx = divmod(k, K)
        sy = base_y + (ky - padding) + offset[:, 2 * k].float()   # (B, H, W)
        sx = base_x + (kx - padding) + offset[:, 2 * k + 1].float()
        y0 = torch.floor(sy)
        x0 = torch.floor(sx)
        dy = sy - y0
        dx = sx - x0
        sampled = torch.zeros_like(flat)
        for oy, ox, tw in ((0, 0, (1 - dy) * (1 - dx)), (0, 1, (1 - dy) * dx),
                           (1, 0, dy * (1 - dx)), (1, 1, dy * dx)):
            yi = (y0 + oy).clamp(-1, H).long()
            xi = (x0 + ox).clamp(-1, W).long()
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, 1, -1)
            g = torch.gather(flat, 2, idx.expand(B, Cin, H * W))
            sampled += g * (tw * valid).reshape(B, 1, -1)
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


def _function(name: str):
    fn = getattr(_build.library("deform_conv"), name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "dcn_layer_smem_bytes":
            fn.argtypes, fn.restype = [I, I, I], ctypes.c_long
        else:
            fn.argtypes, fn.restype = [P] * 8 + [I] * 7 + [P], ctypes.c_int
    return fn


def modulated_deform_conv2d(x, w_off, b_off, w_mod, b_mod, weight, bias,
                            padding: int = 1):
    """K4: the fused DCNv2 layer (module docstring). CPU tensors run the plain
    version; CUDA tensors launch the kernel in `csrc/deform_conv.cu`."""
    if not x.is_cuda:
        modulated_deform_conv2d.plain_calls += 1
        return modulated_deform_conv2d_plain(x, w_off, b_off, w_mod, b_mod,
                                             weight, bias, padding)
    B, Cin, H, W = x.shape
    K = weight.shape[0]
    Cout = weight.shape[-1]
    KK = K * K
    if x.dtype not in _DTYPES:
        raise ValueError(f"modulated_deform_conv2d: unsupported dtype {x.dtype}")
    expect = {"w_off": (w_off, (K, K, Cin, 2 * KK)),
              "w_mod": (w_mod, (K, K, Cin, KK)),
              "weight": (weight, (K, K, Cin, Cout))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"modulated_deform_conv2d: {name} must be "
                             f"{shape} {x.dtype}, got {tuple(t.shape)} {t.dtype}")
    for t in (x, w_off, w_mod, weight, b_off, b_mod, bias):
        if t.device != x.device:
            raise ValueError("modulated_deform_conv2d: tensors on different devices")
    if _function("dcn_layer_smem_bytes")(Cin, Cout, K) > SMEM_LIMIT:
        raise ValueError(f"modulated_deform_conv2d: Cin={Cin}, Cout={Cout} "
                         "need more shared memory than a block has")
    x, w_off, w_mod, weight = (t.contiguous() for t in (x, w_off, w_mod, weight))
    b_off, b_mod, bias = (t.float().contiguous() for t in (b_off, b_mod, bias))
    out = torch.empty((B, Cout, H, W), dtype=x.dtype, device=x.device)
    fn = _function(f"dcn_layer_{_DTYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        _build.check(fn(x.data_ptr(), w_off.data_ptr(), b_off.data_ptr(),
                        w_mod.data_ptr(), b_mod.data_ptr(), weight.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), B, Cin, H, W, Cout, K,
                        padding, torch.cuda.current_stream(x.device).cuda_stream),
                     "modulated_deform_conv2d")
    modulated_deform_conv2d.launches += 1
    return out


modulated_deform_conv2d.launches = 0
modulated_deform_conv2d.plain_calls = 0
