"""Int8 W8A8 quantization for the SD UNet serving mode (sd_precision="int8").

Counterpart of gill_tpu/ops/quant.py, which has no Pallas kernel: gill_tpu
leaves its int8 products to XLA (`dot_general` / `conv_general_dilated`
with int32 accumulation), and the port leaves them to `torch._int_mm`.

  * weights: symmetric per-output-channel int8, scale max(amax/127, 1e-12),
    quantized once at load (`unet.quantize_params`);
  * activations: one dynamic scale per TENSOR, over the whole batch (the
    CFG pair and every job of an SD-queue batch share it, as in gill_tpu);
  * round half to even, clip to +-127, int32 sums, then the fp32 epilogue
    y * (sx * ws) + b rounded once to x's dtype.

PyTorch eager has no int8 convolution, so `int8_conv2d` is an NHWC im2col
of the int8 activation (zero padding added AFTER quantizing, as XLA pads
the int8 operand) times the weight reshaped to (kh*kw*Cin, Cout). A
quantized conv weight is OIHW int8 in channels_last memory (O, H, W, I),
the layout of the port's float conv weights (nn/core.py), with one fp32
scale per O; that makes the (Cout, kh*kw*Cin) matrix a free view.

GILL_QUANT_STATIC=1 (read at import, as gill_tpu reads it) is gill_tpu's
diagnostic: a fixed activation scale of 1/16 instead of the amax reduce.
It is numerically meaningless and off by default.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

STATIC = os.environ.get("GILL_QUANT_STATIC", "0") == "1"


def quantize_weight(w, *, reduce_axes):
    """Symmetric per-output-channel int8: reduce_axes are the contracted
    axes ((0,) for an (in, out) linear weight, (1, 2, 3) for an OIHW conv
    weight). Returns (wq in w's layout, fp32 scales (out,))."""
    w = w.float()
    amax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale.reshape(-1)


def dynamic_quantize(x):
    """Per-tensor symmetric int8 of x: (xq, fp32 scalar scale)."""
    xf = x.float()
    if STATIC:
        xq = torch.clamp(torch.round(xf * 16.0), -127, 127).to(torch.int8)
        return xq, torch.tensor(1.0 / 16.0, device=x.device)
    scale = torch.clamp(xf.abs().amax() / 127.0, min=1e-12)
    xq = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return xq, scale


def int_mm(a, b):
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact. On CUDA,
    `torch._int_mm` wants M > 16 and K, N multiples of 8, and on an H100
    cuBLASLt refused a row-major (K, N) operand at 17, 24, 40, 48 and 136
    rows (K = 40 or 64) while it took every multiple of 32 rows (a sweep
    of 100 shapes and both layouts): rows are padded to a multiple of 128
    and the contracted and output columns to multiples of 8, all with
    zeros (which add nothing), and the result sliced. b is made
    contiguous: PyTorch's `_int_mm` notes that cuBLAS fails on some
    transposed inputs."""
    if not a.is_cuda:
        return torch._int_mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = -m % 128, -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    b = F.pad(b, (0, pn, 0, pk)) if (pk or pn) else b.contiguous()
    y = torch._int_mm(a.contiguous(), b)
    return y[:m, :n] if (pm or pn) else y


def _epilogue(y, sx, ws, b, dtype):
    out = y.float() * (sx * ws.float())
    if b is not None:
        out = out + b.float()
    return out.to(dtype)


def int8_linear(x, wq, ws, b=None):
    """x (..., in) @ int8 weight (in, out), fused dequant epilogue."""
    xq, sx = dynamic_quantize(x)
    k, n = wq.shape
    y = int_mm(xq.reshape(-1, k), wq)
    return _epilogue(y, sx, ws, b, x.dtype).reshape(*x.shape[:-1], n)


def _pads(padding, h: int, w: int, kh: int, kw: int, stride: int):
    """(top, bottom, left, right) of XLA's 'SAME' / 'VALID' / int padding."""
    from gill_tpu_torch.nn.core import _same_pads

    if padding == "VALID":
        return 0, 0, 0, 0
    if padding == "SAME":
        return (*_same_pads(h, kh, stride), *_same_pads(w, kw, stride))
    p = int(padding)
    return p, p, p, p


def conv2d_int32(xq, wq, *, stride: int = 1, padding="SAME"):
    """Exact int32 NHWC convolution of int8 xq by the OIHW int8 wq
    (channels_last memory): zero padding, im2col in (kh, kw, Cin) order,
    then `int_mm` against the (kh*kw*Cin, Cout) view of the weight."""
    bsz, h, w, c = xq.shape
    cout, cin, kh, kw = wq.shape
    if cin != c:
        raise ValueError(f"conv weight takes {cin} channels, x has {c}")
    top, bot, left, right = _pads(padding, h, w, kh, kw, stride)
    if top or bot or left or right:
        xq = F.pad(xq, (0, 0, left, right, top, bot))
    if kh == kw == 1 and stride == 1:
        cols, ho, wo = xq.reshape(-1, c), xq.shape[1], xq.shape[2]
    else:
        patches = xq.unfold(1, kh, stride).unfold(2, kw, stride)
        ho, wo = patches.shape[1], patches.shape[2]   # (B, Ho, Wo, C, kh, kw)
        cols = patches.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * c)
    wmat = wq.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
    return int_mm(cols, wmat.t()).reshape(bsz, ho, wo, cout)


def int8_conv2d(x, wq, ws, b=None, *, stride: int = 1, padding="SAME"):
    """NHWC x, OIHW int8 weight (channels_last memory), per-out-channel
    dequant epilogue -> NHWC in x's dtype."""
    xq, sx = dynamic_quantize(x)
    y = conv2d_int32(xq, wq, stride=stride, padding=padding)
    return _epilogue(y, sx, ws, b, x.dtype)
