"""fp32 layers over the port's parameter layout: linear {"w" (in, out), "b"},
LayerNorm / GroupNorm {"scale", "bias"}, convs {"w" OIHW, "b"} on NHWC
activations, attention with an exact softmax.

Under `rounded(dtype)` every product (linear, conv, both attention
products) first rounds its two operands to `dtype`, each tensor scaled by
its largest magnitude onto the type's range, and then multiplies in fp32:
the reference at a lower precision, the control of `correct`."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_matmul():
    """Plain fp32 products: TF32 off for cuBLAS and cuDNN, restored after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


_ROUND = []


@contextlib.contextmanager
def rounded(dtype):
    """Products' operands rounded to `dtype` inside the block."""
    _ROUND.append(dtype)
    try:
        yield
    finally:
        _ROUND.pop()


def rnd(t):
    """t (fp32) rounded to the innermost `rounded` type, per-tensor scaled
    onto its range; t itself outside any block."""
    if not _ROUND:
        return t
    top = torch.finfo(_ROUND[-1]).max
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(_ROUND[-1]).float() * scale


def f32(t):
    return t.float()


def linear(p, x):
    """x @ w + b in fp32."""
    y = rnd(x) @ rnd(f32(p["w"]))
    if "b" in p:
        y = y + f32(p["b"])
    return y


def layer_norm(p, x, eps):
    return F.layer_norm(x, (x.shape[-1],), f32(p["scale"]), f32(p["bias"]),
                        eps)


def group_norm(p, x, groups, eps):
    """GroupNorm over NHWC."""
    y = F.group_norm(x.permute(0, 3, 1, 2), groups, f32(p["scale"]),
                     f32(p["bias"]), eps)
    return y.permute(0, 2, 3, 1)


def conv2d(p, x, stride=1, padding=1):
    """NHWC conv with an OIHW weight; padding an int (symmetric)."""
    y = F.conv2d(rnd(x.permute(0, 3, 1, 2)), rnd(f32(p["w"])), f32(p["b"]),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def attention(q, k, v, causal=False):
    """q (B, T, H, D), k/v (B, S, H, D) -> (B, T, H, D), exact softmax;
    causal aligns the last query with the last key."""
    d = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", rnd(q), rnd(k)) / math.sqrt(d)
    if causal:
        t, n = q.shape[1], k.shape[1]
        mask = torch.ones((t, n), dtype=torch.bool, device=q.device).tril(
            n - t)
        s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", rnd(torch.softmax(s, dim=-1)),
                        rnd(v))


def mha(p, x, ctx, num_heads):
    """Self (ctx None) or cross attention with q/k/v/o projections."""
    ctx = x if ctx is None else ctx
    b, t, d = x.shape
    s = ctx.shape[1]
    hd = d // num_heads
    q = linear(p["q"], x).reshape(b, t, num_heads, hd)
    k = linear(p["k"], ctx).reshape(b, s, num_heads, hd)
    v = linear(p["v"], ctx).reshape(b, s, num_heads, hd)
    return linear(p["o"], attention(q, k, v).reshape(b, t, d))


def layer(stacked, i):
    """Layer i of a stacked (L, ...) tree."""
    if isinstance(stacked, dict):
        return {k: layer(v, i) for k, v in stacked.items()}
    return stacked[i]
