"""Functional NN building blocks over explicit parameter trees.

Counterpart of gill_tpu/nn/core.py. Parameters are nested dicts (and
lists) of tensors, so a JAX param tree carries over leaf by leaf
(weights/from_jax.py). Layouts at the public functions follow gill_tpu:

  * linear weights are (in_dim, out_dim) and `linear` computes x @ w;
  * activations are NHWC. Convolution weights are stored OIHW in the
    channels_last memory format, so `conv2d` hands cuDNN an NHWC tensor
    viewed as NCHW with no copy of either operand;
  * norms take their statistics in fp32 and apply the affine in x's dtype.

Quantized leaves dispatch on their keys, as in gill_tpu: W8A16 {"w8", "ws"}
(the LM, models/opt.py) and W8A8 {"wq", "ws"} (the SD UNet,
models/sd/unet.py quantize_params; ops/quant.py). A W8 linear weight is
(in, out) int8 with one scale per out; a W8A8 linear weight likewise; a
W8A8 conv weight is OIHW int8 in channels_last memory with one scale per O.

Random init takes an explicit `torch.Generator` and device and follows the
JAX init distributions (kaiming-uniform fan-in for linear/conv, N(0, std)
for embeddings, ones/zeros for norms). Layer stacks are allocated directly
in stacked (L, ...) form, as gill_tpu does.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from gill_tpu_torch.ops import quant
from gill_tpu_torch.ops import w8_matmul as w8_ops

# ---------------------------------------------------------------------------
# tree utilities
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    """Applies fn to every tensor leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def layer_view(stacked, i: int):
    """Layer i of a stacked (L, ...) parameter tree, as views."""
    return tree_map(lambda x: x[i], stacked)


def param_count(tree) -> int:
    """Elements in the tree's tensor leaves."""
    return sum(x.numel() for x in tree_leaves(tree) if torch.is_tensor(x))


def tree_size_bytes(tree) -> int:
    """Bytes of the tree's tensor leaves."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if torch.is_tensor(x))


def cast_tree(tree, dtype):
    """The tree with its floating-point tensor leaves cast to `dtype`;
    integer leaves (W8 weights, ids) and markers are kept."""
    return tree_map(lambda x: x.to(dtype) if torch.is_tensor(x)
                    and x.is_floating_point() else x, tree)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

class Init:
    """Random-init context: one generator, device and dtype for a tree.

    `lead` is the stacked-layer prefix of every leaf shape (e.g. (L,))."""

    def __init__(self, generator: torch.Generator, device, dtype=torch.float32):
        self.g = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def uniform(self, shape: Sequence[int], bound: float, dtype=None):
        t = torch.empty(tuple(shape), device=self.device,
                        dtype=dtype or self.dtype)
        return t.uniform_(-bound, bound, generator=self.g)

    def normal(self, shape: Sequence[int], std: float = 1.0, dtype=None):
        t = torch.empty(tuple(shape), device=self.device,
                        dtype=dtype or self.dtype)
        return t.normal_(0.0, std, generator=self.g)

    def full(self, shape: Sequence[int], value: float):
        return torch.full(tuple(shape), value, device=self.device,
                          dtype=self.dtype)

    # -- parameter bundles ----------------------------------------------------

    def linear(self, in_dim: int, out_dim: int, bias: bool = True,
               lead: Sequence[int] = ()):
        """Kaiming-uniform fan-in (torch.nn.Linear default), (in, out)."""
        bound = 1.0 / math.sqrt(in_dim)
        p = {"w": self.uniform((*lead, in_dim, out_dim), bound)}
        if bias:
            p["b"] = self.uniform((*lead, out_dim), bound)
        return p

    def layer_norm(self, dim: int, lead: Sequence[int] = ()):
        return {"scale": self.full((*lead, dim), 1.0),
                "bias": self.full((*lead, dim), 0.0)}

    group_norm = layer_norm

    def embedding(self, num: int, dim: int, std: float = 0.02):
        return {"weight": self.normal((num, dim), std)}

    def conv2d(self, in_ch: int, out_ch: int, kernel: int):
        """OIHW weight in channels_last memory (see module docstring)."""
        bound = 1.0 / math.sqrt(in_ch * kernel * kernel)
        w = self.uniform((out_ch, kernel, kernel, in_ch), bound)
        return {"w": w.permute(0, 3, 1, 2),
                "b": self.uniform((out_ch,), bound)}

    def mha(self, dim: int, lead: Sequence[int] = ()):
        """q/k/v/o projections of a dim-wide attention, with biases."""
        return {k: self.linear(dim, dim, lead=lead) for k in "qkvo"}


def conv_weight_from_hwio(w_hwio: torch.Tensor) -> torch.Tensor:
    """JAX HWIO kernel -> OIHW view in channels_last memory."""
    return w_hwio.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def w8_kernel_eligible(p, x, *, on_cuda: bool) -> bool:
    """Whether `linear` sends the W8 product x @ (w8 * ws) to the kernel:
    on a CUDA device, no "xla" marker, a shape the kernel takes, and an x
    that needs no gradient (a training forward through a W8 frozen LM
    takes the differentiable dequant form)."""
    from gill_tpu_torch.ops.attention import needs_grad

    kdim, n = p["w8"].shape
    return (on_cuda and "xla" not in p and not needs_grad(x)
            and w8_ops.supported(min(x.numel() // kdim, w8_ops.MAX_M),
                                 kdim, n))


def linear(p, x):
    """x @ w (+ b), weight cast to x's dtype (gill_tpu nn.core.linear).

    W8A16 leaves {"w8" (K, N) int8, "ws" (N,) fp32, "b"?, markers}
    (models/opt.py quantize_params_w8): on CUDA, calls with K and N
    multiples of 512 and no "xla" marker take the kernel (gill_tpu: on a
    TPU, up to 256 rows), above 256 rows as 256-row windows
    (`ops.w8_matmul.w8_matmul_rows`), so a prefill row's bits do not
    depend on its wave's size; the rest — other shapes and the CPU — take
    the dequant form x @ (w8 * ws) (+ b) in x's dtype, as gill_tpu
    computes it outside any Pallas kernel, and so does an x that needs a
    gradient (`w8_kernel_eligible`: the kernel has no backward). W8A8
    leaves {"wq", "ws", "b"?} take `quant.int8_linear` (dynamic per-tensor
    activation scale, int32 sums)."""
    if "wq" in p:
        return quant.int8_linear(x, p["wq"], p["ws"], p.get("b"))
    if "w8" in p:
        w8 = p["w8"]
        if w8_kernel_eligible(p, x, on_cuda=x.is_cuda):
            return w8_ops.w8_matmul_rows(x, w8, p["ws"], p.get("b"))
        w = w8.to(x.dtype) * p["ws"].to(x.dtype)[None, :]
        y = torch.matmul(x, w)
        if "b" in p:
            y = y + p["b"].to(x.dtype)
        return y
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def layer_norm(p, x, eps: float = 1e-5):
    """Single-pass fp32 statistics (the square taken in x's dtype, as
    gill_tpu does), variance clamped at 0, affine applied in x's dtype."""
    mean = x.mean(-1, keepdim=True, dtype=torch.float32)
    mean2 = (x * x).mean(-1, keepdim=True, dtype=torch.float32)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    scale = p["scale"].float()
    a = (inv * scale).to(x.dtype)
    b = (p["bias"].float() - mean * inv * scale).to(x.dtype)
    return x * a + b


def group_norm(p, x, num_groups: int = 32, eps: float = 1e-6):
    """GroupNorm over NHWC activations: per-channel fp32 partial sums,
    combined per group, then one elementwise pass in x's dtype."""
    n, h, w, c = x.shape
    g = num_groups
    s1 = x.sum(dim=(1, 2), dtype=torch.float32)                 # (n, c)
    s2 = x.float().square().sum(dim=(1, 2))                     # (n, c)
    cnt = h * w * (c // g)
    mean = s1.reshape(n, g, c // g).sum(-1) / cnt               # (n, g)
    mean2 = s2.reshape(n, g, c // g).sum(-1) / cnt
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(c // g, dim=-1)               # (n, c)
    mean_c = mean.repeat_interleave(c // g, dim=-1)
    scale = p["scale"].float()[None]
    bias = p["bias"].float()[None]
    a = (inv_c * scale).to(x.dtype)
    b = (bias - mean_c * inv_c * scale).to(x.dtype)
    return x * a[:, None, None, :] + b[:, None, None, :]


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p, x, stride: int = 1, padding="SAME"):
    """NHWC conv. `padding` may be 'SAME', 'VALID', or an int. W8A8
    leaves {"wq", "ws", "b"?} take `quant.int8_conv2d`."""
    if "wq" in p:
        return quant.int8_conv2d(x, p["wq"], p["ws"], p.get("b"),
                                 stride=stride, padding=padding)
    w = p["w"].to(x.dtype)
    xc = x.permute(0, 3, 1, 2)                 # NCHW view, channels_last
    if padding == "VALID":
        pad = 0
    elif padding == "SAME":
        kh, kw = w.shape[2], w.shape[3]
        top, bot = _same_pads(x.shape[1], kh, stride)
        left, right = _same_pads(x.shape[2], kw, stride)
        if top == bot and left == right:
            pad = (top, left)
        else:
            xc = F.pad(xc, (left, right, top, bot))
            pad = 0
    else:
        pad = int(padding)
    y = F.conv2d(xc, w, None, stride, pad).permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def mha_apply(p, x, context=None, *, num_heads: int, causal: bool = False,
              attn_fn=None):
    """Standard MHA: projections here, the attention core in ops.attention.

    x: (B, T, D); context: (B, S, Dkv) or None for self-attention."""
    from gill_tpu_torch.ops.attention import dot_product_attention

    ctx = x if context is None else context
    b, t, d = x.shape
    s = ctx.shape[1]
    hd = d // num_heads
    q = linear(p["q"], x).reshape(b, t, num_heads, hd)
    k = linear(p["k"], ctx).reshape(b, s, num_heads, hd)
    v = linear(p["v"], ctx).reshape(b, s, num_heads, hd)
    fn = attn_fn or dot_product_attention
    o = fn(q, k, v, causal=causal)
    return linear(p["o"], o.reshape(b, t, d))
