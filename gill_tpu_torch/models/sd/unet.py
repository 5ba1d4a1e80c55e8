"""Stable Diffusion v1.5 UNet (UNet2DConditionModel) over explicit
parameter trees, NHWC activations.

Counterpart of gill_tpu/models/sd/unet.py: 4 -> 4 channels, blocks
(320, 640, 1280, 1280), 2 layers per block, cross-attention on 77 x 768
text states, 8 heads; down (CrossAttn x3 + plain) / mid (res-attn-res) /
up (plain + CrossAttn x3).

On CUDA, attention over >= 64 spatial tokens (self and the 77-token
cross-attention) runs the flash kernel at the TRUE head dim (40/80/160),
and every transformer feed-forward runs the fused GEGLU kernel. gill_tpu's
TPU-only knobs (128-lane head padding of the projections, SUM_LANE,
OPROJ_SLICE) are not ported; they change nothing in the output.

The non-default modes follow gill_tpu's dispatch, with "the tensor lies on
a CUDA device" deciding kernel or plain version inside each wrapper (the
CPU runs the same branches on the plain versions; gill_tpu takes them only
on a TPU):
  * GILL_SD_FUSE_LN=1 (`FUSE_LN`, read at import, looked up at call time):
    at head dims < 128 and without q8, self-attention's q/k/v come from
    one LN-folded stacked projection (ops/ln_matmul.py K8 over the (3, d, d)
    stacked weights, built once per parameter tree) and cross-attention's
    q from the LN-folded K7, k and v being plain products of the context;
    every feed-forward without int8 weights folds its LayerNorm into the
    GEGLU kernel (K9);
  * `apply(..., q8=True)`: attention at head dims < 128 takes the int8-QK
    kernel (K10);
  * `quantize_params`: the W8A8 weights of sd_precision="int8" (convs and
    linears except the attention projections and the time MLPs); their
    feed-forward is the composed LN, int8 linear, erf gelu, int8 linear.
At head dim 160 (the 16 x 16, 8 x 8 and mid blocks) FUSE_LN's attention
fold and q8 do not apply, as in gill_tpu.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from gill_tpu_torch.config import UNetConfig
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.ops import attention as attn_ops
from gill_tpu_torch.ops import ln_matmul as ln_ops
from gill_tpu_torch.ops.attention import dot_product_attention
from gill_tpu_torch.ops.geglu import geglu_ff
from gill_tpu_torch.ops.quant import quantize_weight

FUSE_LN = os.environ.get("GILL_SD_FUSE_LN", "0") == "1"


def timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10000.0):
    """Sinusoidal embedding (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_resnet(init: nn.Init, in_ch, out_ch, temb_dim):
    p = {"norm1": init.group_norm(in_ch),
         "conv1": init.conv2d(in_ch, out_ch, 3),
         "norm2": init.group_norm(out_ch),
         "conv2": init.conv2d(out_ch, out_ch, 3)}
    if temb_dim:
        p["time_emb"] = init.linear(temb_dim, out_ch)
    if in_ch != out_ch:
        p["shortcut"] = init.conv2d(in_ch, out_ch, 1)
    return p


def _init_attn_proj(init: nn.Init, dim, ctx_dim):
    return {"q": init.linear(dim, dim, bias=False),
            "k": init.linear(ctx_dim, dim, bias=False),
            "v": init.linear(ctx_dim, dim, bias=False),
            "o": init.linear(dim, dim)}


def _init_spatial_tfm(init: nn.Init, ch, ctx_dim):
    return {
        "norm": init.group_norm(ch),
        "proj_in": init.conv2d(ch, ch, 1),
        "block": {"ln1": init.layer_norm(ch),
                  "attn1": _init_attn_proj(init, ch, ch),
                  "ln2": init.layer_norm(ch),
                  "attn2": _init_attn_proj(init, ch, ctx_dim),
                  "ln3": init.layer_norm(ch),
                  "geglu": init.linear(ch, ch * 8),
                  "ff_out": init.linear(ch * 4, ch)},
        "proj_out": init.conv2d(ch, ch, 1),
    }


def init(init: nn.Init, cfg: UNetConfig):
    ch0, temb = cfg.block_out_channels[0], cfg.time_embed_dim
    params = {
        "conv_in": init.conv2d(cfg.in_channels, ch0, 3),
        "time_fc1": init.linear(ch0, temb),
        "time_fc2": init.linear(temb, temb),
        "down": [], "up": [],
        "norm_out": init.group_norm(ch0),
        "conv_out": init.conv2d(ch0, cfg.out_channels, 3),
    }
    out_ch = ch0
    for i, btype in enumerate(cfg.down_block_types):
        in_ch, out_ch = out_ch, cfg.block_out_channels[i]
        block = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_init_resnet(
                init, in_ch if j == 0 else out_ch, out_ch, temb))
            if btype == "CrossAttnDownBlock2D":
                block["attns"].append(_init_spatial_tfm(
                    init, out_ch, cfg.cross_attention_dim))
        if i < len(cfg.down_block_types) - 1:
            block["downsample"] = init.conv2d(out_ch, out_ch, 3)
        params["down"].append(block)

    mid_ch = cfg.block_out_channels[-1]
    params["mid"] = {
        "res1": _init_resnet(init, mid_ch, mid_ch, temb),
        "attn": _init_spatial_tfm(init, mid_ch, cfg.cross_attention_dim),
        "res2": _init_resnet(init, mid_ch, mid_ch, temb),
    }

    rev = list(reversed(cfg.block_out_channels))
    prev_ch = mid_ch
    for i, btype in enumerate(cfg.up_block_types):
        out_ch = rev[i]
        skip_in_ch = rev[min(i + 1, len(rev) - 1)]
        block = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block + 1):
            res_skip = skip_in_ch if j == cfg.layers_per_block else out_ch
            res_in = prev_ch if j == 0 else out_ch
            block["resnets"].append(_init_resnet(
                init, res_in + res_skip, out_ch, temb))
            if btype == "CrossAttnUpBlock2D":
                block["attns"].append(_init_spatial_tfm(
                    init, out_ch, cfg.cross_attention_dim))
        if i < len(cfg.up_block_types) - 1:
            block["upsample"] = init.conv2d(out_ch, out_ch, 3)
        params["up"].append(block)
        prev_ch = out_ch
    return params


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _resnet(p, x, temb, groups: int):
    h = nn.group_norm(p["norm1"], x, groups, eps=1e-5)
    h = nn.conv2d(p["conv1"], F.silu(h), padding=1)
    if "time_emb" in p and temb is not None:
        h = h + nn.linear(p["time_emb"], F.silu(temb))[:, None, None, :]
    h = nn.group_norm(p["norm2"], h, groups, eps=1e-5)
    h = nn.conv2d(p["conv2"], F.silu(h), padding=1)
    if "shortcut" in p:
        x = nn.conv2d(p["shortcut"], x, padding=0)
    return x + h


# (3, d, d) stacked q/k/v weights of a self-attention, built once per
# parameter tree: keyed by the q weight tensor, checked against the k and v
# tensors and the dtype it was built from
_QKV = WeakIdKeyDictionary()


def _stacked_qkv(p, dtype):
    wq, wk, wv = (p[n]["w"] for n in "qkv")
    hit = _QKV.get(wq)
    if hit is None or hit[0] is not wk or hit[1] is not wv \
            or hit[2].dtype != dtype:
        hit = (wk, wv, torch.stack([w.to(dtype) for w in (wq, wk, wv)]))
        _QKV[wq] = hit
    return hit[2]


def _attention(p, x, ctx, num_heads: int, ln, q8: bool = False):
    """Pre-LayerNorm attention; ctx None = self-attention over the
    normalized x. On CUDA, >= 64 query tokens force the flash kernel, the
    77-key cross-attention included (gill_tpu's impl='flash' gate); see the
    module docstring for FUSE_LN and q8."""
    b, t, d = x.shape
    hd = d // num_heads
    self_attn = ctx is None
    impl = "flash" if (x.is_cuda and t >= 64) else "auto"
    if FUSE_LN and hd < 128 and not q8:
        assert all("b" not in p[n] for n in "qkv"), \
            "fused-LN path assumes bias-free q/k/v projections"
        gamma, beta = ln["scale"].to(x.dtype), ln["bias"].to(x.dtype)
        if self_attn:
            qkv = ln_ops.ln_matmul_stacked(x, gamma, beta,
                                           _stacked_qkv(p, x.dtype))
            q, k, v = (y.reshape(b, t, num_heads, hd) for y in qkv.unbind(0))
        else:
            s = ctx.shape[1]
            q = ln_ops.ln_matmul(x, gamma, beta, p["q"]["w"].to(x.dtype)
                                 ).reshape(b, t, num_heads, hd)
            k = (ctx @ p["k"]["w"].to(x.dtype)).reshape(b, s, num_heads, hd)
            v = (ctx @ p["v"]["w"].to(x.dtype)).reshape(b, s, num_heads, hd)
        o = dot_product_attention(q, k, v, causal=False, fast=True, impl=impl)
        return nn.linear(p["o"], o.reshape(b, t, d))
    x = nn.layer_norm(ln, x, 1e-5)
    ctx = x if self_attn else ctx
    s = ctx.shape[1]
    q = nn.linear(p["q"], x).reshape(b, t, num_heads, hd)
    k = nn.linear(p["k"], ctx).reshape(b, s, num_heads, hd)
    v = nn.linear(p["v"], ctx).reshape(b, s, num_heads, hd)
    if q8 and hd < 128:
        o = attn_ops.flash_attention_q8(q, k, v, scale=1.0 / math.sqrt(hd))
    else:
        o = dot_product_attention(q, k, v, causal=False, fast=True, impl=impl)
    return nn.linear(p["o"], o.reshape(b, t, d))


def quantize_params(params):
    """One-time int8 W8A8 quantization of the UNet tree (gill_tpu
    `unet.quantize_params`): every 2-D linear and 4-D conv weight becomes
    {"wq", "ws", "b"?} with per-output-channel scales (a conv's wq OIHW in
    channels_last memory, see ops/quant.py), except the attention
    projections and the time-embedding MLPs, which stay as they are."""
    skip = ("attn1", "attn2", "time_fc1", "time_fc2", "time_emb")

    def rec(node, path):
        if isinstance(node, dict):
            w = node.get("w")
            if torch.is_tensor(w) and w.ndim in (2, 4):
                if any(k in path for k in skip):
                    return node
                if w.ndim == 2:
                    wq, ws = quantize_weight(w, reduce_axes=(0,))
                else:
                    wq, ws = quantize_weight(w, reduce_axes=(1, 2, 3))
                    wq = wq.contiguous(memory_format=torch.channels_last)
                out = {"wq": wq, "ws": ws}
                if "b" in node:
                    out["b"] = node["b"]
                return out
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v, path) for v in node]
        return node

    return rec(params, ())


def _geglu_ff(p, h, ln):
    """GEGLU feed-forward with the block's third LayerNorm: int8 weights
    take the composed path (LN, int8 linear, exact-erf gelu, int8 linear);
    otherwise the fused kernel on CUDA (with the LayerNorm folded in under
    FUSE_LN), the composed ops on the CPU."""
    if "wq" in p["geglu"]:
        h = nn.linear(p["geglu"], nn.layer_norm(ln, h, 1e-5))
        val, gate = h.chunk(2, dim=-1)
        return nn.linear(p["ff_out"], val * F.gelu(gate))
    weights = (p["geglu"]["w"].to(h.dtype), p["geglu"]["b"].to(h.dtype),
               p["ff_out"]["w"].to(h.dtype), p["ff_out"]["b"].to(h.dtype))
    if FUSE_LN:
        return geglu_ff(h, *weights, ln_gamma=ln["scale"].to(h.dtype),
                        ln_beta=ln["bias"].to(h.dtype), ln_eps=1e-5)
    return geglu_ff(nn.layer_norm(ln, h, 1e-5), *weights)


def _tfm_block(p, x, ctx, num_heads: int, q8: bool):
    x = x + _attention(p["attn1"], x, None, num_heads, p["ln1"], q8)
    x = x + _attention(p["attn2"], x, ctx, num_heads, p["ln2"], q8)
    return x + _geglu_ff(p, x, p["ln3"])


def _spatial_tfm(p, x, ctx, num_heads: int, groups: int, q8: bool):
    b, h, w, c = x.shape
    y = nn.group_norm(p["norm"], x, groups, eps=1e-6)
    y = nn.conv2d(p["proj_in"], y, padding=0).reshape(b, h * w, c)
    y = _tfm_block(p["block"], y, ctx, num_heads, q8).reshape(b, h, w, c)
    return nn.conv2d(p["proj_out"], y, padding=0) + x


def upsample_nearest2x(x):
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def apply(params, cfg: UNetConfig, latents, timesteps, encoder_hidden_states,
          q8: bool = False):
    """latents (B, H, W, 4) NHWC; timesteps (B,) or scalar; encoder states
    (B, 77, 768). Returns the predicted noise (B, H, W, 4). q8: int8-QK
    attention (gill_tpu `_flash_kernel_i8`; the pipeline never sets it)."""
    x = latents
    timesteps = torch.as_tensor(timesteps, device=x.device)
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(x.shape[0])
    temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                              cfg.flip_sin_to_cos, cfg.freq_shift)
    temb = nn.linear(params["time_fc2"], F.silu(
        nn.linear(params["time_fc1"], temb.to(x.dtype))))
    ctx = encoder_hidden_states.to(x.dtype)
    g, nh = cfg.norm_groups, cfg.num_heads

    x = nn.conv2d(params["conv_in"], x, padding=1)
    skips = [x]
    for block in params["down"]:
        for j, res in enumerate(block["resnets"]):
            x = _resnet(res, x, temb, g)
            if block["attns"]:
                x = _spatial_tfm(block["attns"][j], x, ctx, nh, g, q8)
            skips.append(x)
        if "downsample" in block:
            x = nn.conv2d(block["downsample"], x, stride=2, padding=1)
            skips.append(x)

    x = _resnet(params["mid"]["res1"], x, temb, g)
    x = _spatial_tfm(params["mid"]["attn"], x, ctx, nh, g, q8)
    x = _resnet(params["mid"]["res2"], x, temb, g)

    for block in params["up"]:
        for j, res in enumerate(block["resnets"]):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = _resnet(res, x, temb, g)
            if block["attns"]:
                x = _spatial_tfm(block["attns"][j], x, ctx, nh, g, q8)
        if "upsample" in block:
            x = nn.conv2d(block["upsample"], upsample_nearest2x(x), padding=1)

    x = nn.group_norm(params["norm_out"], x, g, eps=1e-5)
    return nn.conv2d(params["conv_out"], F.silu(x), padding=1)
