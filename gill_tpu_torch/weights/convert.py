"""torch / HF / diffusers state dicts -> parameter trees in gill_tpu's
layout (counterpart of gill_tpu/weights/convert.py, each converter its own
copy).

Layout rules, as gill_tpu's:

  * torch Linear stores (out, in); the tree stores (in, out)  -> transpose
  * torch Conv2d stores OIHW; the tree stores HWIO           -> (2, 3, 1, 0)
  * per-layer weights are stacked along a leading L axis

The converters take state dicts of torch tensors (weights/loader.py's
readers) and give trees of views and stacks of those tensors, on their
device and in their dtype. `weights/from_jax.tree_from_jax` then takes a
tree to this package's layout (4-D conv kernels HWIO -> OIHW in
channels_last memory).
"""

from __future__ import annotations

from typing import Dict

import torch


def _hwio(w):
    return w.permute(2, 3, 1, 0)


def _lin(sd, prefix) -> Dict:
    p = {"w": sd[prefix + ".weight"].T}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _ln(sd, prefix) -> Dict:
    return {"scale": sd[prefix + ".weight"],
            "bias": sd[prefix + ".bias"]}


def _conv(sd, prefix) -> Dict:
    p = {"w": _hwio(sd[prefix + ".weight"])}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _stack(dicts):
    """List of identical-structure dicts -> one dict with stacked leaves."""
    first = dicts[0]
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in dicts]) for k in first}
    return torch.stack(dicts)


# ---------------------------------------------------------------------------
# OPT
# ---------------------------------------------------------------------------

def opt_from_torch(sd, cfg) -> dict:
    """HF OPTForCausalLM state_dict -> models/opt.py params."""
    sd = {k.replace("model.decoder.", "dec."): v for k, v in sd.items()}
    layers = []
    for i in range(cfg.num_layers):
        p = f"dec.layers.{i}"
        layers.append({
            "attn": {
                "q": _lin(sd, f"{p}.self_attn.q_proj"),
                "k": _lin(sd, f"{p}.self_attn.k_proj"),
                "v": _lin(sd, f"{p}.self_attn.v_proj"),
                "o": _lin(sd, f"{p}.self_attn.out_proj"),
            },
            "attn_ln": _ln(sd, f"{p}.self_attn_layer_norm"),
            "fc1": _lin(sd, f"{p}.fc1"),
            "fc2": _lin(sd, f"{p}.fc2"),
            "mlp_ln": _ln(sd, f"{p}.final_layer_norm"),
        })
    params = {
        "embed_tokens": {"weight": sd["dec.embed_tokens.weight"]},
        "embed_positions": {"weight": sd["dec.embed_positions.weight"]},
        "layers": _stack(layers),
    }
    if "dec.final_layer_norm.weight" in sd and cfg.do_layer_norm_before:
        params["final_ln"] = _ln(sd, "dec.final_layer_norm")
    if "dec.project_in.weight" in sd:
        params["project_in"] = _lin(sd, "dec.project_in")
        params["project_out"] = _lin(sd, "dec.project_out")
    return params


# ---------------------------------------------------------------------------
# CLIP vision / text towers
# ---------------------------------------------------------------------------

def _clip_layers(sd, n: int) -> dict:
    layers = []
    for i in range(n):
        p = f"encoder.layers.{i}"
        layers.append({
            "ln1": _ln(sd, f"{p}.layer_norm1"),
            "attn": {
                "q": _lin(sd, f"{p}.self_attn.q_proj"),
                "k": _lin(sd, f"{p}.self_attn.k_proj"),
                "v": _lin(sd, f"{p}.self_attn.v_proj"),
                "o": _lin(sd, f"{p}.self_attn.out_proj"),
            },
            "ln2": _ln(sd, f"{p}.layer_norm2"),
            "fc1": _lin(sd, f"{p}.mlp.fc1"),
            "fc2": _lin(sd, f"{p}.mlp.fc2"),
        })
    return _stack(layers)


def clip_vision_from_torch(sd, cfg) -> dict:
    """HF CLIPVisionModel (or CLIPModel) state_dict -> models/clip.py
    vision params; `visual_projection` when the dict holds one."""
    sd = {k.replace("vision_model.", ""): v for k, v in sd.items()}
    out = {
        "class_embedding": sd["embeddings.class_embedding"],
        "patch_embedding": {
            "w": _hwio(sd["embeddings.patch_embedding.weight"])},
        "position_embedding": {
            "weight": sd["embeddings.position_embedding.weight"]},
        "pre_ln": _ln(sd, "pre_layrnorm"),  # (sic) HF attribute name
        "layers": _clip_layers(sd, cfg.num_layers),
        "post_ln": _ln(sd, "post_layernorm"),
    }
    if "visual_projection.weight" in sd:
        out["visual_projection"] = _lin(sd, "visual_projection")
    return out


def safety_checker_from_torch(sd, cfg) -> dict:
    """diffusers `StableDiffusionSafetyChecker` state_dict -> models/
    safety.py params: vision_model.vision_model.* (the CLIP ViT tower),
    visual_projection (bias-free) and the concept / special-care
    embeddings with their thresholds."""
    vis_sd = {k[len("vision_model."):]: v for k, v in sd.items()
              if k.startswith("vision_model.")}
    vis_sd["visual_projection.weight"] = sd["visual_projection.weight"]
    params = {
        "vision": clip_vision_from_torch(vis_sd, cfg.vision),
        "concept_embeds": sd["concept_embeds"],
        "special_care_embeds": sd["special_care_embeds"],
        "concept_embeds_weights": sd["concept_embeds_weights"],
        "special_care_embeds_weights": sd["special_care_embeds_weights"],
    }
    assert tuple(params["concept_embeds"].shape) == (cfg.num_concepts,
                                                     cfg.projection_dim)
    assert tuple(params["special_care_embeds"].shape) == (cfg.num_special,
                                                          cfg.projection_dim)
    return params


def clip_text_from_torch(sd, cfg) -> dict:
    """HF CLIPTextModel state_dict -> models/clip.py text params."""
    sd = {k.replace("text_model.", ""): v for k, v in sd.items()}
    return {
        "token_embedding": {
            "weight": sd["embeddings.token_embedding.weight"]},
        "position_embedding": {
            "weight": sd["embeddings.position_embedding.weight"]},
        "layers": _clip_layers(sd, cfg.num_layers),
        "final_ln": _ln(sd, "final_layer_norm"),
    }


# ---------------------------------------------------------------------------
# torch.nn.Transformer (the gill_mapper core)
# ---------------------------------------------------------------------------

def _torch_mha(sd, prefix, d_model: int) -> dict:
    """torch.nn.MultiheadAttention packed in_proj -> split q/k/v + out."""
    w = sd[prefix + ".in_proj_weight"]  # (3D, D)
    b = sd[prefix + ".in_proj_bias"]    # (3D,)
    return {
        "q": {"w": w[:d_model].T, "b": b[:d_model]},
        "k": {"w": w[d_model:2 * d_model].T, "b": b[d_model:2 * d_model]},
        "v": {"w": w[2 * d_model:].T, "b": b[2 * d_model:]},
        "o": _lin(sd, prefix + ".out_proj"),
    }


def torch_transformer_from_torch(sd, prefix: str, d_model: int,
                                 num_encoder_layers: int,
                                 num_decoder_layers: int) -> dict:
    """torch.nn.Transformer state_dict subtree -> mapper params (encoder /
    decoder layers with norm_first=True, reference gill/layers.py:20-22)."""
    enc_layers, dec_layers = [], []
    for i in range(num_encoder_layers):
        p = f"{prefix}encoder.layers.{i}"
        enc_layers.append({
            "self_attn": _torch_mha(sd, f"{p}.self_attn", d_model),
            "ln1": _ln(sd, f"{p}.norm1"),
            "fc1": _lin(sd, f"{p}.linear1"),
            "fc2": _lin(sd, f"{p}.linear2"),
            "ln2": _ln(sd, f"{p}.norm2"),
        })
    for i in range(num_decoder_layers):
        p = f"{prefix}decoder.layers.{i}"
        dec_layers.append({
            "self_attn": _torch_mha(sd, f"{p}.self_attn", d_model),
            "cross_attn": _torch_mha(sd, f"{p}.multihead_attn", d_model),
            "ln1": _ln(sd, f"{p}.norm1"),
            "ln2": _ln(sd, f"{p}.norm2"),
            "ln3": _ln(sd, f"{p}.norm3"),
            "fc1": _lin(sd, f"{p}.linear1"),
            "fc2": _lin(sd, f"{p}.linear2"),
        })
    return {
        "encoder": {"layers": _stack(enc_layers),
                    "norm": _ln(sd, f"{prefix}encoder.norm")},
        "decoder": {"layers": _stack(dec_layers),
                    "norm": _ln(sd, f"{prefix}decoder.norm")},
    }


def text_fc_layer_from_torch(sd, prefix: str, mode: str, d_model: int = 512,
                             num_encoder_layers: int = 4,
                             num_decoder_layers: int = 4) -> dict:
    """Reference TextFcLayer weights (gill/layers.py) -> mapper params."""
    if mode == "linear":
        return {"model": _lin(sd, prefix + "model")}
    assert mode == "gill_mapper", mode
    return {
        "fc": _lin(sd, prefix + "fc"),
        "tfm": torch_transformer_from_torch(
            sd, prefix + "tfm.", d_model, num_encoder_layers,
            num_decoder_layers),
        "model": _lin(sd, prefix + "model"),
        "query_embs": sd[prefix + "query_embs"],
    }


# ---------------------------------------------------------------------------
# Stable Diffusion (diffusers UNet2DConditionModel / AutoencoderKL)
# ---------------------------------------------------------------------------

class _Tracked:
    """Wraps a state dict and records the keys read, so a converter can
    assert full coverage (architecture drift against a real checkpoint)."""

    def __init__(self, sd):
        self.sd = sd
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return self.sd[k]

    def __contains__(self, k):
        return k in self.sd

    def unused(self, prefix=""):
        return [k for k in self.sd
                if k.startswith(prefix) and k not in self.used]


_gn = _ln


def _sd_resnet(sd, p, has_temb=True):
    out = {
        "norm1": _gn(sd, f"{p}.norm1"),
        "conv1": _conv(sd, f"{p}.conv1"),
        "norm2": _gn(sd, f"{p}.norm2"),
        "conv2": _conv(sd, f"{p}.conv2"),
    }
    if has_temb and f"{p}.time_emb_proj.weight" in sd:
        out["time_emb"] = _lin(sd, f"{p}.time_emb_proj")
    if f"{p}.conv_shortcut.weight" in sd:
        out["shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return out


def _sd_attn_proj(sd, p):
    return {"q": _lin(sd, f"{p}.to_q"), "k": _lin(sd, f"{p}.to_k"),
            "v": _lin(sd, f"{p}.to_v"), "o": _lin(sd, f"{p}.to_out.0")}


def _sd_spatial_tfm(sd, p):
    tb = f"{p}.transformer_blocks.0"
    return {
        "norm": _gn(sd, f"{p}.norm"),
        "proj_in": _conv(sd, f"{p}.proj_in"),
        "block": {
            "ln1": _ln(sd, f"{tb}.norm1"),
            "attn1": _sd_attn_proj(sd, f"{tb}.attn1"),
            "ln2": _ln(sd, f"{tb}.norm2"),
            "attn2": _sd_attn_proj(sd, f"{tb}.attn2"),
            "ln3": _ln(sd, f"{tb}.norm3"),
            "geglu": _lin(sd, f"{tb}.ff.net.0.proj"),
            "ff_out": _lin(sd, f"{tb}.ff.net.2"),
        },
        "proj_out": _conv(sd, f"{p}.proj_out"),
    }


def sd_unet_from_torch(sd_raw, cfg) -> dict:
    """diffusers UNet2DConditionModel state_dict -> models/sd/unet.py
    params. Every key must be read."""
    sd = _Tracked(sd_raw)
    params = {
        "conv_in": _conv(sd, "conv_in"),
        "time_fc1": _lin(sd, "time_embedding.linear_1"),
        "time_fc2": _lin(sd, "time_embedding.linear_2"),
        "down": [], "up": [],
        "norm_out": _gn(sd, "conv_norm_out"),
        "conv_out": _conv(sd, "conv_out"),
    }
    for i, btype in enumerate(cfg.down_block_types):
        p = f"down_blocks.{i}"
        block = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_sd_resnet(sd, f"{p}.resnets.{j}"))
            if btype == "CrossAttnDownBlock2D":
                block["attns"].append(_sd_spatial_tfm(sd, f"{p}.attentions.{j}"))
        if f"{p}.downsamplers.0.conv.weight" in sd:
            block["downsample"] = _conv(sd, f"{p}.downsamplers.0.conv")
        params["down"].append(block)
    params["mid"] = {
        "res1": _sd_resnet(sd, "mid_block.resnets.0"),
        "attn": _sd_spatial_tfm(sd, "mid_block.attentions.0"),
        "res2": _sd_resnet(sd, "mid_block.resnets.1"),
    }
    for i, btype in enumerate(cfg.up_block_types):
        p = f"up_blocks.{i}"
        block = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block + 1):
            block["resnets"].append(_sd_resnet(sd, f"{p}.resnets.{j}"))
            if btype == "CrossAttnUpBlock2D":
                block["attns"].append(_sd_spatial_tfm(sd, f"{p}.attentions.{j}"))
        if f"{p}.upsamplers.0.conv.weight" in sd:
            block["upsample"] = _conv(sd, f"{p}.upsamplers.0.conv")
        params["up"].append(block)
    leftover = sd.unused()
    assert not leftover, f"unconverted UNet keys: {leftover[:8]}"
    return params


def _sd_vae_attn(sd, p):
    """The VAE's bottleneck attention in either diffusers key style (new:
    to_q / group_norm / to_out.0; old: query / norm / proj_attn), with
    Linear or 1x1-conv weights."""
    def pick(*names):
        for n in names:
            if f"{p}.{n}.weight" in sd:
                return n
        raise KeyError(f"none of {names} under {p}")

    def lin_sq(name):
        w = sd[f"{p}.{name}.weight"]
        if w.ndim == 4:
            w = w[:, :, 0, 0]
        return {"w": w.T, "b": sd[f"{p}.{name}.bias"]}

    return {
        "norm": _gn(sd, f"{p}.{pick('group_norm', 'norm')}"),
        "q": lin_sq(pick("to_q", "query")),
        "k": lin_sq(pick("to_k", "key")),
        "v": lin_sq(pick("to_v", "value")),
        "o": lin_sq("to_out.0" if f"{p}.to_out.0.weight" in sd
                    else "proj_attn"),
    }


def sd_vae_decoder_from_torch(sd_raw, cfg) -> dict:
    """diffusers AutoencoderKL state_dict -> models/sd/vae.py decoder
    params. Every decoder.* and post_quant* key must be read."""
    sd = _Tracked(sd_raw)
    rev = list(reversed(cfg.block_out_channels))
    params = {
        "post_quant_conv": _conv(sd, "post_quant_conv"),
        "conv_in": _conv(sd, "decoder.conv_in"),
        "mid": {
            "res1": _sd_resnet(sd, "decoder.mid_block.resnets.0", False),
            "attn": _sd_vae_attn(sd, "decoder.mid_block.attentions.0"),
            "res2": _sd_resnet(sd, "decoder.mid_block.resnets.1", False),
        },
        "up": [],
        "norm_out": _gn(sd, "decoder.conv_norm_out"),
        "conv_out": _conv(sd, "decoder.conv_out"),
    }
    for i in range(len(rev)):
        p = f"decoder.up_blocks.{i}"
        block = {"resnets": [
            _sd_resnet(sd, f"{p}.resnets.{j}", False)
            for j in range(cfg.layers_per_block + 1)]}
        if f"{p}.upsamplers.0.conv.weight" in sd:
            block["upsample"] = _conv(sd, f"{p}.upsamplers.0.conv")
        params["up"].append(block)
    leftover = sd.unused("decoder.") + sd.unused("post_quant")
    assert not leftover, f"unconverted VAE decoder keys: {leftover[:8]}"
    return params


def sd_vae_encoder_from_torch(sd_raw, cfg) -> dict:
    """diffusers AutoencoderKL state_dict -> models/sd/vae.py encoder
    params (gill_tpu's converter checks no coverage here; nor does this)."""
    sd = _Tracked(sd_raw)
    params = {
        "conv_in": _conv(sd, "encoder.conv_in"),
        "down": [],
        "mid": {
            "res1": _sd_resnet(sd, "encoder.mid_block.resnets.0", False),
            "attn": _sd_vae_attn(sd, "encoder.mid_block.attentions.0"),
            "res2": _sd_resnet(sd, "encoder.mid_block.resnets.1", False),
        },
        "norm_out": _gn(sd, "encoder.conv_norm_out"),
        "conv_out": _conv(sd, "encoder.conv_out"),
        "quant_conv": _conv(sd, "quant_conv"),
    }
    for i in range(len(cfg.block_out_channels)):
        p = f"encoder.down_blocks.{i}"
        block = {"resnets": [
            _sd_resnet(sd, f"{p}.resnets.{j}", False)
            for j in range(cfg.layers_per_block)]}
        if f"{p}.downsamplers.0.conv.weight" in sd:
            block["downsample"] = _conv(sd, f"{p}.downsamplers.0.conv")
        params["down"].append(block)
    return params
