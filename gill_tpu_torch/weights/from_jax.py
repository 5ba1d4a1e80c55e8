"""gill_tpu parameter trees -> this package's parameter trees.

The JAX trees (leaves as numpy arrays, e.g. from `jax.device_get`; layer
stacks along a leading L axis) carry over leaf by leaf with the same keys
and layouts, with one exception: a 4-D convolution kernel "w" is HWIO in
gill_tpu and becomes an OIHW view in channels_last memory here (the layout
`nn.core.conv2d` hands cuDNN). bf16 leaves stay bf16 unless `dtype` says
otherwise. The CPU parity tests and the end-to-end comparison use these.
Quantized LM trees (`quantize_params_w8`) carry over too: int8 "w8"
(L, K, N), fp32 "ws" (L, N), "b", and the empty-tuple "kern"/"xla"
markers, which stay empty tuples. Quantized UNet trees
(`unet.quantize_params`) carry over too: int8 "wq" (a 4-D conv "wq" goes
HWIO -> OIHW in channels_last memory like a float conv "w"; its int8
values are unchanged), fp32 "ws" (out,) and "b".
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gill_tpu_torch.nn.core import conv_weight_from_hwio


def _leaf(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: no torch view
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and torch.is_floating_point(t):
        t = t.to(dtype)
    return t.to(device)


def tree_from_jax(tree, *, device="cpu", dtype: Optional[torch.dtype] = None):
    """Converts any gill_tpu parameter (sub)tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("w", "wq") and not isinstance(v, (dict, list, tuple)) \
                    and np.ndim(v) == 4:
                out[k] = conv_weight_from_hwio(_leaf(v, device, dtype))
            elif k == "ws":                    # W8 / W8A8 scales stay fp32
                out[k] = tree_from_jax(v, device=device)
            else:
                out[k] = tree_from_jax(v, device=device, dtype=dtype)
        return out
    if isinstance(tree, tuple) and not tree:       # a static marker
        return ()
    if isinstance(tree, (list, tuple)):
        return [tree_from_jax(v, device=device, dtype=dtype) for v in tree]
    return _leaf(tree, device, dtype)


def tree_to_numpy(tree):
    """The inverse layout map: this package's tree -> numpy leaves in
    gill_tpu's layout (4-D "w" / "wq" OIHW -> HWIO; bf16 leaves as fp32,
    which holds them exactly). Lets a test make random weights with the
    fast torch init and hand the same values to gill_tpu."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("w", "wq") and torch.is_tensor(v) and v.ndim == 4:
                v = v.permute(2, 3, 1, 0)
            out[k] = tree_to_numpy(v)
        return out
    if isinstance(tree, tuple) and not tree:
        return ()
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.ascontiguousarray(t.numpy())


def _expect(tree, keys, what):
    missing = [k for k in keys if k not in tree]
    if missing:
        raise KeyError(f"{what} tree lacks {missing}")


def opt_from_jax(tree, **kw):
    _expect(tree, ("embed_tokens", "embed_positions", "layers"), "OPT")
    return tree_from_jax(tree, **kw)


def clip_vision_from_jax(tree, **kw):
    _expect(tree, ("patch_embedding", "layers", "post_ln"), "CLIP vision")
    return tree_from_jax(tree, **kw)


def clip_text_from_jax(tree, **kw):
    _expect(tree, ("token_embedding", "layers", "final_ln"), "CLIP text")
    return tree_from_jax(tree, **kw)


def adapters_from_jax(tree, **kw):
    _expect(tree, ("img_embeddings", "visual_embeddings", "ret_fc", "gen_fc"),
            "GILL adapters")
    return tree_from_jax(tree, **kw)


def unet_from_jax(tree, **kw):
    _expect(tree, ("conv_in", "down", "mid", "up"), "UNet")
    return tree_from_jax(tree, **kw)


def vae_decoder_from_jax(tree, **kw):
    _expect(tree, ("post_quant_conv", "mid", "up"), "VAE decoder")
    return tree_from_jax(tree, **kw)


def gill_params_from_jax(params, *, device="cpu"):
    """{"lm", "vision", "adapters"} as gill_tpu's load_gill holds them."""
    return {"lm": opt_from_jax(params["lm"], device=device),
            "vision": clip_vision_from_jax(params["vision"], device=device),
            "adapters": adapters_from_jax(params["adapters"], device=device)}


def sd_params_from_jax(params, *, device="cpu"):
    out = {"unet": unet_from_jax(params["unet"], device=device),
           "vae_decoder": vae_decoder_from_jax(params["vae_decoder"],
                                               device=device)}
    if "text_encoder" in params:
        out["text_encoder"] = clip_text_from_jax(params["text_encoder"],
                                                 device=device)
    return out
