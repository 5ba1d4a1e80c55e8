"""GILL's pieces around the LM, plain fp32: CLIP ViT image preprocessing and
vision tower, the visual prefix, the [IMG]-merged embedding table, the
GILLMapper (generation) and linear (retrieval) heads, and the byte-level
token ids of the benchmark's vocabulary."""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from gillbench.reference import layers as L

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_pixels(img: Image.Image, size: int = 224) -> np.ndarray:
    """Resize the shortest side (bicubic), center crop, CLIP-normalize:
    (size, size, 3) float32 (CLIP's published preprocessing)."""
    img = img.convert("RGB")
    w, h = img.size
    short = min(w, h)
    nw, nh = round(w * size / short), round(h * size / short)
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return (np.asarray(img, np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def vision_pooled(params, cfg: dict, pixels):
    """CLIP ViT pooler output (B, D) of NHWC pixels."""
    b = pixels.shape[0]
    p, d, heads = cfg["patch_size"], cfg["hidden_size"], \
        cfg["num_attention_heads"]
    eps = cfg.get("layer_norm_eps", 1e-5)
    x = torch.nn.functional.conv2d(
        L.rnd(pixels.permute(0, 3, 1, 2).float()),
        L.rnd(params["patch_embedding"]["w"].float()), stride=p)
    x = x.flatten(2).transpose(1, 2)
    cls = params["class_embedding"].float()[None, None].expand(b, 1, d)
    h = torch.cat([cls, x], 1) + params["position_embedding"]["weight"] \
        .float()[None]
    h = L.layer_norm(params["pre_ln"], h, eps)
    for i in range(cfg["num_hidden_layers"]):
        lp = L.layer(params["layers"], i)
        h = h + L.mha(lp["attn"], L.layer_norm(lp["ln1"], h, eps), None,
                      heads)
        x = L.layer_norm(lp["ln2"], h, eps)
        h = h + L.linear(lp["fc2"], quick_gelu(L.linear(lp["fc1"], x)))
    return L.layer_norm(params["post_ln"], h[:, 0], eps)


def visual_prefix(params, cfg: dict, pixels):
    """Captioning-mode visual tokens (B, n_visual_tokens, E)."""
    pooled = vision_pooled(params["vision"], cfg["clip"], pixels)
    v = L.linear(params["adapters"]["visual_embeddings"], pooled)
    return v.reshape(v.shape[0], cfg["gill"]["n_visual_tokens"], -1)


def retrieval_embedding(params, cfg: dict, pixels):
    """Retrieval-mode image embedding (B, ret_emb_dim), L2-normalized."""
    pooled = vision_pooled(params["vision"], cfg["clip"], pixels)
    v = L.linear(params["adapters"]["visual_fc"], pooled)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def merged_table(params, img0: int):
    """The LM's tied table with the learned [IMG] rows in place (fp32)."""
    table = params["lm"]["embed_tokens"]["weight"].float().clone()
    img = params["adapters"]["img_embeddings"].float()
    table[img0:img0 + img.shape[0]] = img
    return table


def gill_mapper(p, cfg: dict, x, input_embs):
    """GILLMapper: (x + input_embs) -> fc -> pre-norm transformer (encoder
    over the inputs, decoder over the learned queries) -> out (N, Q, out)."""
    heads, eps = cfg["heads"], cfg.get("layer_norm_eps", 1e-5)
    x = L.linear(p["fc"], x + input_embs)
    enc, dec = p["tfm"]["encoder"], p["tfm"]["decoder"]
    h = x
    for i in range(enc["layers"]["ln1"]["scale"].shape[0]):
        lp = L.layer(enc["layers"], i)
        h = h + L.mha(lp["self_attn"], L.layer_norm(lp["ln1"], h, eps), None,
                      heads)
        y = L.layer_norm(lp["ln2"], h, eps)
        h = h + L.linear(lp["fc2"], torch.relu(L.linear(lp["fc1"], y)))
    mem = L.layer_norm(enc["norm"], h, eps)
    q = p["query_embs"].float()
    h = q.expand((x.shape[0],) + tuple(q.shape[1:]))
    for i in range(dec["layers"]["ln1"]["scale"].shape[0]):
        lp = L.layer(dec["layers"], i)
        h = h + L.mha(lp["self_attn"], L.layer_norm(lp["ln1"], h, eps), None,
                      heads)
        h = h + L.mha(lp["cross_attn"], L.layer_norm(lp["ln2"], h, eps), mem,
                      heads)
        y = L.layer_norm(lp["ln3"], h, eps)
        h = h + L.linear(lp["fc2"], torch.relu(L.linear(lp["fc1"], y)))
    h = L.layer_norm(dec["norm"], h, eps)
    return L.linear(p["model"], h)


def bytes_to_unicode():
    """GPT-2's reversible byte -> printable character table."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


SPECIALS = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}


def byte_vocab(size: int) -> dict:
    """The benchmark's OPT-sized byte-level vocabulary: OPT's four specials,
    the 256 byte symbols, then unused fillers up to `size` entries."""
    vocab = dict(SPECIALS)
    for ch in bytes_to_unicode().values():
        vocab[ch] = len(vocab)
    i = 0
    while len(vocab) < size:
        vocab[f"<|unused{i}|>"] = len(vocab)
        i += 1
    return vocab


def text_ids(text: str, bos: bool = True) -> list:
    """Token ids of `text` under byte_vocab: one id a UTF-8 byte (no merges),
    OPT's BOS (</s>, id 2) first."""
    order = {b: 4 + i for i, b in enumerate(bytes_to_unicode())}
    ids = [order[b] for b in text.encode("utf-8")]
    return ([SPECIALS["</s>"]] if bos else []) + ids
