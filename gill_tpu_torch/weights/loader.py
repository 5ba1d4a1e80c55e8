"""Frozen-backbone weight loading from local HF / diffusers directories
(counterpart of gill_tpu/weights/loader.py and of gill_tpu/api.py's SD
loading; the reference downloads from the hub at run time,
gill/models.py:56-96, this package reads local directories only).

Search order for `<weights_root>/<model-name-with-dashes>/`: `*.safetensors`
(a pure-Python reader, no `safetensors` package needed), then
`pytorch_model*.bin` (torch.load). No directory found: seeded random init
with a loud warning, as gill_tpu does (smoke runs and benchmarks).

The readers yield torch tensors on `device` (the card unless the caller
names another), each sent there as it is read, floating ones in `dtype`
(given None, the file's dtype with BF16 upcast to fp32, as gill_tpu's
numpy reader gives): a loader holds one host copy of one tensor at a time,
not two whole trees, and the converters of weights/convert.py then make
views and stacks on the device.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, Iterator, Optional, Tuple

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _safetensors_entries(path: str) -> Iterator[Tuple[str, str, list, int,
                                                      int]]:
    """(name, dtype, shape, offset, nbytes) of each tensor of a file."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    base = 8 + hlen
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        yield name, info["dtype"], info["shape"], base + start, end - start


def _to(t: torch.Tensor, device, dtype) -> torch.Tensor:
    if dtype is None and t.dtype == torch.bfloat16:
        dtype = torch.float32
    if dtype is not None and torch.is_floating_point(t):
        return t.to(device=device, dtype=dtype)
    return t.to(device)


def read_safetensors(path: str, *, device="cuda",
                     dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """Minimal pure-Python safetensors reader: each tensor on `device`,
    floating ones in `dtype` (None: as stored, BF16 upcast to fp32)."""
    out = {}
    with open(path, "rb") as f:
        for name, dt, shape, off, n in _safetensors_entries(path):
            f.seek(off)
            buf = bytearray(n)
            f.readinto(buf)
            t = (torch.frombuffer(buf, dtype=_DTYPES[dt]) if n
                 else torch.empty(0, dtype=_DTYPES[dt]))
            out[name] = _to(t.reshape(shape), device, dtype)
    return out


def load_state_dict_dir(model_dir: str, *, device="cuda",
                        dtype: Optional[torch.dtype] = None
                        ) -> Dict[str, torch.Tensor]:
    """Merges every weight shard of a directory into one state dict of
    tensors on `device`, floating ones in `dtype` (as `read_safetensors`)."""
    st_files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    bin_files = sorted(glob.glob(os.path.join(model_dir,
                                              "pytorch_model*.bin")))
    if not st_files and not bin_files:
        raise FileNotFoundError(
            f"No *.safetensors or pytorch_model*.bin in {model_dir}")
    sd: Dict[str, torch.Tensor] = {}
    for p in st_files:
        sd.update(read_safetensors(p, device=device, dtype=dtype))
    if st_files:
        return sd
    for p in bin_files:
        try:        # zip-format files map their storage, one tensor paged in
            blob = torch.load(p, map_location="cpu", weights_only=True,
                              mmap=True)
        except RuntimeError:                    # the legacy pickle format
            blob = torch.load(p, map_location="cpu", weights_only=True)
        for k in list(blob):
            sd[k] = _to(blob.pop(k), device, dtype)
    return sd


def _has_weights(d: str) -> bool:
    return bool(glob.glob(os.path.join(d, "*.safetensors"))
                or glob.glob(os.path.join(d, "pytorch_model*.bin")))


def _model_dir(name: str, weights_root: Optional[str],
               holds=_has_weights) -> Optional[str]:
    """The first of `<root>/<org>--<name>`, `<root>/<name>`, `<root>` (for
    `weights_root`, then `<env>/<org>--<name>`, `<env>/<name>` for
    GILL_TPU_WEIGHTS_DIR) that is a directory `holds` accepts: by default
    one with weight files."""
    candidates = []
    if weights_root:
        candidates += [os.path.join(weights_root, name.replace("/", "--")),
                       os.path.join(weights_root, name.split("/")[-1]),
                       weights_root]
    env = os.environ.get("GILL_TPU_WEIGHTS_DIR")
    if env:
        candidates += [os.path.join(env, name.replace("/", "--")),
                       os.path.join(env, name.split("/")[-1])]
    for c in candidates:
        if c and os.path.isdir(c) and holds(c):
            return c
    return None


def _init(generator, device, dtype, seed: int):
    from gill_tpu_torch.nn.core import Init

    g = generator if generator is not None else \
        torch.Generator(torch.device(device)).manual_seed(seed)
    return Init(g, device, dtype)


def load_opt(name: str, cfg, vocab_len: int, weights_root=None,
             seed: int = 0, *, device="cuda", dtype=torch.bfloat16,
             generator: Optional[torch.Generator] = None):
    """Frozen OPT params on `device` in `dtype`, the embedding table grown
    to vocab_len with N(0, 0.02) rows. `generator` (default: seeded with
    `seed`, on `device`) draws the random init when no directory is found
    and the new rows, which therefore differ from gill_tpu's threefry
    draws by design."""
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.weights.convert import opt_from_torch
    from gill_tpu_torch.weights.from_jax import opt_from_jax

    init = _init(generator, device, dtype, seed)
    d = _model_dir(name, weights_root)
    if d is None:
        print(f"WARNING: no local weights for {name}; using random init "
              f"(set GILL_TPU_WEIGHTS_DIR for real weights).", flush=True)
        params = opt_mod.init(init, cfg)
    else:
        sd = load_state_dict_dir(d, device=device, dtype=dtype)
        params = opt_from_jax(opt_from_torch(sd, cfg), device=device,
                              dtype=dtype)
        del sd
    return opt_mod.resize_embeddings(params, vocab_len, init)


def load_clip_vision(name: str, cfg, weights_root=None, seed: int = 0, *,
                     device="cuda", dtype=torch.bfloat16,
                     generator: Optional[torch.Generator] = None):
    """Frozen CLIP vision params on `device` in `dtype` (with
    `visual_projection` when the directory holds a full CLIPModel)."""
    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.weights.convert import clip_vision_from_torch
    from gill_tpu_torch.weights.from_jax import clip_vision_from_jax

    d = _model_dir(name, weights_root)
    if d is None:
        print(f"WARNING: no local weights for {name}; using random init.",
              flush=True)
        return clip_mod.init_vision(_init(generator, device, dtype, seed),
                                    cfg)
    sd = load_state_dict_dir(d, device=device, dtype=dtype)
    return clip_vision_from_jax(clip_vision_from_torch(sd, cfg),
                                device=device, dtype=dtype)


def load_sd(name: str, cfg, weights_root=None, seed: int = 0, *,
            device="cuda", dtype=torch.bfloat16,
            generator: Optional[torch.Generator] = None):
    """SD weights from a diffusers directory (found as `_model_dir` finds
    a model, a directory that holds `unet/`): (params, tokenizer,
    safety checker). params: the UNet, the VAE decoder, the VAE encoder
    when the `vae/` state dict holds one (gill_tpu's leaves it out) and
    the CLIP text encoder, on `device` in `dtype`, each state dict read
    tensor by tensor to the device and freed once converted. The
    tokenizer (`tokenizer/vocab.json` + `merges.txt`) and the checker
    (`safety_checker/`) are None when absent; a load failure of either is
    reported and leaves it out, as gill_tpu's load_gill does
    (gill_tpu/api.py:701-725). No directory: random params with a
    warning, no tokenizer and no checker."""
    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.models.safety import load_safety_checker
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.models.sd import vae as vae_mod
    from gill_tpu_torch.tokenizer import CLIPBPETokenizer
    from gill_tpu_torch.weights import convert
    from gill_tpu_torch.weights.from_jax import tree_from_jax

    d = _model_dir(name, weights_root,
                   holds=lambda c: os.path.isdir(os.path.join(c, "unet")))
    if d is None:
        print("WARNING: no local SD weights; random-init SD pipeline.",
              flush=True)
        init = _init(generator, device, dtype, seed)
        return {"unet": unet_mod.init(init, cfg.unet),
                "vae_decoder": vae_mod.init_decoder(init, cfg.vae),
                "text_encoder": clip_mod.init_text(init, cfg.text)}, \
            None, None

    def load(sub):
        return load_state_dict_dir(os.path.join(d, sub), device=device,
                                   dtype=dtype)

    def move(tree):
        return tree_from_jax(tree, device=device, dtype=dtype)

    params = {"unet": move(convert.sd_unet_from_torch(load("unet"),
                                                      cfg.unet))}
    vae_sd = load("vae")
    params["vae_decoder"] = move(convert.sd_vae_decoder_from_torch(
        vae_sd, cfg.vae))
    if "encoder.conv_in.weight" in vae_sd:
        params["vae_encoder"] = move(convert.sd_vae_encoder_from_torch(
            vae_sd, cfg.vae))
    del vae_sd
    params["text_encoder"] = move(convert.clip_text_from_torch(
        load("text_encoder"), cfg.text))

    tok = checker = None
    tok_dir = os.path.join(d, "tokenizer")
    if os.path.exists(os.path.join(tok_dir, "vocab.json")):
        try:
            tok = CLIPBPETokenizer.from_files(
                os.path.join(tok_dir, "vocab.json"),
                os.path.join(tok_dir, "merges.txt"))
        except Exception as e:
            print(f"WARNING: SD tokenizer failed to load ({e}); running "
                  f"without it.")
    # the safety checker (reference custom_sd.py:653-661) whenever the
    # diffusers layout ships a safety_checker/ directory
    if os.path.isdir(os.path.join(d, "safety_checker")):
        try:
            checker = load_safety_checker(os.path.join(d, "safety_checker"),
                                          device=device, dtype=dtype)
        except Exception as e:
            print(f"WARNING: safety checker failed to load ({e}); running "
                  f"without it.")
    return params, tok, checker
