"""Checkpoint IO (counterpart of the npz half of gill_tpu/utils/ckpt.py):
the native `state.npz` + `meta.json` checkpoint (written by the trainer,
read by the trainer's --resume and the inference path), the reference's
`pretrained_ckpt.pth.tar` adapters and the decision model. Leaves are
saved and come back as numpy arrays (the reference adapters as fp32 CPU
tensors); the caller moves them to its device. The flattened keys are
gill_tpu's, so either package reads the other's adapters; the optimizer
state each package stores is its own. gill_tpu's orbax backend (sharded,
multi-host) is JAX-only and not ported."""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

SEP = "//"


def _leaf_to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):                  # a torch tensor
        import torch

        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(x)


def _flatten(tree, prefix=""):
    """{"a": {"b": x}} -> {"a//b": x}; list / tuple items under "#i", an
    empty one as "#empty" (gill_tpu's keys)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{SEP}#{i}" if prefix else f"#{i}"))
        if len(tree) == 0:
            out[prefix + SEP + "#empty"] = np.zeros((0,))
    else:
        out[prefix] = _leaf_to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def finalize(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.startswith("#") for k in keys):
            if keys == ["#empty"]:
                return ()
            items = sorted(((int(k[1:]), v) for k, v in node.items()))
            return tuple(finalize(v) for _, v in items)
        return {k: finalize(v) for k, v in node.items()}

    return finalize(root)


def save_checkpoint(state_tree, ckpt_dir: str, *, step: int,
                    is_best: bool = False, meta: Optional[dict] = None):
    """Writes `<ckpt_dir>/ckpt/state.npz` and `meta.json` ({"step": step,
    **meta}), and copies them to `<ckpt_dir>/ckpt_best/` when is_best
    (reference utils.py:122-125; gill_tpu `save_checkpoint`). Tensor
    leaves are saved as numpy (bf16 as fp32)."""
    path = os.path.join(ckpt_dir, "ckpt")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "state.npz"), **_flatten(state_tree))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    if is_best:
        best = os.path.join(ckpt_dir, "ckpt_best")
        if os.path.exists(best):
            shutil.rmtree(best)
        shutil.copytree(path, best)


def load_checkpoint(ckpt_dir: str) -> Tuple[Any, dict]:
    """Reads `<ckpt_dir>/state.npz` (or `<ckpt_dir>/ckpt/state.npz`) and its
    meta.json, as `save_checkpoint` (or gill_tpu's) writes them."""
    path = ckpt_dir if os.path.exists(os.path.join(ckpt_dir, "state.npz")) \
        else os.path.join(ckpt_dir, "ckpt")
    with np.load(os.path.join(path, "state.npz"), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return _unflatten(flat), meta


def load_decision_model(path: str) -> dict:
    """decision_model.npz (`w` (in, 2), `b` (2,)) or the reference's
    torch `decision_model.pth.tar` (Linear weight stored (2, in)) ->
    {"w": (in, 2), "b": (2,)} (reference gill/models.py:553-561)."""
    if path.endswith(".npz"):
        z = np.load(path)
        return {"w": z["w"], "b": z["b"]}
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    w = b = None
    for k, v in sd.items():
        if k.endswith("weight"):
            w = v.detach().float().numpy().T
        elif k.endswith("bias"):
            b = v.detach().float().numpy()
    if w is None or b is None:
        raise ValueError(f"no Linear weight/bias in {path}: {list(sd)}")
    return {"w": w, "b": b}


def load_reference_gill_checkpoint(path: str, core) -> dict:
    """The reference's `pretrained_ckpt.pth.tar` -> adapters tree, fp32
    CPU tensors in gill_tpu's layout (gill_tpu utils/ckpt.py
    load_reference_gill_checkpoint; reference load_gill,
    gill/models.py:879-893). Its state_dict holds, each key with an
    optional DDP `module.` prefix:
      model.input_embeddings.weight  -> its last num_tokens rows ([IMG])
      model.visual_embeddings.*      -> visual -> LM projection
      model.visual_fc.*              -> retrieval image head
      model.logit_scale
      model.ret_text_hidden_fcs.i.*  -> retrieval text head of tap i
      model.gen_text_hidden_fcs.i.*  -> generation head (GILLMapper)
    ModuleList index i maps to the ret_fc / ret_fc_{i} suffixes of
    `core.tap_specs()`."""
    import torch

    from gill_tpu_torch.weights.convert import _lin, text_fc_layer_from_torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k.replace("module.", ""): v.detach().float()
          for k, v in ckpt["state_dict"].items()}
    adapters = {
        "img_embeddings": sd["model.input_embeddings.weight"][
            -core.cfg.num_tokens:],
        "visual_embeddings": _lin(sd, "model.visual_embeddings"),
        "visual_fc": _lin(sd, "model.visual_fc"),
        "logit_scale": sd["model.logit_scale"],
    }
    for i, (suffix, _, _) in enumerate(core.tap_specs()):
        adapters[f"ret_fc{suffix}"] = text_fc_layer_from_torch(
            sd, f"model.ret_text_hidden_fcs.{i}.", core.cfg.ret_text_fc_mode)
        adapters[f"gen_fc{suffix}"] = text_fc_layer_from_torch(
            sd, f"model.gen_text_hidden_fcs.{i}.", core.cfg.text_fc_mode)
    return adapters
