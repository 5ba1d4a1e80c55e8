"""Checkpoint reading for the inference path (counterpart of the npz half
of gill_tpu/utils/ckpt.py): the native `state.npz` + `meta.json` adapter
checkpoint and the decision model. Leaves come back as numpy arrays; the
caller moves them to its device."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

SEP = "//"


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


def load_checkpoint(ckpt_dir: str) -> Tuple[Any, dict]:
    """Reads `<ckpt_dir>/state.npz` (or `<ckpt_dir>/ckpt/state.npz`) and its
    meta.json, as written by gill_tpu.utils.ckpt.save_checkpoint."""
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
