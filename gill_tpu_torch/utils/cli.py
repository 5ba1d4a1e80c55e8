"""The device flag and model loading of the port's entry points (evals/,
demo/, examples/, scripts/): each runs on the card unless `--device`
names another."""

from __future__ import annotations

import torch


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the card); cuda raises "
                             "when no card is present, pass --device cpu")


def resolve_device(name: str) -> torch.device:
    """`name` as a torch.device; raises for a CUDA device without a card."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return dev


def model_dtype(dev: torch.device) -> torch.dtype:
    """The frozen backbones' dtype: bf16 on the card, fp32 elsewhere."""
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def load_model(model_dir: str, device: torch.device, weights_dir=None, **kw):
    """`api.load_gill` on `device`, the frozen backbones in
    `model_dtype(device)`; `kw` as load_gill takes them."""
    from gill_tpu_torch.api import load_gill

    return load_gill(model_dir, device=device, weights_dir=weights_dir,
                     dtype=model_dtype(device), **kw)
