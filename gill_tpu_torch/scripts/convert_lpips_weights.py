"""Converts the published LPIPS (net='alex', v0.1) weights into the `.npz`
that `gill_tpu_torch.evals.lpips_2dirs` reads (counterpart of
scripts/convert_lpips_weights.py, which needs the `lpips` package).

    python -m gill_tpu_torch.scripts.convert_lpips_weights \
        --lpips weights/v0.1/alex.pth --alexnet alexnet-owt-7be5be79.pth \
        lpips_alex.npz

Both inputs are PyTorch state dicts read with `torch.load`: the `lpips`
package's calibration file (`lin{i}.model.1.weight`, (1, C, 1, 1) each)
and torchvision's AlexNet (`features.{0,3,6,8,10}.weight` / `.bias`; an
LPIPS module's own `net.slice{k}.{n}.*` keys are taken too). The output
holds `conv{i}_w` as (kh, kw, cin, cout), `conv{i}_b` and `lin{i}_w` (C,),
the layout gill_tpu's converter writes.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

# torchvision AlexNet's convolutions in `features`
ALEX_CONV_INDICES = (0, 3, 6, 8, 10)


def _state_dict(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


def _find(sd: dict, patterns, what: str):
    for pat in patterns:
        keys = [k for k in sd if re.search(pat, k)]
        if len(keys) == 1:
            return sd[keys[0]]
    raise KeyError(f"{what}: no single key matches {patterns}")


def convert(lpips_sd: dict, alexnet_sd: dict) -> dict:
    """The `.npz` arrays from the two state dicts."""
    blobs = {}
    for i, ci in enumerate(ALEX_CONV_INDICES):
        for part in ("weight", "bias"):
            t = _find(alexnet_sd, (rf"^features\.{ci}\.{part}$",
                                   rf"(^|\.)slice\d\.{ci}\.{part}$"),
                      f"conv {i} {part}").detach().float().numpy()
            if part == "weight":
                blobs[f"conv{i}_w"] = t.transpose(2, 3, 1, 0)
            else:
                blobs[f"conv{i}_b"] = t
    for i in range(len(ALEX_CONV_INDICES)):
        w = _find(lpips_sd, (rf"(^|\.)lin{i}\.model\.\d+\.weight$",),
                  f"lin{i}").detach().float().numpy()
        blobs[f"lin{i}_w"] = w.reshape(-1)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in blobs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lpips", required=True,
                    help="the lpips package's weights/v0.1/alex.pth")
    ap.add_argument("--alexnet", required=True,
                    help="torchvision's AlexNet state dict")
    ap.add_argument("out", nargs="?", default="lpips_alex.npz")
    args = ap.parse_args(argv)
    np.savez(args.out, **convert(_state_dict(args.lpips),
                                 _state_dict(args.alexnet)))
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
