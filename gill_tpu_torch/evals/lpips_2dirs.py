"""LPIPS (AlexNet) perceptual distance between two image directories
(counterpart of evals/lpips_2dirs.py; reference evals/lpips_2dirs.py).

    python -m gill_tpu_torch.evals.lpips_2dirs -d0 gen/ -d1 gt/ \
        --lpips-weights lpips_alex.npz [--device cuda] [-o lpips_dists.txt]

Images are resized to 256 x 256 (bilinear) and scaled to [-1, 1]; the
per-file scores and their average are written to --out in the same lines
as evals/lpips_2dirs.py. The weights are the same `.npz` (`conv{i}_w` as
(kh, kw, cin, cout), `conv{i}_b`, `lin{i}_w`, from
scripts/convert_lpips_weights.py), transposed here to PyTorch's (cout,
cin, kh, kw); without them the script exits with status 2. The
convolutions are `F.conv2d` and `F.max_pool2d` in NCHW, fp32 (TF32 off),
on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from gill_tpu_torch.utils.cli import add_device_arg, resolve_device

# AlexNet features: (out_channels, kernel, stride, padding) a convolution,
# a ReLU after each (LPIPS taps all five), MaxPool(3, 2) after the first
# two (evals/lpips_2dirs.py ALEX_CONVS)
ALEX_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
              (256, 3, 1, 1), (256, 3, 1, 1)]
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def alexnet_features(params, x):
    """x (N, 3, H, W) -> the five ReLU outputs, NCHW."""
    feats = []
    h = x
    for i, (_, _, stride, pad) in enumerate(ALEX_CONVS):
        p = params[f"conv{i}"]
        h = F.relu(F.conv2d(h, p["w"], p["b"], stride=stride, padding=pad))
        feats.append(h)
        if i in (0, 1):
            h = F.max_pool2d(h, 3, 2)
    return feats


def lpips_distance(params, img0, img1):
    """img0 / img1: (N, H, W, 3) in [-1, 1] (tensors on the weights'
    device). Returns the 0-d distance, a mean over the batch and the
    pixels of each tap's calibrated squared difference."""
    shift = torch.from_numpy(SHIFT).to(img0.device)
    scale = torch.from_numpy(SCALE).to(img0.device)
    f0s = alexnet_features(params, ((img0 - shift) / scale).permute(0, 3, 1, 2))
    f1s = alexnet_features(params, ((img1 - shift) / scale).permute(0, 3, 1, 2))
    total = 0.0
    for i, (f0, f1) in enumerate(zip(f0s, f1s)):
        n0 = f0 / torch.sqrt((f0 ** 2).sum(1, keepdim=True) + 1e-10)
        n1 = f1 / torch.sqrt((f1 ** 2).sum(1, keepdim=True) + 1e-10)
        w = params[f"lin{i}"]["w"]                       # (C,) calibration
        total = total + ((n0 - n1) ** 2 * w[None, :, None, None]).sum(1).mean()
    return total


def load_lpips_weights(path: str, device="cuda"):
    """gill_tpu's LPIPS `.npz` -> fp32 tensors on `device`, the
    convolutions as (cout, cin, kh, kw)."""
    if not path.endswith(".npz"):
        raise ValueError(f"unsupported weights file {path}; see "
                         f"scripts/convert_lpips_weights.py")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    with np.load(path) as z:
        params = {}
        for i in range(5):
            params[f"conv{i}"] = {"w": t(z[f"conv{i}_w"].transpose(3, 2, 0, 1)),
                                  "b": t(z[f"conv{i}_b"])}
            params[f"lin{i}"] = {"w": t(z[f"lin{i}_w"])}
    return params


def load_image(path: str, device) -> torch.Tensor:
    """(1, 256, 256, 3) in [-1, 1] (the protocol's resize)."""
    img = Image.open(path).convert("RGB").resize((256, 256), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0
    return torch.from_numpy(arr[None]).to(device)


@torch.no_grad()
def score_dirs(params, dir0: str, dir1: str, out: str, device) -> float:
    """Scores every file of dir0 that dir1 also holds; writes "<name>:
    <d>" a file and "Average: <mean>" to `out`; returns the mean."""
    scores = []
    with open(out, "w") as f:
        for fn in sorted(os.listdir(dir0)):
            other = os.path.join(dir1, fn)
            if not os.path.exists(other):
                continue
            d = float(lpips_distance(params,
                                     load_image(os.path.join(dir0, fn), device),
                                     load_image(other, device)))
            scores.append(d)
            f.write(f"{fn}: {d:.6f}\n")
        f.write(f"Average: {np.mean(scores)}")
    return float(np.mean(scores))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-d0", "--dir0", required=True)
    p.add_argument("-d1", "--dir1", required=True)
    p.add_argument("-o", "--out", default="lpips_dists.txt")
    p.add_argument("--lpips-weights", default=os.environ.get(
        "GILL_TPU_LPIPS_WEIGHTS", ""))
    add_device_arg(p)
    args = p.parse_args(argv)

    if not args.lpips_weights or not os.path.exists(args.lpips_weights):
        print("ERROR: LPIPS requires pretrained AlexNet+calibration weights. "
              "Convert them once with scripts/convert_lpips_weights.py and "
              "pass --lpips-weights (or set GILL_TPU_LPIPS_WEIGHTS).")
        sys.exit(2)
    dev = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False      # fp32 convolutions
    params = load_lpips_weights(args.lpips_weights, dev)
    print("Average LPIPS:", score_dirs(params, args.dir0, args.dir1,
                                       args.out, dev))


if __name__ == "__main__":
    main()
