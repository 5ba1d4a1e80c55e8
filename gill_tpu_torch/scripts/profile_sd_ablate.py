"""Ablation timing of the SD UNet: time the FULL call with individual
components replaced by identities; component cost = full - ablated.

Port of scripts/profile_sd_ablate.py, on the port's UNet (models/sd/
unet.py) at the CFG batch of 4 images with zero weights. Each ablation
replaces `_tfm_block`, `_spatial_tfm` or `_resnet` of the module for its
runs and restores it in a `finally`, so that an exception cannot leave the
module patched. A full UNet call is host-bound in eager mode, so every row
prints host-clock ms a call and the device-busy ms of one profiled call.

    python -m gill_tpu_torch.scripts.profile_sd_ablate [--out PATH]
"""

from __future__ import annotations

import sys

import torch

from gill_tpu_torch.config import UNetConfig
from gill_tpu_torch.models.sd import unet as unet_mod
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.scripts._timing import (clock_note, host_and_device_ms,
                                            probe_main)
from gill_tpu_torch.scripts.profile_sd import (BATCH, patched, unet_inputs,
                                               zero_unet)

BLOCK_ABLATIONS = [("self-attn", ("self",)), ("cross-attn", ("cross",)),
                   ("geglu-ff", ("ff",)),
                   ("all-attn+ff", ("self", "cross", "ff"))]


def tfm_without(parts):
    """`_tfm_block` with the listed parts ("self", "cross", "ff") left out;
    the parts kept run as the block runs them."""
    def block(p, x, ctx, num_heads, q8):
        if "self" not in parts:
            x = x + unet_mod._attention(p["attn1"], x, None, num_heads,
                                        p["ln1"], q8)
        if "cross" not in parts:
            x = x + unet_mod._attention(p["attn2"], x, ctx, num_heads,
                                        p["ln2"], q8)
        if "ff" not in parts:
            x = x + unet_mod._geglu_ff(p, x, p["ln3"])
        return x
    return block


def resnet_cheap(p, x, temb, groups):
    if "shortcut" in p:
        return nn.conv2d(p["shortcut"], x, padding=0)
    return x


def spatial_identity(p, x, ctx, num_heads, groups, q8):
    return x


def ablate(cfg=None, batch=BATCH, hw=64, device="cuda", reps=3):
    print(clock_note(device), flush=True)
    cfg = cfg or UNetConfig()
    rows = []
    with torch.no_grad():
        params = zero_unet(cfg, device)
        lat, ts, ctx = unet_inputs(cfg, batch, hw, device)

        def run():
            return host_and_device_ms(
                lambda: unet_mod.apply(params, cfg, lat, ts, ctx), device,
                reps)

        def busy(ms, delta=None):
            if ms is None:
                return "device-busy not measured"
            return f"{ms:8.3f} ms device-busy" + (
                "" if delta is None else f"  (delta {delta:7.3f})")

        base, base_dev = run()
        rows.append({"ablation": "baseline", "host_ms": base,
                     "device_busy_ms": base_dev})
        print(f"baseline                 {base:8.3f} ms host  "
              f"{busy(base_dev)}", flush=True)
        ablations = [(f"w/o {name}", "_tfm_block", tfm_without(parts))
                     for name, parts in BLOCK_ABLATIONS]
        ablations += [("w/o spatial-tfm (all)", "_spatial_tfm",
                       spatial_identity),
                      ("w/o resnet bodies", "_resnet", resnet_cheap)]
        for name, target, fn in ablations:
            with patched(target, fn):
                t, dev = run()
            dd = None if dev is None else base_dev - dev
            rows.append({"ablation": name, "host_ms": t,
                         "device_busy_ms": dev, "delta_host_ms": base - t,
                         "delta_device_busy_ms": dd})
            print(f"{name:<24} {t:8.3f} ms host  (delta {base - t:7.3f})  "
                  f"{busy(dev, dd)}", flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(ablate, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
