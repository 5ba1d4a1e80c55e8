"""A/B of the LN-folded attention/GEGLU path vs explicit layer_norms on the
card, plus a numerics smoke (fused vs composed tfm block at bf16).

Port of scripts/profile_ln_fuse.py. The port's `_tfm_block` takes the
LN-folded kernels (K7-K9) when `unet.FUSE_LN` is set and the composed
LayerNorm + kernels path when it is not; the probe sets the constant for
each side in this one process and restores it after. Block rows are device
ms (CUDA events); the full UNet call (zero weights, the CFG batch of 4
images), host-bound in eager mode, prints host-clock ms and the
device-busy ms of one profiled call, fused and composed.

    python -m gill_tpu_torch.scripts.profile_ln_fuse [--out PATH]
"""

from __future__ import annotations

import sys

import torch

from gill_tpu_torch.config import UNetConfig
from gill_tpu_torch.models.sd import unet as unet_mod
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.scripts._timing import (clock_note, delta_ms,
                                            host_and_device_ms, probe_main)
from gill_tpu_torch.scripts.profile_sd import (BATCH, RESOLUTIONS, patched,
                                               unet_inputs, zero_unet)


def probe(resolutions=RESOLUTIONS, cfg=None, batch=BATCH, device="cuda",
          n1=4, n2=28, unet_reps=3):
    print(clock_note(device), flush=True)
    cfg = cfg or UNetConfig()
    nh = cfg.num_heads
    g = torch.Generator(device).manual_seed(0)
    init = nn.Init(g, device, torch.bfloat16)
    ctx = torch.randn(batch, 77, cfg.cross_attention_dim, device=device,
                      generator=g).to(torch.bfloat16)
    rows = []
    with torch.no_grad():
        for hw, ch, nlayers in resolutions:
            x = (torch.randn(batch, hw * hw, ch, device=device, generator=g)
                 * 0.5).to(torch.bfloat16)
            blk = unet_mod._init_spatial_tfm(init, ch,
                                             cfg.cross_attention_dim)["block"]

            def block():
                return unet_mod._tfm_block(blk, x, ctx, nh, False)

            with patched("FUSE_LN", True):
                a = block()
                t_fused = delta_ms(block, device, n1, n2)
            with patched("FUSE_LN", False):
                b = block()
                t_plain = delta_ms(block, device, n1, n2)
            err = float((a.float() - b.float()).abs().max())
            ref = float(b.float().abs().max())
            rows.append({"block": f"{hw}x{hw}/{ch}", "fused_ms": t_fused,
                         "plain_ms": t_plain,
                         "saved_x_layers_ms": (t_plain - t_fused) * nlayers,
                         "max_abs_diff": err, "ref_max": ref})
            print(f"{hw}x{hw}/{ch}: fused {t_fused:7.3f} ms  "
                  f"plain {t_plain:7.3f} ms  "
                  f"saved*{nlayers} {(t_plain - t_fused) * nlayers:7.3f} ms  "
                  f"max|d|={err:.4f} (ref max {ref:.1f})", flush=True)

        params = zero_unet(cfg, device)
        lat, ts, tctx = unet_inputs(cfg, batch, resolutions[0][0], device)
        for label, on in (("fused", True), ("plain", False)):
            with patched("FUSE_LN", on):
                host, busy = host_and_device_ms(
                    lambda: unet_mod.apply(params, cfg, lat, ts, tctx),
                    device, unet_reps)
            rows.append({"block": f"FULL UNET step {label}", "host_ms": host,
                         "device_busy_ms": busy,
                         "img_s_at_50_steps": (batch // 2) / (50 * host / 1e3)})
            busy_s = "not measured" if busy is None else f"{busy:.3f} ms"
            print(f"FULL UNET step ({label}): {host:.3f} ms host, {busy_s} "
                  f"device-busy -> {rows[-1]['img_s_at_50_steps']:.3f} img/s "
                  f"@50 steps (host clock)", flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
