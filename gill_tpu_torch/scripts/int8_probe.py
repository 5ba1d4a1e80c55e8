"""Probe the card's int8 product rates against bf16 for the SD UNet's hot
shapes: FF matmuls and 3x3 convs.

Port of scripts/int8_probe.py. bf16 `torch.matmul` / `conv2d` against the
port's int8 products of sd_precision="int8" (ops/quant.py: `int_mm`, and
`conv2d_int32`, its im2col convolution), without and with the dequant
epilogue (`quant._epilogue`, int32 -> bf16). Device ms each, and the rate
in TF/s (TOP/s for int8).

    python -m gill_tpu_torch.scripts.int8_probe [--out PATH]
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from gill_tpu_torch.ops import quant
from gill_tpu_torch.scripts._timing import clock_note, delta_ms, probe_main

# (M, K, N): the FF products at 64x64 / 32x32 / 16x16 (M = B * S, d -> 8d)
MM_SHAPES = [(32768, 320, 2560), (32768, 1280, 320), (8192, 640, 5120),
             (2048, 1280, 10240)]
# (B, HW, Cin, Cout): 3x3 convs, NHWC
CONV_SHAPES = [(8, 64, 320, 320), (8, 32, 640, 640), (8, 16, 1280, 1280)]


def _bf16_conv(x, w):
    """NHWC x, OIHW w, 'SAME' 3x3 (the UNet's float conv)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    return y.permute(0, 2, 3, 1)


def probe(mm_shapes=MM_SHAPES, conv_shapes=CONV_SHAPES, device="cuda", n1=2,
          n2=12):
    print(clock_note(device), flush=True)
    g = torch.Generator(device).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=g) * scale

    rows = []
    for m, kk, n in mm_shapes:
        xb, wb = randn(m, kk, scale=10).to(torch.bfloat16), \
            randn(kk, n).to(torch.bfloat16)
        xi, wi = randn(m, kk, scale=10).to(torch.int8), \
            randn(kk, n, scale=10).to(torch.int8)
        ws = torch.full((n,), 1e-4, device=device)

        def qmm():
            return quant._epilogue(quant.int_mm(xi, wi), 1.0, ws, None,
                                   torch.bfloat16)

        tb = delta_ms(lambda: xb @ wb, device, n1, n2)
        ti = delta_ms(lambda: quant.int_mm(xi, wi), device, n1, n2)
        tq = delta_ms(qmm, device, n1, n2)
        gf = 2 * m * kk * n / 1e9
        rows.append({"kind": "mm", "shape": [m, kk, n], "bf16_ms": tb,
                     "int8_ms": ti, "int8_deq_ms": tq})
        print(f"mm {m}x{kk}x{n}: bf16 {tb:7.3f}ms ({gf / tb:6.1f} TF/s)"
              f"  int8 {ti:7.3f}ms ({gf / ti:6.1f} TOP/s)"
              f"  int8+deq {tq:7.3f}ms", flush=True)
    for b, hw, cin, cout in conv_shapes:
        xb = randn(b, hw, hw, cin).to(torch.bfloat16)
        wb = randn(cout, cin, 3, 3, scale=0.05).to(torch.bfloat16)
        xi = randn(b, hw, hw, cin, scale=10).to(torch.int8)
        wi = randn(cout, 3, 3, cin, scale=10).to(torch.int8).permute(0, 3, 1, 2)
        ws = torch.full((cout,), 1e-4, device=device)

        def qconv():
            return quant._epilogue(quant.conv2d_int32(xi, wi, padding=1), 1.0,
                                   ws, None, torch.bfloat16)

        tb = delta_ms(lambda: _bf16_conv(xb, wb), device, n1, n2)
        ti = delta_ms(lambda: quant.conv2d_int32(xi, wi, padding=1), device,
                      n1, n2)
        tq = delta_ms(qconv, device, n1, n2)
        gf = 2 * b * hw * hw * 9 * cin * cout / 1e9
        rows.append({"kind": "conv", "shape": [b, hw, cin, cout],
                     "bf16_ms": tb, "int8_ms": ti, "int8_deq_ms": tq})
        print(f"conv {b}x{hw}^2x{cin}->{cout}: bf16 {tb:7.3f}ms "
              f"({gf / tb:6.1f} TF/s)  int8 {ti:7.3f}ms ({gf / ti:6.1f} "
              f"TOP/s)  int8+deq {tq:7.3f}ms", flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
