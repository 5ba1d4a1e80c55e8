"""K2 (csrc/flash_mma.cu at head dims <= 80: the UNet's 64x64 and 32x32
attention, CLIP's): summed least time of its calls over their device time."""
from gillbench import roofline
from gillbench.metrics_util import roofline_share

LAYER = "kernels (csrc/*.cu)"
UNIT = "%"
MOVES = "images_per_s"


def read(ctx):
    return roofline_share(
        ctx, "flash", ("flash_mma",),
        lambda a: roofline.flash_bound(a["b"], a["t"], a["s"], a["h"],
                                       a["d"], a["causal"]),
        keep=lambda a: a["d"] <= 80)
