"""Model FLOPs of the slice's UNet, VAE, CLIP, GILLMapper and LM work
(counted from shapes) over the slice's length at the bf16 peak."""
from gillbench.metrics_util import mfu

LAYER = "whole step"
UNIT = "%"
MOVES = "images_per_s"


def read(ctx):
    return mfu(ctx)
