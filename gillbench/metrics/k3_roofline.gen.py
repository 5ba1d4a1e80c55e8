"""K3 (csrc/geglu.cu, the UNet's GEGLU feed-forward): summed least time of
its calls over their device time."""
from gillbench import roofline
from gillbench.metrics_util import roofline_share

LAYER = "kernels (csrc/*.cu)"
UNIT = "%"
MOVES = "images_per_s"


def read(ctx):
    return roofline_share(ctx, "geglu", ("geglu",),
                          lambda a: roofline.geglu_bound(a["m"], a["d"]))
