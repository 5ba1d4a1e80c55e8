"""Share of the traced slice (one SD batch and the LM work beside it) in
which no kernel or copy ran on the card."""
from gillbench.metrics_util import idle_share

LAYER = "device (H100)"
UNIT = "%"
MOVES = "images_per_s"


def read(ctx):
    return idle_share(ctx)
