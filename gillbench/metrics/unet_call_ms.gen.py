"""Device ms of the kernels one UNet call (unet.apply, CFG batch of the
queue's bucket) launched, averaged over the calls the slice holds."""
from gillbench.trace import device_ms_by_span

LAYER = "SD UNet (models/sd/unet.py)"
UNIT = "ms"
MOVES = "images_per_s"


def read(ctx):
    ms = device_ms_by_span(ctx["red"], ctx.get("spans", ()), "unet")
    return sum(ms.values()) / len(ms) if ms else None
