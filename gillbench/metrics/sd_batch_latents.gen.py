"""Latents a SD batch carried in the window: SDBatchQueue.stats' latents
over batches between the window's first and last delivery (real latents,
padding left out): how full the queue's 16-latent batches run."""
LAYER = "SD batch queue (serve/sd_queue.py)"
UNIT = "latents/batch"
MOVES = "images_per_s"


def read(ctx):
    w = ctx.get("window", {})
    if not w.get("batches"):
        return None
    return w["latents"] / w["batches"]
