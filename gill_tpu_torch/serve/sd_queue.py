"""Cross-request Stable Diffusion batching for the serving path.

Counterpart of gill_tpu/serve/sd_queue.py. The reference batches <= 8
latents per REQUEST (custom_sd.py:626-651); under concurrent serving each
request's denoise would serialize on the one device. This queue coalesces
concurrent generation jobs into one CFG denoise batch: while the device
runs one batch, arrivals accumulate and form the next, with a 10 ms
linger after the first job so that clients served by the previous batch
make this one.

Per-request determinism: the SUBMITTER draws its initial latents from its
own `torch.Generator`, with exactly the call the pipeline would make
(pipeline.py), so a bf16 or fp32 job's images do not depend on the jobs it
shares a batch with. (The W8A8 UNet's activation scale is one per tensor,
so under sd_precision="int8" batch mates do share it, as in gill_tpu.)

Batches coalesce only jobs with equal (guidance_scale, steps, latent
shape), and the latent count is padded to a power-of-two bucket with
copies of row 0 that are sliced off before delivery, as gill_tpu does to
reuse its compiled programs; eager PyTorch keeps the buckets so that a
batch's shapes, and so its kernels' launch shapes, come from a small set.

One worker thread owns the pipeline; it runs every batch under its own
`torch.inference_mode()` (grad mode is thread-local, so the submitters'
no_grad does not reach it).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import torch


class _Job:
    __slots__ = ("embs", "latents", "guidance", "steps", "n", "future")

    def __init__(self, embs, latents, guidance, steps):
        self.embs = embs                    # (n, T, D)
        self.latents = latents              # (n, h, w, C) before sigma
        self.guidance = float(guidance)
        self.steps = int(steps)
        self.n = embs.shape[0]
        self.future: Future = Future()

    def key(self):
        return (self.guidance, self.steps, tuple(self.latents.shape[1:]))


class SDBatchQueue:
    """submit() returns a Future of (n, H, W, 3) float32 images in [0, 1]
    on the pipeline's device."""

    def __init__(self, sd_pipe, *, max_batch: int = 8,
                 linger_s: float = 0.010):
        self.pipe = sd_pipe
        self.max_batch = max_batch
        self.linger_s = linger_s
        self._q: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._pending: List[_Job] = []      # head-of-line incompatible jobs
        self._lock = threading.Lock()
        self._stop = False
        self.stats = {"jobs": 0, "batches": 0, "latents": 0,
                      "padded_latents": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="sd-batch-queue")
        self._thread.start()

    # -- client side --------------------------------------------------------

    def submit(self, prompt_embeds, *, guidance_scale: float = 7.5,
               num_inference_steps: int = 50,
               generator: Optional[torch.Generator] = None,
               latents=None) -> Future:
        """prompt_embeds (n, T, D), 1 <= n <= max_batch (the reference's
        per-request cap; callers chunk larger requests). latents may be
        passed; otherwise they are drawn from `generator` exactly as the
        pipeline would draw them."""
        with self._lock:
            if self._stop:
                raise RuntimeError("SDBatchQueue closed")
        n = prompt_embeds.shape[0]
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"{n} latents in one job, max_batch "
                             f"{self.max_batch}")
        if latents is None:
            h = w = self.pipe.cfg.default_size // self.pipe.cfg.vae_scale
            latents = torch.randn((n, h, w, self.pipe.latent_channels),
                                  generator=generator,
                                  device=prompt_embeds.device)
        job = _Job(prompt_embeds, latents, guidance_scale, num_inference_steps)
        self._q.put(job)
        return job.future

    def close(self):
        with self._lock:
            if self._stop:
                return
            self._stop = True
        self._q.put(None)
        self._thread.join()

    # -- worker side ----------------------------------------------------------

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, cap)

    def _gather(self) -> Optional[List[_Job]]:
        """Block for one job, then coalesce compatible jobs (already
        queued, or arriving within the linger) up to max_batch.
        Incompatible jobs keep their arrival order for the next batch
        (`_pending` drains first, so nothing starves)."""
        if self._pending:
            first = self._pending.pop(0)
        else:
            first = self._q.get()
            if first is None:
                return None
        batch, n, keep = [first], first.n, []
        scan, self._pending = self._pending, []
        deadline = time.monotonic() + self.linger_s
        while n < self.max_batch:
            if scan:
                job = scan.pop(0)
            else:
                try:
                    wait = deadline - time.monotonic()
                    job = (self._q.get(timeout=wait) if wait > 0
                           else self._q.get_nowait())
                except queue.Empty:
                    break
                if job is None:
                    self._q.put(None)      # for the outer loop
                    break
            if job.key() == first.key() and n + job.n <= self.max_batch:
                batch.append(job)
                n += job.n
            else:
                keep.append(job)
        self._pending = keep + scan + self._pending
        return batch

    def _loop(self):
        with torch.inference_mode():
            while True:
                batch = self._gather()
                if batch is None:
                    for job in self._pending:
                        job.future.set_exception(RuntimeError("queue closed"))
                    return
                try:
                    self._run_batch(batch)
                except Exception as e:  # fail the batch, keep serving
                    for job in batch:
                        if not job.future.done():
                            job.future.set_exception(e)

    def _run_batch(self, batch: List[_Job]):
        embs = torch.cat([j.embs for j in batch])
        lats = torch.cat([j.latents.to(embs.device) for j in batch])
        n = embs.shape[0]
        nb = self._bucket(n, self.max_batch)
        if nb > n:   # pad rows re-denoise row 0; sliced off before delivery
            embs = torch.cat([embs, embs[:1].expand(nb - n, *embs.shape[1:])])
            lats = torch.cat([lats, lats[:1].expand(nb - n, *lats.shape[1:])])
        first = batch[0]
        images = self.pipe(prompt_embeds=embs, latents=lats,
                           guidance_scale=first.guidance,
                           num_inference_steps=first.steps)[:n]
        self.stats["jobs"] += len(batch)
        self.stats["batches"] += 1
        self.stats["latents"] += n
        self.stats["padded_latents"] += nb
        i = 0
        for job in batch:
            job.future.set_result(images[i: i + job.n])
            i += job.n

    def warmup(self, buckets=(1, 2, 4, 8), *, guidance_scale: float = 7.5,
               num_inference_steps: int = 50):
        """Runs the pipeline once at each occupancy bucket (up to
        max_batch), so the first live batch of any size meets warm kernels
        and allocator pools (gill_tpu compiles its programs here)."""
        from gill_tpu_torch.nn.core import tree_leaves

        cfg = self.pipe.cfg
        dev = tree_leaves(self.pipe.params["unet"])[0].device
        h = w = cfg.default_size // cfg.vae_scale
        with torch.inference_mode():
            for b in buckets:
                if b > self.max_batch:
                    continue
                embs = torch.zeros((b, cfg.text.max_positions,
                                    cfg.unet.cross_attention_dim), device=dev)
                lats = torch.zeros((b, h, w, self.pipe.latent_channels),
                                   device=dev)
                self.pipe(prompt_embeds=embs, latents=lats,
                          guidance_scale=guidance_scale,
                          num_inference_steps=num_inference_steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
