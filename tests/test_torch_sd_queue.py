"""gill_tpu_torch.serve.sd_queue: the seven cases of tests/test_sd_queue.py
against the port's queue, plus the port's batched tiny images against
gill_tpu's pipeline on the same explicit latents.

Coalescing must be invisible: a job's images equal an unbatched pipeline
call with the same initial latents, whatever batch it landed in (fp32
2e-5 absolute, test_sd_queue.py's bound; bf16 3e-2 of the pixel range, the
tiny bf16 UNet's batch-shape-dependent CPU sums), while the worker really
batches. The port's batched images against gill_tpu's unbatched ones:
1e-4 absolute on [0, 1] pixels, test_torch_gill_e2e.py's image bound.
"""

import threading
import time

import numpy as np
import pytest
import torch

from gill_tpu_torch.serve.sd_queue import SDBatchQueue
from torch_threads import one_intra_op_thread  # noqa: F401


class FakePipe:
    """Records batch shapes; 'images' encode the input latents so result
    slicing is checkable (the StableDiffusionPipeline call surface the
    queue uses)."""

    class _Cfg:
        default_size = 8
        vae_scale = 2

        class unet:
            cross_attention_dim = 6

    cfg = _Cfg()
    latent_channels = 4

    def __init__(self, delay=0.0):
        self.calls = []
        self.delay = delay
        self.grad_enabled = []
        self.started = threading.Event()    # set when a batch begins

    def __call__(self, *, prompt_embeds, latents, guidance_scale=7.5,
                 num_inference_steps=50):
        self.started.set()
        if self.delay:
            time.sleep(self.delay)
        self.grad_enabled.append(torch.is_grad_enabled())
        self.calls.append({"n": int(prompt_embeds.shape[0]),
                           "steps": num_inference_steps,
                           "guidance": guidance_scale})
        m = latents.mean(dim=(1, 2, 3))
        return m[:, None, None, None].expand(latents.shape[0], 8, 8, 3)


def _embs(n=1):
    return torch.zeros((n, 77, 6))


def _lat(seed, n=1, h=4):
    return torch.randn((n, h, h, 4), generator=torch.Generator().manual_seed(seed))


def test_results_routed_to_the_right_job():
    pipe = FakePipe(delay=0.05)
    q = SDBatchQueue(pipe, max_batch=8)
    lats = [_lat(i) for i in range(5)]
    futs = [q.submit(_embs(), latents=la) for la in lats]
    outs = [f.result(timeout=30) for f in futs]
    q.close()
    for la, out in zip(lats, outs):
        assert tuple(out.shape) == (1, 8, 8, 3)
        np.testing.assert_allclose(float(out[0, 0, 0, 0]), float(la.mean()),
                                   rtol=1e-5)
    assert sum(c["n"] for c in pipe.calls) >= 5   # pads included
    assert q.stats["jobs"] == 5
    # the worker thread runs every batch under its own inference mode
    assert pipe.grad_enabled and not any(pipe.grad_enabled)


def test_coalesces_queued_jobs_and_pads_to_bucket():
    pipe = FakePipe(delay=0.3)
    q = SDBatchQueue(pipe, max_batch=8)
    # job 0 occupies the worker; 1-3 queue up during its 0.3 s "denoise"
    f0 = q.submit(_embs(), latents=_lat(0))
    assert pipe.started.wait(30)
    futs = [q.submit(_embs(), latents=_lat(i)) for i in (1, 2, 3)]
    f0.result(timeout=30)
    for f in futs:
        f.result(timeout=30)
    q.close()
    assert q.stats["jobs"] == 4
    assert q.stats["batches"] == 2, pipe.calls   # 1 + coalesced 3
    assert pipe.calls[1]["n"] == 4               # 3 jobs pad up to 4
    assert q.stats["padded_latents"] == 1 + 4


def test_incompatible_configs_do_not_coalesce():
    pipe = FakePipe(delay=0.3)
    q = SDBatchQueue(pipe, max_batch=8)
    f0 = q.submit(_embs(), latents=_lat(0), num_inference_steps=50)
    assert pipe.started.wait(30)
    f1 = q.submit(_embs(), latents=_lat(1), num_inference_steps=50)
    f2 = q.submit(_embs(), latents=_lat(2), num_inference_steps=25)
    f3 = q.submit(_embs(), latents=_lat(3), num_inference_steps=50)
    for f in (f0, f1, f2, f3):
        f.result(timeout=30)
    q.close()
    # batch 1: job 0; batch 2: jobs 1 + 3 (same key); batch 3: job 2
    steps_seen = [(c["steps"], c["n"]) for c in pipe.calls]
    assert (50, 2) in steps_seen and (25, 1) in steps_seen, steps_seen
    assert q.stats["batches"] == 3


def test_multi_latent_jobs_and_cap():
    pipe = FakePipe()
    q = SDBatchQueue(pipe, max_batch=8)
    out = q.submit(_embs(3), latents=_lat(0, n=3)).result(timeout=30)
    assert tuple(out.shape) == (3, 8, 8, 3)
    with pytest.raises(ValueError):
        q.submit(_embs(9), latents=_lat(1, n=9))
    q.close()
    with pytest.raises(RuntimeError):
        q.submit(_embs(), latents=_lat(2))


def test_failed_batch_contains_error_and_keeps_serving():
    class Boom(FakePipe):
        def __call__(self, **kw):
            if len(self.calls) == 0:
                self.calls.append({})
                raise RuntimeError("denoise exploded")
            return super().__call__(**kw)

    pipe = Boom()
    q = SDBatchQueue(pipe, max_batch=8)
    f0 = q.submit(_embs(), latents=_lat(0))
    with pytest.raises(RuntimeError, match="denoise exploded"):
        f0.result(timeout=30)
    out = q.submit(_embs(), latents=_lat(1)).result(timeout=30)
    assert tuple(out.shape) == (1, 8, 8, 3)
    q.close()


def test_concurrent_submitters_all_served():
    """Stress: more submitting threads than cores, a shortened switch
    interval, jobs of two keys and sizes 1-3: every future resolves with its
    own rows, and the stats count every job and latent once."""
    import os
    import sys

    pipe = FakePipe()
    q = SDBatchQueue(pipe, max_batch=4)
    n_threads = 2 * (os.cpu_count() or 4)
    results, errors = {}, []

    def client(i):
        try:
            futs = []
            for j in range(3):
                n = 1 + (i + j) % 3
                lat = _lat(100 * i + j, n=n)
                futs.append((lat, q.submit(_embs(n), latents=lat,
                                           num_inference_steps=10 + j % 2)))
            results[i] = [(lat, f.result(timeout=60)) for lat, f in futs]
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        q.close()
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(results) == n_threads
    n_lat = 0
    for rows in results.values():
        for lat, out in rows:
            assert tuple(out.shape) == (lat.shape[0], 8, 8, 3)
            torch.testing.assert_close(out[:, 0, 0, 0], lat.mean(dim=(1, 2, 3)))
            n_lat += lat.shape[0]
    assert q.stats["jobs"] == 3 * n_threads and q.stats["latents"] == n_lat


def _tiny_pipe(dtype=torch.float32, seed=3):
    from gill_tpu_torch import config as tcfg
    from gill_tpu_torch.models.sd import unet as tunet
    from gill_tpu_torch.models.sd import vae as tvae
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.nn.core import Init

    cfg = tcfg.tiny_sd_config()
    init = Init(torch.Generator().manual_seed(seed), "cpu", dtype)
    params = {"unet": tunet.init(init, cfg.unet),
              "vae_decoder": tvae.init_decoder(init, cfg.vae)}
    return StableDiffusionPipeline(cfg, params)


def _jobs(cfg, n=3, seed=0):
    rng = np.random.RandomState(seed)
    h = cfg.default_size // cfg.vae_scale
    nct = cfg.text.max_positions   # must match the CFG uncond embeddings
    embs = [rng.randn(1, nct, cfg.unet.cross_attention_dim).astype(np.float32)
            for _ in range(n)]
    lats = [rng.randn(1, h, h, 4).astype(np.float32) for _ in range(n)]
    return embs, lats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_images_match_unbatched_pipeline(dtype):
    """Numerical invisibility on the real (tiny) pipeline; a long linger
    puts all three jobs in one batch (padded to 4)."""
    pipe = _tiny_pipe(getattr(torch, dtype))
    embs, lats = _jobs(pipe.cfg)
    steps = 3 if dtype == "float32" else 2
    direct = [pipe(prompt_embeds=torch.from_numpy(e),
                   latents=torch.from_numpy(la), num_inference_steps=steps)
              for e, la in zip(embs, lats)]
    q = SDBatchQueue(pipe, max_batch=8, linger_s=0.5)
    futs = [q.submit(torch.from_numpy(e), latents=torch.from_numpy(la),
                     num_inference_steps=steps)
            for e, la in zip(embs, lats)]
    outs = [f.result(timeout=120) for f in futs]
    q.close()
    assert q.stats["batches"] == 1 and q.stats["padded_latents"] == 4
    atol = 2e-5 if dtype == "float32" else 3e-2
    for d, o in zip(direct, outs):
        np.testing.assert_allclose(o.numpy(), d.numpy(), atol=atol, rtol=1e-5)


def test_batched_images_match_gill_tpu_pipeline():
    """The port's queue (one coalesced batch) against gill_tpu's pipeline
    called per job on the same weights and explicit latents."""
    import jax
    import jax.numpy as jnp

    from gill_tpu.models.sd.pipeline import StableDiffusionPipeline as JPipe
    from gill_tpu.models.sd.pipeline import tiny_sd_config as jtiny
    from gill_tpu_torch.weights.from_jax import tree_to_numpy

    pipe = _tiny_pipe(seed=5)
    embs, lats = _jobs(pipe.cfg, seed=1)
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     tree_to_numpy(pipe.params))
    jpipe = JPipe(jtiny(), jparams)
    want = [np.asarray(jpipe(prompt_embeds=jnp.asarray(e),
                             latents=jnp.asarray(la), num_inference_steps=2))
            for e, la in zip(embs, lats)]
    q = SDBatchQueue(pipe, max_batch=8, linger_s=0.5)
    futs = [q.submit(torch.from_numpy(e), latents=torch.from_numpy(la),
                     num_inference_steps=2) for e, la in zip(embs, lats)]
    outs = [f.result(timeout=120) for f in futs]
    q.close()
    assert q.stats["batches"] == 1
    for w, o in zip(want, outs):
        np.testing.assert_allclose(o.numpy(), w, atol=1e-4)


def test_submit_draws_the_pipeline_latents():
    """Without explicit latents, a job draws from its generator exactly what
    the pipeline would draw, so its images equal a direct call."""
    pipe = _tiny_pipe()
    emb = torch.from_numpy(_jobs(pipe.cfg, n=1)[0][0])
    direct = pipe(prompt_embeds=emb, num_inference_steps=2,
                  generator=torch.Generator().manual_seed(9))
    q = SDBatchQueue(pipe, max_batch=8)
    got = q.submit(emb, num_inference_steps=2,
                   generator=torch.Generator().manual_seed(9)).result(120)
    q.close()
    torch.testing.assert_close(got, direct, atol=2e-5, rtol=1e-5)


def test_api_postprocess_uses_batcher(tmp_path, monkeypatch):
    """GILL.enable_sd_batching routes _postprocess_generation's SD stage
    through the queue with unchanged outputs (the port's tiny GILL, random
    weights, the tiny SD config)."""
    from gill_tpu_torch.api import load_gill
    from gill_tpu_torch.config import GILLConfig

    GILLConfig(opt_version="test/opt-tiny", visual_encoder="test/clip-tiny",
               n_visual_tokens=2, num_tokens=4, num_clip_tokens=6,
               ret_emb_dim=8, gen_emb_dim=12, image_size=16
               ).to_json(str(tmp_path / "model_args.json"))
    monkeypatch.setenv("GILL_TPU_TINY_SD", "1")
    gill = load_gill(str(tmp_path), device="cpu", load_ret_embs=False,
                     decision_model_fn=None, dtype=torch.float32)
    kw = dict(num_words=2, gen_scale_factor=1e6, num_inference_steps=2)
    plain = gill.generate_for_images_and_texts(["a photo of"], **kw)
    assert gill.enable_sd_batching() is gill.sd_batcher
    batched = gill.generate_for_images_and_texts(["a photo of"], **kw)
    assert gill.sd_batcher.stats["jobs"] >= 1
    gill.sd_batcher.close()
    gill.sd_batcher = None
    assert len(plain) == len(batched) == 2
    for p, b in zip(plain, batched):
        if isinstance(p, str):
            assert p == b
        else:
            (pi, _), (bi, _) = p["gen"][0], b["gen"][0]
            np.testing.assert_array_equal(np.asarray(pi), np.asarray(bi))
