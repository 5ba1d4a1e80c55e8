"""GILL's generation route under closed-loop clients.

Each client sends [image, dialogue] through `GILL.generate_async` (the online
GILL engine: prefill, decode, the [IMG] hidden states) and
`GILL.finalize_async` (retrieval top-k, the decision MLP, the GILLMapper,
the cross-request SD batch queue, the CLIP re-rank), then its next prompt.
The window opens at the end of an SD batch (a delivery of images) and
closes at the first batch end after --seconds: images_per_s is the latents
those batches delivered over that time.

Correctness (after the window, the program freed): for a seeded sample of
the requests whose images the window delivered, the longest prompt among
them and the rest spread over the SD batches' rows, the plain fp32
reference recomputes from the same seeded weights and inputs
  hidden  the 8 [IMG] hidden states (CLIP prefix, OPT over the prompt and
          the [IMG] tokens), relative L2 error;
  cond    the GILLMapper conditioning from the reference's hidden states,
          relative L2 error;
  eps     the first UNet call of each sampled request's SD batch on the
          program's own inputs of that call (one call, teacher-forced),
          relative L2 error of each request of the batch over its two CFG
          rows, the worst of them;
  image   the 50-step PNDM denoise and the VAE from the program's
          conditioning and the latents redrawn from the request's
          generator, mean absolute error of the delivered image in [0, 1];
  score   the CLIP re-rank score of the delivered image against the
          reference's retrieval embedding, absolute difference.
"""

from __future__ import annotations

import functools
import threading
import time

import numpy as np

from gillbench import build, flops, traffic
from gillbench.drivers import common
from gillbench.harness import Check, Outcome
from gillbench.trace import Recorder, Slice

LIBS = ("flash_mma", "flash_attn", "geglu", "decode_attn")
# the port's own kernels by name, each with the wrapper span it runs in
OWNERS = (("flash_mma", "flash"), ("flash_f32", "flash"),
          ("geglu_", "geglu"), ("prefix_decode", "chunk"))


class _Batches:
    """SD batch bookkeeping: which requests rode in which batch, when each
    ended, and the first UNet call of each (for the eps check)."""

    def __init__(self):
        self.cond = threading.Condition()
        self.ended = []               # batch records, in end order
        self.capture = False          # keep first-UNet-call tensors
        self.current = None
        self.by_future = {}           # id(future) -> request record

    def wait_end_after(self, t: float, timeout: float):
        """The first batch that ends at or after host time t."""
        deadline = time.perf_counter() + timeout
        with self.cond:
            while True:
                for b in self.ended:
                    if b["t_end"] >= t:
                        return b
                left = deadline - time.perf_counter()
                if left <= 0:
                    return None
                self.cond.wait(min(left, 1.0))


def _wrap(model, rec: Recorder, batches: _Batches, spec):
    """The benchmark's wrappers around the calls into each layer."""
    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.models import mapper as mapper_mod
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.ops import attention as attn_mod

    queue = model.sd_batcher
    local = threading.local()
    batches.local = local

    orig_submit = queue.submit

    def submit(prompt_embeds, **kw):
        fut = orig_submit(prompt_embeds, **kw)
        req = getattr(local, "req", None)
        if req is not None and req.get("keep"):
            req["cond"] = prompt_embeds.detach().clone()
            batches.by_future[id(fut)] = req
        return fut

    queue.submit = submit
    orig_batch = queue._run_batch

    def run_batch(batch):
        n = sum(j.n for j in batch)
        b = {"n": n, "nb": queue._bucket(n, queue.max_batch),
             "t_start": time.perf_counter(), "first": None}
        row = 0
        for j in batch:
            req = batches.by_future.pop(id(j.future), None)
            if req is not None:
                req["batch"], req["row"] = b, row
            row += j.n
        batches.current = b
        with rec.span("sd_batch", rows=n):
            orig_batch(batch)
        b["t_end"] = time.perf_counter()
        b["stats"] = dict(queue.stats)     # the queue's own counters
        with batches.cond:
            batches.ended.append(b)
            batches.cond.notify_all()

    queue._run_batch = run_batch
    orig_unet = unet_mod.apply
    run_unet = orig_unet
    if spec.fault == "half_batch":      # tests only: half the rows computed
        run_unet = functools.partial(_half_batch, orig_unet)

    def unet_apply(params, cfg, latents, timesteps, ctx, q8=False):
        with rec.span("unet", rows=int(latents.shape[0])):
            out = run_unet(params, cfg, latents, timesteps, ctx, q8)
        b = batches.current
        if batches.capture and b is not None and b["first"] is None:
            b["first"] = (latents.detach().clone(), float(timesteps),
                          ctx.detach().clone(), out.detach().clone())
        return out

    unet_mod.apply = unet_apply
    rec._undo.append(lambda: setattr(unet_mod, "apply", orig_unet))
    pipe = model.sd_pipe
    rec.wrap(pipe, "decode_latents", "vae",
             lambda lat: {"rows": int(lat.shape[0])})
    rec.wrap(clip_mod, "vision_forward", "clip",
             lambda p, c, px: {"rows": int(px.shape[0])})
    rec.wrap(mapper_mod, "apply", "mapper",
             lambda p, c, x, e=None: {"rows": int(x.shape[0]),
                                      "mode": c.mode})
    rec.wrap(attn_mod, "flash_attention", "flash",
             lambda q, k, v, **kw: {"b": q.shape[0], "t": q.shape[1],
                                    "s": k.shape[1], "h": q.shape[2],
                                    "d": q.shape[3],
                                    "causal": bool(kw.get("causal"))})
    rec.wrap(unet_mod, "geglu_ff", "geglu",
             lambda x, *a, **kw: {"m": x.numel() // x.shape[-1],
                                  "d": x.shape[-1]})
    # tests only: faults planted where the answer is produced
    if spec.fault == "answer":          # every image altered
        orig_dec = pipe.decode_latents
        pipe.decode_latents = lambda lat: 1.0 - orig_dec(lat)
    elif spec.fault == "stale":         # a denoise step returns its state
        orig_step = pipe.scheduler.step
        pipe.scheduler.step = lambda state, mo, t, sample, ratio, **kw: (
            sample, orig_step(state, mo, t, sample, ratio, **kw)[1])


def _half_batch(unet, params, cfg, latents, timesteps, ctx, q8=False):
    """A fault: the UNet computes the first half of its batch's rows and
    hands their outputs to the rows it left out."""
    import torch

    keep = max(1, latents.shape[0] // 2)
    out = unet(params, cfg, latents[:keep], timesteps, ctx[:keep], q8)
    return out[torch.arange(latents.shape[0]) % keep]


def _wrap_engine(eng, rec: Recorder):
    def prefill_attrs(embs, lens, slot_ids, reqs, pfx):
        live = slot_ids < eng.slots
        return {"tokens": [int(x) for x in np.asarray(lens)[live]],
                "padded": int(embs.shape[0] * embs.shape[1])}

    def chunk_attrs():
        steps, ctx = 0, 0
        for st in eng._state:
            if st is None:
                continue
            left = max(0, min(eng.chunk, st.budget - st.fed))
            steps += left
            ctx += left * (st.start + st.fed)
        return {"steps": steps, "ctx": ctx}

    rec.wrap(eng, "_prefill", "prefill", prefill_attrs)
    rec.wrap(eng, "_run_chunk", "chunk", chunk_attrs)


def _flops_table(cfg, device):
    """Per-row model FLOPs of the UNet (a latent: two CFG rows), the VAE
    decode, a CLIP image and a generation-mapper call, from the reference
    on meta tensors."""
    import torch

    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.models import mapper as mapper_mod
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.models.sd import vae as vae_mod
    from gill_tpu_torch.config import CLIPVisionConfig, MapperConfig
    from gillbench.reference import gill as rg
    from gillbench.reference import sd as rsd

    sd_cfg = build.sd_config(cfg)
    m = "meta"
    unet = flops.meta_tree(lambda i: unet_mod.init(i, sd_cfg.unet))
    vae = flops.meta_tree(lambda i: vae_mod.init_decoder(i, sd_cfg.vae))
    vis_cfg = CLIPVisionConfig.from_name(cfg["clip"]["name"])
    vision = flops.meta_tree(lambda i: clip_mod.init_vision(i, vis_cfg))
    gc = cfg["gill"]
    mc = MapperConfig(in_dim=cfg["opt"]["word_embed_proj_dim"],
                      out_dim=gc["gen_emb_dim"], num_input_tokens=8,
                      num_output_tokens=gc["num_clip_tokens"],
                      mode="gill_mapper")
    mapper = flops.meta_tree(lambda i: mapper_mod.init(i, mc))
    h = cfg["sd"]["size"] // cfg["sd"]["vae_scale"]
    lat = torch.empty((2, h, h, 4), device=m)
    ctx = torch.empty((2, gc["num_clip_tokens"], gc["gen_emb_dim"]),
                      device=m)
    side = cfg["clip"]["image_size"]
    x = torch.empty((1, gc["num_tokens"], mc.in_dim), device=m)
    return {
        "unet_latent": flops.counted(lambda: rsd.unet(unet, cfg["unet"], lat,
                                                      1, ctx)),
        "vae_row": flops.counted(lambda: rsd.vae_decode(
            vae, cfg["vae"], lat[:1])),
        "clip_row": flops.counted(lambda: rg.vision_pooled(
            vision, cfg["clip"], torch.empty((1, side, side, 3), device=m))),
        "mapper_row": flops.counted(lambda: rg.gill_mapper(
            mapper, {"heads": mc.num_heads}, x, x)),
    }


def _slice_flops(spans, table, opt):
    fl = 0.0
    for s in spans:
        a, n = s["attrs"], s["name"]
        if n == "unet":
            fl += table["unet_latent"] * a["rows"] / 2
        elif n == "vae":
            fl += table["vae_row"] * a["rows"]
        elif n == "clip":
            fl += table["clip_row"] * a["rows"]
        elif n == "mapper" and a["mode"] == "gill_mapper":
            fl += table["mapper_row"] * a["rows"]
        elif n == "prefill":
            fl += sum(flops.prefill_flops(opt, t) for t in a["tokens"])
        elif n == "chunk" and a["steps"]:
            fl += a["steps"] * flops.lm_token_flops(
                opt, a["ctx"] / a["steps"], True)
    return fl


def run(spec: common.RunSpec) -> Outcome:
    import torch
    from PIL import Image

    cell, dev, log = spec.cell, spec.device, spec.log
    cfg, mix = cell.config, cell.traffic
    rq, eng_kw, sdq = mix["request"], mix["engine"], mix["sd_queue"]
    build_s = common.build_kernels(LIBS, dev)
    system = build.gill_system(
        cfg, spec.seed, dev,
        lm_precision="w8" if spec.control else "bf16",
        sd_precision="int8" if spec.control else "bf16")
    model = system.model
    queue = model.enable_sd_batching(max_batch=sdq["max_batch"])
    rec, batches = Recorder(), _Batches()
    _wrap(model, rec, batches, spec)
    online = model.get_online_engine(slots=eng_kw["slots"],
                                     chunk=eng_kw["chunk"],
                                     max_seq=eng_kw["max_seq"])
    eng = online.eng
    _wrap_engine(eng, rec)
    # warm-up: every prefill bucket and wave, every read window, every SD
    # batch bucket (two steps: the shapes of fifty), then one whole request
    with torch.no_grad():
        eng.warmup()
        eng._reset_pool()
    queue.warmup(buckets=tuple(sdq["warm_buckets"]),
                 guidance_scale=rq["guidance_scale"], num_inference_steps=2)
    pool = common.Pool(traffic.gill_prompts(mix, spec.seed))
    table = _flops_table(cfg, dev) if spec.trace else None

    def one(p, i):
        img = Image.fromarray(p["image"])
        h = model.generate_async([img, p["text"]], num_words=rq["num_words"],
                                 gen_scale_factor=rq["gen_scale_factor"],
                                 slots=eng_kw["slots"], chunk=eng_kw["chunk"],
                                 max_seq=eng_kw["max_seq"])
        g = torch.Generator(device=dev).manual_seed(
            (p["sd_seed"] + 7919 * i) % (2 ** 62))
        out = model.finalize_async(h, generator=g,
                                   guidance_scale=rq["guidance_scale"],
                                   num_inference_steps=rq["steps"])
        return h, out

    one(pool.items[-1], -1)
    common.sync(dev)
    setup_s = time.perf_counter() - spec.t_process
    log(f"set-up {setup_s:.1f} s (nvcc {build_s:.1f} s)")

    stop = threading.Event()
    done, lock = [], threading.Lock()
    local = batches.local

    def client():
        while not stop.is_set():
            i, p = pool.next()
            req = {"i": i, "p": p, "t_submit": time.perf_counter(),
                   "keep": True}
            local.req = req
            try:
                h, out = one(p, i)
                req.update(t_done=time.perf_counter(),
                           hidden=np.array(h.img_hidden),
                           tokens=list(h.tokens), out=out)
            except Exception as e:  # noqa: BLE001 — a failed request counts
                req["error"] = f"{type(e).__name__}: {e}"
                req["t_done"] = time.perf_counter()
            with lock:
                done.append(req)

    batches.capture = True
    threads = [threading.Thread(target=client, daemon=True,
                                name=f"client-{k}")
               for k in range(mix["clients"])]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    wait = 600.0
    first = batches.wait_end_after(t_start + mix["ramp_s"], wait)
    slc = spans = None
    if first is not None and spec.trace:
        b1 = batches.wait_end_after(first["t_end"] + 1e-6, wait)
        rec.on()
        slc = Slice(cuda=dev.type == "cuda")
        slc.start()
        b2 = batches.wait_end_after(time.perf_counter(), wait)
        slc.stop()
        spans = rec.off()
        del b1, b2
    last = None if first is None else batches.wait_end_after(
        first["t_end"] + spec.seconds, wait)
    stop.set()
    for t in threads:
        t.join(timeout=300)
    hung = sum(t.is_alive() for t in threads)
    peak = common.peak_bytes(dev)
    queue.close()
    online.close()
    if first is None or last is None:
        raise RuntimeError("the SD queue delivered no batch in time")
    t_open, t_close = first["t_end"], last["t_end"]
    in_win = [b for b in batches.ended if t_open < b["t_end"] <= t_close]
    images = sum(b["n"] for b in in_win)
    attempted = [r for r in done if t_open <= r["t_submit"] <= t_close]
    failed = sum(1 for r in attempted if "error" in r) + hung
    e2e = {"setup_s": setup_s, "images_per_s": images / (t_close - t_open)}
    log(f"window {t_close - t_open:.2f} s: {images} images in "
        f"{len(in_win)} batches; {len(attempted)} requests started, "
        f"{failed} failed")

    layer_ctx = None
    if spec.trace and slc is not None:
        opt = cfg["opt"]
        layer_ctx = common.layer_context(
            slc, spans, OWNERS,
            window=common.stats_delta(first["stats"], last["stats"]),
            flops=_slice_flops([s for s in spans if s["t1"] is not None],
                               table, opt))
    rec.unwrap_all()

    # the sample: requests whose images the window delivered
    served = [r for r in done if "out" in r and r.get("batch") is not None
              and t_open < r["batch"]["t_end"] <= t_close]
    samples = _sample(served, mix["check"]["requests"], spec.seed)
    # free the program's state before the reference runs
    del model, online, eng, queue, pool
    system.model = None
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _check(cfg, mix, system, samples, dev, spec.control)
    out = Outcome(attempted=len(attempted), failed=failed, e2e=e2e,
                  checks=checks, memory_peak_bytes=peak,
                  device_kind=common.device_kind(dev), layer_ctx=layer_ctx,
                  notes={"build_s": build_s, "images": images,
                         "batches": len(in_win)})
    if layer_ctx is not None:
        out.busy_s, out.window_s = layer_ctx["busy_s"], layer_ctx["slice_s"]
        red = layer_ctx["red"]
        out.notes.update(kernels=len(red["kernels"]),
                         attributed=red["attributed"],
                         spans=len(layer_ctx["spans"]))
        out.breakdown = {"device_ops": red["device_ops"],
                         "idle_gaps": red["idle_gaps"]}
    return out


def _sample(served, k, seed):
    """The longest prompt and k - 1 more in a seeded order, each at an SD
    batch row that no earlier pick holds while such a request is left."""
    if not served:
        return []
    r = traffic.rng(seed, 3)
    longest = max(served, key=lambda q: len(q["p"]["text"]))
    rest = [served[int(j)] for j in r.permutation(len(served))
            if served[int(j)] is not longest]
    pick, rows = [longest], {longest["row"]}
    for q in rest:
        if len(pick) < k and q["row"] not in rows:
            pick.append(q)
            rows.add(q["row"])
    for q in rest:
        if len(pick) < k and q not in pick:
            pick.append(q)
    return pick


NUMBERS = ("hidden", "cond", "eps", "image", "score")


def _check(cfg, mix, system, samples, dev, control=False):
    """The comparisons with the plain reference (module docstring). With
    `control`, also the same numbers of the reference itself put in the
    program's place with every product's operands rounded to float8 (e4m3):
    `fp8_<number>`, each against its number's limit."""
    import torch

    from gillbench.reference import layers as L

    limits = mix["check"]["limits"]
    if not samples:
        return [Check("served_requests", 0.0, -1.0)]
    ref = _Reference(cfg, system, mix["request"], dev)
    worst = dict.fromkeys(NUMBERS, 0.0)
    low = dict.fromkeys(NUMBERS, 0.0)

    def keep(d, k, v):
        d[k] = max(d[k], v)

    with L.fp32_matmul():
        seen = set()
        for r in samples:
            b = r["batch"]
            if b["first"] is not None and id(b) not in seen:
                seen.add(id(b))
                want = ref.first_call(b)
                keep(worst, "eps", _batch_eps(b, b["first"][3], want))
                if control:
                    with L.rounded(torch.float8_e4m3fn):
                        got = ref.first_call(b)
                    keep(low, "eps", _batch_eps(b, got, want))
            want = ref.request(r)
            pil, score = r["out"][1]["gen"][0]
            img = torch.from_numpy(np.asarray(pil, np.float32) / 255.0).to(dev)
            keep(worst, "hidden", _rel(torch.from_numpy(r["hidden"]).to(dev),
                                       want["hidden"]))
            keep(worst, "cond", _rel(r["cond"], want["cond"]))
            keep(worst, "image", float((img - want["image"]).abs().mean()))
            keep(worst, "score", abs(float(score) - ref.rerank(
                pil, want["ret"])))
            if control:
                with L.rounded(torch.float8_e4m3fn):
                    got = ref.request(r)
                    pil8 = _to_pil(got["image"])
                    score8 = ref.rerank(pil8, got["ret"])
                img8 = torch.from_numpy(np.asarray(pil8, np.float32) / 255.0
                                        ).to(dev)
                keep(low, "hidden", _rel(got["hidden"], want["hidden"]))
                keep(low, "cond", _rel(got["cond"], want["cond"]))
                keep(low, "image", float((img8 - want["image"]).abs().mean()))
                keep(low, "score", abs(score8 - ref.rerank(pil8,
                                                           want["ret"])))
    checks = [Check(k, v, limits[k]) for k, v in worst.items()]
    if control:
        checks += [Check(f"fp8_{k}", v, limits[k]) for k, v in low.items()]
    return checks


def _rel(a, b):
    import torch

    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _to_pil(img):
    """An image in [0, 1] (H, W, 3) as the port delivers it: 8-bit RGB."""
    from PIL import Image

    a = img.clamp(0, 1).cpu().numpy()
    return Image.fromarray((a * 255).round().astype(np.uint8))


class _Reference:
    """The plain fp32 reference over the system's seeded weights."""

    def __init__(self, cfg, system, rq, dev):
        from gillbench.reference import gill as rg

        self.cfg, self.rq, self.dev = cfg, rq, dev
        self.trees = system.trees
        nt, img0 = cfg["gill"]["num_tokens"], system.img0
        self.table = rg.merged_table(self.trees, img0)
        self.img_rows = self.table[img0:img0 + nt]

    def first_call(self, b, rows_at_once=8):
        """The UNet on the inputs of the program's first call of batch b,
        a few CFG rows at a time."""
        import torch

        from gillbench.reference import sd as rsd

        lat, t, ctx, _ = b["first"]
        return torch.cat([rsd.unet(self.trees["unet"], self.cfg["unet"],
                                   lat[i:i + rows_at_once].float(), t,
                                   ctx[i:i + rows_at_once].float())
                          for i in range(0, lat.shape[0], rows_at_once)])

    def request(self, r):
        """A request's [IMG] hidden states, its conditioning, its retrieval
        embedding, and the image denoised from the program's conditioning
        and the latents redrawn from the request's generator."""
        import torch
        from PIL import Image

        from gillbench.reference import gill as rg
        from gillbench.reference import layers as L
        from gillbench.reference import opt as ropt
        from gillbench.reference import sd as rsd

        cfg, trees, dev = self.cfg, self.trees, self.dev
        p = r["p"]
        px = torch.from_numpy(rg.clip_pixels(Image.fromarray(
            p["image"]), cfg["clip"]["image_size"]))[None].to(dev)
        vis = rg.visual_prefix(trees, cfg, px)
        ids = torch.tensor(rg.text_ids(p["text"]), device=dev)
        emb = torch.cat([vis, self.table[ids][None], self.img_rows[None]], 1)
        n_p = emb.shape[1] - self.img_rows.shape[0]
        hid = ropt.forward(trees["lm"], cfg["opt"], emb)[0, n_p:]
        cond = rg.gill_mapper(trees["adapters"]["gen_fc"],
                              cfg["gill"]["mapper"], hid[None],
                              self.img_rows[None])
        cond = cond[:, :cfg["gill"]["num_clip_tokens"]]
        ret = L.linear(trees["adapters"]["ret_fc"]["model"], hid[None])[:, 0]
        ret = ret / torch.linalg.vector_norm(ret, dim=-1, keepdim=True)
        g = torch.Generator(device=dev).manual_seed(
            (p["sd_seed"] + 7919 * r["i"]) % (2 ** 62))
        h = cfg["sd"]["size"] // cfg["sd"]["vae_scale"]
        lat0 = torch.randn((1, h, h, 4), generator=g, device=dev)
        fin = rsd.generate(trees["unet"], cfg["unet"], r["cond"].float(),
                           lat0, self.rq["steps"], self.rq["guidance_scale"])
        img = rsd.vae_decode(trees["vae_decoder"], cfg["vae"], fin)[0]
        return {"hidden": hid, "cond": cond, "ret": ret, "image": img}

    def rerank(self, pil, ret) -> float:
        """The CLIP re-rank score of a delivered image against `ret`."""
        import torch

        from gillbench.reference import gill as rg

        px = torch.from_numpy(rg.clip_pixels(
            pil.resize((224, 224)).convert("RGB"),
            self.cfg["clip"]["image_size"]))[None].to(self.dev)
        vis = rg.retrieval_embedding(self.trees, self.cfg, px)
        return float(vis[0] @ ret[0])


def _batch_eps(b, eps, want):
    """The worst relative L2 error, over batch b's requests (each its uncond
    and cond rows), of a first UNet call's output `eps` against `want`."""
    worst = 0.0
    for row in range(b["n"]):
        rows = [row, b["nb"] + row]
        worst = max(worst, _rel(eps[rows], want[rows]))
    return worst
