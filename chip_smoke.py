#!/usr/bin/env python3
"""Drives the gill_tpu_torch main path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the root of a checkout

1. Requires CUDA (raises otherwise) and prints the card's name and power
   limit and the torch / CUDA versions.
2. Builds the hand-written kernels from gill_tpu_torch/csrc/*.cu with nvcc
   (one process per source, all at once) into gill_tpu_torch/csrc/build/.
3. Kernel phase: every kernel against its plain PyTorch version at each
   shape the main path gives it (max abs error against a stated tolerance,
   median CUDA-event times of both).
4. Main path at full width: `load_gill` on a model_args.json for OPT-6.7B +
   CLIP ViT-L/14 + SD v1.5 (512 x 512, 50-step PNDM, CFG 7.5) with random
   weights made on the device from a seeded torch.Generator, a random
   CC3M-sized retrieval index (2.9M x 256 fp32, on the device; its paths
   are not URLs, so fetching fails at once) and a random decision MLP.
   Two requests through `generate_for_images_and_texts`: (a) an image and
   a short question (text route); (b) a >= 256-token dialogue with
   gen_scale_factor=1e6, which forces [IMG] through retrieval, the decision
   MLP, GILLMapper, SD and the CLIP re-rank. Kernel launch counts are set
   to 0 just before and read just after; both kernels must have launched.
5. Checks: finite outputs of the expected shapes; request (a) gives the
   same tokens with every kernel swapped for its plain version; CLIP, the
   OPT prefill, one full-width UNet step and the VAE decode agree with
   their plain-version runs within stated tolerances.

The last three lines of standard output are the {"kernels": [...]} JSON
line, the nvidia-smi name/power line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

FLASH_SRC = "gill_tpu_torch/csrc/flash_attn.cu"
GEGLU_SRC = "gill_tpu_torch/csrc/geglu.cu"
FLASH_REPLACES = ("gill_tpu/ops/attention.py:271 flash_attention + "
                  "gill_tpu/ops/attention.py:392 flash_attention_bthd")
GEGLU_REPLACES = "gill_tpu/ops/geglu.py:110 geglu_ff"


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of `fn` over `reps` launches (CUDA events),
    after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

# (site, B, T, S, H, D, dtype, causal): every flash-attention call shape of
# the main path (SD self/cross attention per UNet resolution, the VAE's
# single 512-wide head, CLIP ViT-L/14, the OPT-6.7B prefill of request b)
FLASH_SHAPES = [
    ("clip_vit_l14", 1, 257, 257, 16, 64, "float32", False),
    ("opt_prefill", 1, 320, 320, 32, 128, "float32", True),
    ("unet64_self", 2, 4096, 4096, 8, 40, "bfloat16", False),
    ("unet64_cross", 2, 4096, 77, 8, 40, "bfloat16", False),
    ("unet32_self", 2, 1024, 1024, 8, 80, "bfloat16", False),
    ("unet32_cross", 2, 1024, 77, 8, 80, "bfloat16", False),
    ("unet16_self", 2, 256, 256, 8, 160, "bfloat16", False),
    ("unet16_cross", 2, 256, 77, 8, 160, "bfloat16", False),
    ("unet8_self", 2, 64, 64, 8, 160, "bfloat16", False),
    ("unet8_cross", 2, 64, 77, 8, 160, "bfloat16", False),
    ("vae_mid", 1, 4096, 4096, 1, 512, "bfloat16", False),
]
# (site, M, d): every GEGLU feed-forward shape of the UNet at 512 x 512
GEGLU_SHAPES = [("unet64", 8192, 320), ("unet32", 2048, 640),
                ("unet16", 512, 1280), ("unet8", 128, 1280)]


def flash_tol(torch, dtype, ref) -> float:
    """fp32: 1e-4 absolute (both sides are fp32 FMA sums in another
    order; measured ~5e-7). bf16: two bf16 ulps at the largest output
    magnitude (both sides round the same fp32 value to bf16 once; the
    sums before the rounding differ in order)."""
    if dtype == torch.float32:
        return 1e-4
    return 2.0 * 2.0 ** -7 * float(ref.abs().max())


def geglu_tol(ref) -> float:
    """Four bf16 ulps at the largest output magnitude: the plain version
    rounds the (M, 8d) projection and the gated product to bf16 where the
    kernel keeps fp32 until the gated product."""
    return 4.0 * 2.0 ** -7 * float(ref.abs().max())


def kernel_phase(torch, dev):
    from gill_tpu_torch.ops.attention import flash_attention, flash_attention_ref
    from gill_tpu_torch.ops.geglu import geglu_ff, geglu_ff_ref

    g = torch.Generator(dev).manual_seed(1234)
    rows, failures = [], []
    for site, b, t, s, h, d, dt, causal in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, n, h, d, device=dev, generator=g).to(dtype)
                   for n in (t, s, s))
        out = flash_attention(q, k, v, causal=causal)
        ref = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rel = err / max(float(ref.float().abs().max()), 1e-30)
        tol = flash_tol(torch, dtype, ref.float())
        reps = 20 if t * s < 4096 * 4096 else 8
        ms = cuda_ms(torch, lambda: flash_attention(q, k, v, causal=causal),
                     reps)
        plain_ms = cuda_ms(torch, lambda: flash_attention_ref(
            q, k, v, causal=causal), reps)
        rows.append({"name": "flash_attention", "site": site, "route": "cuda",
                     "source": FLASH_SRC, "replaces": FLASH_REPLACES,
                     "shape": f"q({b},{t},{h},{d}) kv({b},{s},{h},{d}) {dt}"
                              f"{' causal' if causal else ''}",
                     "max_abs_err": err, "rel_err": rel, "tol": tol,
                     "ms": ms, "plain_ms": plain_ms})
        log(f"kernel flash_attention {site}: err {err:.3e} (tol {tol:.3e}) "
            f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
        if not err <= tol:
            failures.append(f"flash_attention {site}: {err} > {tol}")
        del q, k, v, out, ref
    for site, m, d in GEGLU_SHAPES:
        bf = torch.bfloat16
        x = torch.randn(m, d, device=dev, generator=g).to(bf)
        w1 = (torch.randn(d, 8 * d, device=dev, generator=g)
              / math.sqrt(d)).to(bf)
        b1 = (0.1 * torch.randn(8 * d, device=dev, generator=g)).to(bf)
        w2 = (torch.randn(4 * d, d, device=dev, generator=g)
              / math.sqrt(4 * d)).to(bf)
        b2 = (0.1 * torch.randn(d, device=dev, generator=g)).to(bf)
        out = geglu_ff(x, w1, b1, w2, b2)
        ref = geglu_ff_ref(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rel = err / max(float(ref.float().abs().max()), 1e-30)
        tol = geglu_tol(ref.float())
        ms = cuda_ms(torch, lambda: geglu_ff(x, w1, b1, w2, b2), 20)
        plain_ms = cuda_ms(torch, lambda: geglu_ff_ref(x, w1, b1, w2, b2), 20)
        rows.append({"name": "geglu_ff", "site": site, "route": "cuda",
                     "source": GEGLU_SRC, "replaces": GEGLU_REPLACES,
                     "shape": f"x({m},{d}) bfloat16", "max_abs_err": err,
                     "rel_err": rel, "tol": tol, "ms": ms,
                     "plain_ms": plain_ms})
        log(f"kernel geglu_ff {site}: err {err:.3e} (tol {tol:.3e}) "
            f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
        if not err <= tol:
            failures.append(f"geglu_ff {site}: {err} > {tol}")
    return rows, failures


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Swaps every kernel of the path for its plain PyTorch version (the
    reference runs of the checks below; the library itself never does)."""
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.ops import attention as attn_mod
    from gill_tpu_torch.ops.geglu import geglu_ff_ref

    saved = attn_mod.flash_attention, unet_mod.geglu_ff

    def flash_plain(q, k, v, *, causal=False, scale=None, kv_len=None,
                    fast=False):
        return attn_mod.flash_attention_ref(q, k, v, causal=causal,
                                            scale=scale, kv_len=kv_len)

    attn_mod.flash_attention, unet_mod.geglu_ff = flash_plain, geglu_ff_ref
    try:
        yield
    finally:
        attn_mod.flash_attention, unet_mod.geglu_ff = saved


class PhaseTimer:
    """Wraps the path's stage functions with synchronised host-clock
    timers (the instrumentation of this script only)."""

    def __init__(self, torch):
        self.torch = torch
        self.times = {}
        self.saved = []

    def wrap(self, module, name, key_fn):
        orig = getattr(module, name)
        torch = self.torch

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            self.times.setdefault(key_fn(*a, **kw), []).append(
                time.perf_counter() - t0)
            return out

        self.saved.append((module, name, orig))
        setattr(module, name, timed)

    def restore(self):
        for module, name, orig in reversed(self.saved):
            setattr(module, name, orig)
        self.saved.clear()

    def summary(self):
        out = {}
        for key, ts in self.times.items():
            out[key] = {"n": len(ts), "total_s": sum(ts),
                        "mean_ms": 1e3 * sum(ts) / len(ts)}
        return out


def build_model(torch, dev, tmp):
    import numpy as np

    from gill_tpu_torch.api import load_gill
    from gill_tpu_torch.config import GILLConfig
    from gill_tpu_torch.retrieval import RetrievalIndex

    cfg = GILLConfig()      # OPT-6.7B, CLIP ViT-L/14, GILLMapper 8 -> 77x768
    cfg.to_json(os.path.join(tmp, "model_args.json"))
    rng = np.random.RandomState(0)
    np.savez(os.path.join(tmp, "decision_model.npz"),
             w=(rng.randn(cfg.opt.hidden_size, 2) / 64).astype(np.float32),
             b=np.zeros(2, np.float32))
    model = load_gill(tmp, device=dev, load_ret_embs=False,
                      decision_model_fn="decision_model.npz", load_sd=True,
                      dtype=torch.bfloat16, seed=0)
    # a CC3M-sized index (SURVEY.md: ~2.9M x 256 fp32), made on the device;
    # its paths are not URLs, so every fetch fails at once
    n = 2_900_000
    g = torch.Generator(dev).manual_seed(7)
    emb = torch.randn(n, cfg.ret_emb_dim, device=dev, generator=g)
    scale = math.exp(float(model.params["adapters"]["logit_scale"]))
    model.index = RetrievalIndex([f"cc3m/{i:07d}.jpg" for i in range(n)], emb,
                                 scale, device=dev)
    del emb
    return model


def dialogue_prompt(min_tokens: int, tokenizer) -> str:
    turns = ["User: I am planning a picnic by the lake this weekend.",
             "Assistant: That sounds lovely. Bring a blanket and some fruit.",
             "User: Which fruit travels well in a basket on a warm day?",
             "Assistant: Apples, grapes and oranges keep well for hours.",
             "User: Great. Can you show me what the lake might look like "
             "at sunset, with a red canoe near the shore?"]
    text = ""
    i = 0
    while len(tokenizer.encode(text)) < min_tokens:
        text += turns[i % len(turns)] + "\n"
        i += 1
    return text + "Assistant:"


def main_path(torch, dev):
    import numpy as np
    from PIL import Image

    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.models.sd import vae as vae_mod
    from gill_tpu_torch.ops.attention import flash_attention
    from gill_tpu_torch.ops.geglu import geglu_ff

    report, failures = {}, []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        model = build_model(torch, dev, tmp)
    torch.cuda.synchronize()
    report["build_model_s"] = time.perf_counter() - t0
    log(f"model built in {report['build_model_s']:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    img = Image.fromarray(np.random.RandomState(3).randint(
        0, 256, (256, 256, 3), dtype=np.uint8))
    req_a = [img, "Q: What is in this picture?\nA:"]
    prompt_b = dialogue_prompt(256, model.tokenizer)
    n_b = len(model.tokenizer.encode(prompt_b))
    report["request_b_prompt_tokens"] = n_b

    images = []
    orig_decode = model.sd_pipe.decode_latents

    def capture_decode(latents):
        out = orig_decode(latents)
        images.append(out)
        return out

    model.sd_pipe.decode_latents = capture_decode
    timer = PhaseTimer(torch)
    timer.wrap(clip_mod, "vision_forward", lambda *a, **k: "clip_vision")
    timer.wrap(opt_mod, "forward", lambda *a, **k: (
        "opt_prefill" if k.get("cache_pos") == 0 else
        "opt_decode_token" if k.get("cache") is not None else "opt_other"))
    timer.wrap(unet_mod, "apply", lambda *a, **k: "unet_step")
    timer.wrap(vae_mod, "decode", lambda *a, **k: "vae_decode")

    flash_attention.launches = 0
    geglu_ff.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_a = model.generate_for_images_and_texts(req_a, num_words=32)
    torch.cuda.synchronize()
    report["request_a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_b = model.generate_for_images_and_texts(
        [prompt_b], num_words=16, gen_scale_factor=1e6)
    torch.cuda.synchronize()
    report["request_b_s"] = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "geglu_ff": geglu_ff.launches}
    report["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    timer.restore()
    model.sd_pipe.decode_latents = orig_decode
    report["phases"] = timer.summary()
    log("request (a):", repr(out_a[0])[:120])
    log("request (b):", [o if isinstance(o, str) else
                         {k: (v if k == "decision" else len(v))
                          for k, v in o.items()} for o in out_b])
    log("main-path launches:", launches)
    for name, n in launches.items():
        if n <= 0:
            failures.append(f"{name} was not launched on the main path")

    # outputs: a caption for (a); for (b) the [IMG] run, a decision and one
    # finite 512 x 512 image
    if not (len(out_a) >= 1 and isinstance(out_a[0], str)):
        failures.append(f"request (a) gave {out_a!r}")
    if not (len(out_b) == 2 and isinstance(out_b[1], dict)
            and out_b[1]["decision"][0] in ("gen", "ret")
            and len(out_b[1]["gen"]) == 1):
        failures.append(f"request (b) did not take the [IMG] route: {out_b!r}")
    if len(images) != 1 or tuple(images[0].shape) != (1, 512, 512, 3) \
            or not bool(torch.isfinite(images[0]).all()):
        failures.append("request (b) gave no finite (1, 512, 512, 3) image")

    failures += check_against_plain(torch, dev, model, req_a, out_a, prompt_b,
                                    report)
    return model, launches, report, failures


def rel_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_against_plain(torch, dev, model, req_a, out_a, prompt_b, report):
    """The main path's kernel stages against the same stages with every
    kernel swapped for its plain version, on the same inputs."""
    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.models.sd import vae as vae_mod

    failures = []
    core, params, pipe = model.core, model.params, model.sd_pipe
    checks = {}

    def both(fn):
        with torch.no_grad():
            a = fn()
            with plain_kernels():
                b = fn()
        torch.cuda.synchronize()
        return a, b

    # request (a): identical tokens and caption with the plain versions
    with plain_kernels():
        out_plain = model.generate_for_images_and_texts(req_a, num_words=32)
    checks["request_a_same_output"] = out_plain == out_a
    if out_plain != out_a:
        failures.append(f"request (a) differs with plain versions: "
                        f"{out_plain!r} vs {out_a!r}")

    # CLIP ViT-L/14 (fp32 throughout): 1e-4 relative
    size = core.vis_cfg.image_size
    px = torch.randn(1, size, size, 3, device=dev,
                     generator=torch.Generator(dev).manual_seed(5))
    a, b = both(lambda: clip_mod.vision_forward(
        params["vision"], core.vis_cfg, px)["pooler_output"])
    checks["clip_pooled_rel_err"] = rel_err(torch, a, b)

    # OPT-6.7B prefill of request (b) (fp32 activations, causal flash):
    # 1e-4 relative on the last position's logits, same argmax
    embs, _ = model._encode_prompts([prompt_b])
    lm_head = core.lm_head_table(params).float()

    def prefill():
        cache = opt_mod.init_cache(core.opt_cfg, 1, embs.shape[1], device=dev,
                                   dtype=embs.dtype)
        h = opt_mod.forward(params["lm"], core.opt_cfg, embs, cache=cache,
                            cache_pos=0, skip_logits=True)["last_hidden"]
        return h[:, -1] @ lm_head.t()
    a, b = both(prefill)
    checks["opt_prefill_logits_rel_err"] = rel_err(torch, a, b)
    checks["opt_prefill_same_argmax"] = bool(a.argmax() == b.argmax())
    del lm_head

    # one full-width UNet call on the CFG batch (bf16 through 16 transformer
    # blocks: 3e-2 relative) and the VAE decode of its latents (3e-2)
    g = torch.Generator(dev).manual_seed(11)
    lat = torch.randn(2, 64, 64, 4, device=dev, generator=g).bfloat16()
    ctx = (0.5 * torch.randn(2, 77, 768, device=dev, generator=g)).bfloat16()
    t = torch.tensor(981.0, device=dev)
    a, b = both(lambda: unet_mod.apply(pipe.params["unet"], pipe.cfg.unet,
                                       lat, t, ctx))
    checks["unet_step_rel_err"] = rel_err(torch, a, b)
    a, b = both(lambda: vae_mod.decode(pipe.params["vae_decoder"],
                                       pipe.cfg.vae, lat[:1]))
    checks["vae_decode_rel_err"] = rel_err(torch, a, b)
    report["checks_vs_plain"] = checks
    log("checks vs plain versions:", json.dumps(checks))

    limits = {"clip_pooled_rel_err": 1e-4, "opt_prefill_logits_rel_err": 1e-4,
              "unet_step_rel_err": 3e-2, "vae_decode_rel_err": 3e-2}
    for key, lim in limits.items():
        if not checks[key] <= lim:
            failures.append(f"{key} {checks[key]} > {lim}")
    if not checks["opt_prefill_same_argmax"]:
        failures.append("OPT prefill argmax differs from the plain version")
    return failures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "available")
    from gill_tpu_torch.ops import _build

    smi = smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # full-precision fp32 products and convolutions (the CLIP and OPT
    # stages run in fp32, and TF32 would break greedy-token parity)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    took = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {took}")
    for name, text in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"  {name}: {len(regs)} ptxas entries; " + " | ".join(regs))

    with torch.no_grad():
        rows, failures = kernel_phase(torch, dev)
        torch.cuda.empty_cache()
        _, launches, report, path_failures = main_path(torch, dev)
    failures += path_failures
    log("main path:", json.dumps(report))
    for row in rows:
        row["launches"] = launches[row["name"]]
    if failures:
        for f in failures:
            log("FAILED:", f)
        return 1
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
