#!/usr/bin/env python3
"""Drives the gill_tpu_torch paths once on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the root of a checkout

1. Requires CUDA (raises otherwise) and prints the card's name and power
   limit and the torch / CUDA versions.
2. Builds the hand-written kernels from gill_tpu_torch/csrc/*.cu with nvcc
   (one process per source, all at once) into gill_tpu_torch/csrc/build/.
3. Kernel phase: every kernel against its plain PyTorch version at each
   shape its paths give it: max abs error against a stated tolerance, the
   CUDA-event time of both (the device is kept busy while the host queues
   the launches, so host overhead is not timed), the least time the card
   could take (the largest of bytes over 3.35 TB/s, operations over the
   peak rate of their type and, for attention, exponentials over the
   special-function units' ~3.9e12/s) and, where one PyTorch call computes
   the same function, that call's time. Each attention, GEGLU and
   LN-matmul row names its launch plan (`flash_plan`, `geglu_plan`,
   `w8_plan`, `ln_matmul_plan`); the LN-folded kernels (K7-K9) must also
   give the same bits in two calls. The W8 matmul
   (K4) is also timed L2-cold (`ms_cold`: its calls cycle through copies
   of the weight, >= 2x the L2 in all, as a decode step reads each layer's
   weights from device memory; its bound is set against that time) beside
   `torch.matmul` with the dequantized bf16 weight (2x the bytes), and two
   of its calls must agree bit for bit. The UNet's bf16 attention
   at head dims 40 / 80 (K2) is also timed at every tile of
   csrc/flash_mma.cu, its int8-QK twin (K10) pre-pass and main kernel
   apart.
4. Main path (slice 1) at full width: `load_gill` on a model_args.json for
   OPT-6.7B + CLIP ViT-L/14 + SD v1.5 (512 x 512, 50-step PNDM, CFG 7.5) with
   random weights made on the device from a seeded torch.Generator, a random
   CC3M-sized retrieval index (2.9M x 256 fp32, on the device; its paths
   are not URLs, so fetching fails at once) and a random decision MLP.
   Two requests through `generate_for_images_and_texts`: (a) an image and
   a short question (text route); (b) a >= 256-token dialogue with
   gen_scale_factor=1e6, which forces [IMG] through retrieval, the decision
   MLP, GILLMapper, SD and the CLIP re-rank.
5. Serving (slice 2), over the same model with its LM quantized to W8
   (`GILL(..., lm_weight_precision="w8")`, per layer on the device):
   (A) `DecodeEngine` (16 slots, max_seq 512, chunk 32, bf16 KV pool)
       `run_pipelined` over bench.py's bench_serve trace (48 requests,
       RandomState(7), prompts U[16,240], generations U[16,192]):
       generated tokens/s, ms a decode step with the valid-prefix kernel
       and with the plain decode path, the device's busy share over one
       profiled chunk and the W8 matmul's device us a step in it;
   (B) `generate_for_images_and_texts_batch` (8 slots, chunk 16): 8 prompts
       on the text route, then 2 with gen_scale_factor=1e6 through the tap
       ring, retrieval, the decision MLP, GILLMapper, SD and the re-rank;
   (C) `DecodeEngine(kv_dtype=torch.int8)` on 16 requests of the trace
       (the plain int8 decode path).
   Every path is driven with the launch counts set to 0 just before and
   read just after; each kernel of a path must have launched in it.
6. SD modes (slice 3), phase D, on the same SD v1.5 weights:
   (D1) `unet.FUSE_LN = True` (GILL_SD_FUSE_LN): one full-width UNet call
        against the unfused call, then a 50-step 512 x 512 generation; the
        LN-matmul (K7), stacked LN-matmul (K8) and LN-folded GEGLU (K9)
        kernels must launch;
   (D2) `unet.apply(..., q8=True)`: one full-width call against the same
        call on the plain versions; the int8-QK attention kernel (K10) must
        launch;
   (D3) `StableDiffusionPipeline(quantize=True)` (sd_precision="int8"):
        quantization and int8 UNet times, the int32 sums of `int_mm` and
        `conv2d_int32` at UNet shapes against exact CPU products, then the
        SD batch queue of a `GILL` sharing it: three threads submit one
        50-step job each, which must coalesce into one batch padded to 4,
        and request (b) through the queue's route;
   (D4) a 25-step DPM-Solver++ generation.
7. Probe scripts (slice 4), phase E: the probe kernels against their plain
   versions at the probes' full shapes (the repeated-product probe S1 at
   its seven cases, the sweep's flash variants S2 and S3 at B 8, S 4096,
   H 8, D 40, each row with its `variant_plan`, its ratio to SDPA and two
   calls bit for bit), then every probe of gill_tpu_torch/scripts/ once at
   its default shapes with its repetitions cut, printing its rows (attn_mxu_
   probe, attn_sweep, int8_probe, profile_sd, profile_sd_ablate,
   profile_ln_fuse, profile_prefix_decode, w8_probe); S1-S3 and K4 must
   launch there and no probe row may fail.
8. Checks: finite outputs of the expected shapes; request (a) gives the
   same tokens with every kernel swapped for its plain version; CLIP, the
   OPT prefill, one full-width UNet step, the VAE decode and one W8 decode
   step of phase A agree with their plain-version runs within stated
   tolerances.

The last three lines of standard output are the {"kernels": [...]} JSON
line, the nvidia-smi name/power line and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --ab-main-path OTHER_ROOT [ROUNDS] [ORDER]

instead compares two trees on one card: each tree's own `main_path` (step
4 and its checks), each run in a fresh process, in ORDER ("o" the other
tree, "t" this one; default "otto"), ROUNDS times (default 2), then in the same process ten timed
full-width UNet calls and one under torch.profiler, and the tree's W8
matmul at every W8_SHAPES row, L2-warm and L2-cold. OTHER_ROOT holds
another checkout, e.g. the parent commit unpacked with `git archive` into
a directory that .gitignore lists. It prints one "AB" JSON line per run
(request times, stage means, the UNet calls' host-clock times and device
profile, the W8 times, failures) and the card's name and power limit.
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

T_START = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the card's peaks, bound(), the event timer and the profiler summary are
# shared with the probe scripts
from gill_tpu_torch.scripts._timing import (  # noqa: E402
    bound, cold_copies, cuda_ms, cuda_ms_cycled, device_profile, smi_line)

FLASH_SRC = "gill_tpu_torch/csrc/flash_attn.cu"
MMA_SRC = "gill_tpu_torch/csrc/flash_mma.cu"
GEGLU_SRC = "gill_tpu_torch/csrc/geglu.cu"
W8_SRC = "gill_tpu_torch/csrc/w8_matmul.cu"
DECODE_SRC = "gill_tpu_torch/csrc/decode_attn.cu"
FLASH_REPLACES = ("gill_tpu/ops/attention.py:271 flash_attention "
                  "(_flash_kernel :154, pallas_call :330)")
MMA_REPLACES = ("gill_tpu/ops/attention.py:392 flash_attention_bthd "
                "(_flash_kernel :154, pallas_call :446)")
GEGLU_REPLACES = "gill_tpu/ops/geglu.py:110 geglu_ff"
W8_REPLACES = ("gill_tpu/ops/w8_matmul.py:125 w8_matmul + "
               "gill_tpu/ops/w8_matmul.py:52 w8_matmul_stacked")
DECODE_REPLACES = "gill_tpu/ops/decode_attn.py:140 prefix_decode_attention"
LN_SRC = "gill_tpu_torch/csrc/ln_matmul.cu"
LN_REPLACES = "gill_tpu/ops/ln_matmul.py:127 ln_matmul (_kernel)"
LN3_REPLACES = "gill_tpu/ops/ln_matmul.py:80 ln_matmul_stacked (_kernel_stacked)"
GEGLU_LN_REPLACES = "gill_tpu/ops/geglu.py:168 geglu_ff(ln_gamma=...) (_kernel_ln)"
I8_REPLACES = ("gill_tpu/ops/attention.py:446 flash_attention_bthd(q8=True) "
               "(_flash_kernel_i8, :349)")
MM_PROBE_SRC = "gill_tpu_torch/csrc/mm_probe.cu"
FV_SRC = "gill_tpu_torch/csrc/flash_variants.cu"
MM_PROBE_REPLACES = "scripts/attn_mxu_probe.py:40 mk(...).run (kernel :27)"
FV_REPLACES = "scripts/attn_sweep.py:104 make_flash(...) (kernel :43)"
NOMAX_REPLACES = "scripts/attn_sweep.py:171 make_flash_nomax(...) (kernel :128)"


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

# (site, B, T, S, H, D, dtype, causal): every flash-attention call shape of
# the main path (SD self/cross attention per UNet resolution, the VAE's
# single 512-wide head, CLIP ViT-L/14, the OPT-6.7B prefill of request b)
# and the bf16 prefill of the W8 serving engines' long prompts
FLASH_SHAPES = [
    ("clip_vit_l14", 1, 257, 257, 16, 64, "float32", False),
    ("opt_prefill", 1, 320, 320, 32, 128, "float32", True),
    ("opt_prefill_bf16", 1, 320, 320, 32, 128, "bfloat16", True),
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


# (site, M, K, N, dtype): the W8 matmul's calls on the serving paths —
# OPT-6.7B decode at 16 (phase A) and 8 (phase B) slots, a single-request
# prefill wave (M = bucket <= 256 takes the kernel), and fp32 x at M = 1
# (the sequential decode of a W8 model)
W8_SHAPES = [(f"decode{m}_{name}", m, k, n, "bfloat16")
             for m in (16, 8)
             for name, k, n in (("qkvo", 4096, 4096), ("fc1", 4096, 16384),
                                ("fc2", 16384, 4096))]
W8_SHAPES += [("prefill256_fc1", 256, 4096, 16384, "bfloat16")]
W8_SHAPES += [(f"seq_fp32_{name}", 1, k, n, "float32")
              for name, k, n in (("qkvo", 4096, 4096), ("fc1", 4096, 16384),
                                 ("fc2", 16384, 4096))]
# (B, S): the decode kernel's calls (slots x read window), H 32, D 128
DECODE_SHAPES = [(16, 256), (16, 512), (8, 256), (8, 512)]
# (site, M, d): the LN-matmuls of the UNet's head-dim-40/80 blocks under
# FUSE_LN (n = d): K7 the cross-attention q, K8 the self-attention q/k/v
LN_SHAPES = [("unet64", 8192, 320), ("unet32", 2048, 640)]
# (site, B, T, S, H, D): the int8-QK attention calls of unet.apply(q8=True)
Q8_SHAPES = [("unet64_self", 2, 4096, 4096, 8, 40),
             ("unet64_cross", 2, 4096, 77, 8, 40),
             ("unet32_self", 2, 1024, 1024, 8, 80),
             ("unet32_cross", 2, 1024, 77, 8, 80)]


def out_tol(torch, ref) -> float:
    """Two bf16 ulps of the largest output magnitude for bf16 outputs (both
    sides round one fp32 value to bf16, the sums before it differ in
    order); 1e-5 of it for fp32 outputs."""
    top = float(ref.float().abs().max())
    return (2.0 * 2.0 ** -7 if ref.dtype == torch.bfloat16 else 1e-5) * top


def per_row_err(torch, out, ref):
    """Per batch row: the largest |out - ref| and that row's own tolerance,
    two bf16 ulps of the row's largest |ref| for bf16 outputs, 1e-5 of it
    for fp32. A decode row averages its valid cache rows of v, so its
    output shrinks as its prefix grows, while a parked row returns its own
    v1; a tolerance from the whole batch's largest output would be set by
    the parked row and pass a wrong long row."""
    unit = 2.0 * 2.0 ** -7 if ref.dtype == torch.bfloat16 else 1e-5
    err = (out.float() - ref.float()).abs().flatten(1).amax(1)
    return err, unit * ref.float().abs().flatten(1).amax(1)


def _flash_pairs(t: int, s: int, causal: bool) -> int:
    """(query, key) pairs a causal bottom-right mask leaves visible."""
    if not causal:
        return t * s
    return sum(min(s, i + s - t + 1) for i in range(t))


def recorder(rows, failures):
    """record(row, err, tol, ok=None, note=""): appends a kernel row with
    its error and tolerance and logs it; `ok` defaults to err <= tol (a
    per-row check passes its own), and a row that is not ok is a failure."""
    def record(row, err, tol, ok=None, note=""):
        row["max_abs_err"], row["tol"] = err, tol
        rows.append(row)
        lib = row["library_ms"]
        log(f"kernel {row['name']} {row['site']}: err {err:.3e} (tol "
            f"{tol:.3e}{note}) {row['ms']:.4f} ms vs plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})"
            + ("" if lib is None else f", library {lib:.4f} ms"))
        if not (err <= tol if ok is None else ok):
            failures.append(f"{row['name']} {row['site']}: {err} > {tol}"
                            f"{note}")
    return record


def kernel_phase(torch, dev):
    import torch.nn.functional as F

    from gill_tpu_torch.ops.attention import (MMA_TILES, flash_attention,
                                              flash_attention_ref,
                                              flash_plan)
    from gill_tpu_torch.ops.decode_attn import (prefix_decode_attention,
                                                prefix_decode_attention_ref)
    from gill_tpu_torch.ops.geglu import geglu_ff, geglu_ff_ref, geglu_plan
    from gill_tpu_torch.ops import w8_matmul as w8_mod
    from gill_tpu_torch.ops.w8_matmul import w8_matmul, w8_matmul_ref

    g = torch.Generator(dev).manual_seed(1234)
    rows, failures = [], []
    record = recorder(rows, failures)

    for site, b, t, s, h, d, dt, causal in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, n, h, d, device=dev, generator=g).to(dtype)
                   for n in (t, s, s))
        out = flash_attention(q, k, v, causal=causal)
        ref = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = flash_tol(torch, dtype, ref.float())
        reps = 20 if t * s < 4096 * 4096 else 8
        esize = q.element_size()
        pairs = b * h * _flash_pairs(t, s, causal)
        bms, by = bound((2 * b * t * h * d + 2 * b * s * h * d) * esize,
                        4.0 * d * pairs,
                        "fp32" if dtype == torch.float32 else "bf16",
                        exps=pairs)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        plan = flash_plan(dtype, b, t, h, d)
        k2 = plan.kernel == "K2"
        row = {"name": "flash_mma" if k2 else "flash_attention",
               "site": site, "route": "cuda",
               "source": MMA_SRC if plan.route == "mma" else FLASH_SRC,
               "replaces": MMA_REPLACES if k2 else FLASH_REPLACES,
               "shape": f"q({b},{t},{h},{d}) kv({b},{s},{h},{d}) {dt}"
                        f"{' causal' if causal else ''}",
               "plan": plan._asdict(),
               "ms": cuda_ms(lambda: flash_attention(
                   q, k, v, causal=causal), reps),
               "plain_ms": cuda_ms(lambda: flash_attention_ref(
                   q, k, v, causal=causal), reps),
               "bound_ms": bms, "bound_by": by,
               # the same function in one PyTorch call (T == S or no mask
               # at every shape, so SDPA's top-left causal alignment agrees)
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal), reps)}
        row["tile"] = f"{plan.bq}x{plan.bk}"
        if k2:
            # every tile the kernel takes
            row["ms_by_tile"] = {
                f"{bq}x{bk}": cuda_ms(lambda: flash_attention(
                    q, k, v, causal=causal, block_q=bq, block_k=bk), reps)
                for bq in MMA_TILES for bk in MMA_TILES}
        record(row, err, tol)
        del q, k, v, qt, kt, vt, out, ref
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
        bms, by = bound((2 * m * d + 12 * d * d + 9 * d) * 2,
                        24.0 * m * d * d, "bf16")
        row = {"name": "geglu_ff", "site": site, "route": "cuda",
               "source": GEGLU_SRC, "replaces": GEGLU_REPLACES,
               "shape": f"x({m},{d}) bfloat16",
               "plan": geglu_plan(m, d)._asdict(),
               "ms": cuda_ms(lambda: geglu_ff(x, w1, b1, w2, b2), 20),
               "plain_ms": cuda_ms(lambda: geglu_ff_ref(
                   x, w1, b1, w2, b2), 20),
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        record(row, err, geglu_tol(ref.float()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the L2-cold times' extra weights come from their own generator, so
    # that every row draws the inputs it drew before they were added
    g_cold = torch.Generator(dev).manual_seed(4321)
    for site, m, kdim, n, dt in W8_SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(m, kdim, device=dev, generator=g).to(dtype)
        w8 = torch.randint(-127, 128, (kdim, n), device=dev, generator=g,
                           dtype=torch.int8)
        ws = 1e-4 + 1e-3 * torch.rand(n, device=dev, generator=g)
        bias = (0.1 * torch.randn(n, device=dev, generator=g)).to(dtype)
        # the weight and copies of it whose total is >= 2x the L2: a decode
        # step's calls each read a new layer's weights from device memory
        w8s = [w8] + [torch.randint(-127, 128, (kdim, n), device=dev,
                                    generator=g_cold, dtype=torch.int8)
                      for _ in range(cold_copies(kdim * n) - 1)]
        out = w8_matmul(x, w8, ws, bias)
        ref = w8_matmul_ref(x, w8, ws, bias)
        again = w8_matmul(x, w8, ws, bias)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        esize = x.element_size()
        bms, by = bound(kdim * n + (m * kdim + m * n + n) * esize + 4 * n,
                        2.0 * m * kdim * n,
                        "fp32" if dtype == torch.float32 else "bf16")
        lib_ms, lib_note = int8pack_ms(torch, x, w8, ws)
        plan = w8_mod.w8_plan(m, kdim, n, dtype, sms)
        row = {"name": "w8_matmul", "site": site, "route": "cuda",
               "source": W8_SRC, "replaces": W8_REPLACES,
               "shape": f"x({m},{kdim}) {dt} w8({kdim},{n})",
               "plan": plan._asdict(),
               "ms": cuda_ms(lambda: w8_matmul(x, w8, ws, bias), 20),
               "ms_cold": cuda_ms_cycled(
                   [lambda w=w: w8_matmul(x, w, ws, bias) for w in w8s], 24),
               "plain_ms": cuda_ms(lambda: w8_matmul_ref(
                   x, w8, ws, bias), 20),
               "bound_ms": bms, "bound_by": by,
               "bound_vs": "ms_cold (each call of a decode step reads its "
                           "weights from device memory)",
               "library_ms": lib_ms, "library_computes": lib_note,
               "bitwise_equal_twice": bool(torch.equal(out, again))}
        row["bf16_matmul_ms"], row["bf16_matmul_note"] = bf16_matmul_ms(
            torch, x, w8s, ws)
        del w8s, w8, out, again
        log(f"  w8_matmul {site}: L2-cold {row['ms_cold']:.4f} ms "
            f"({row['ms_cold'] / bms:.2f}x the bound), warm {row['ms']:.4f};"
            f" bf16 matmul {row['bf16_matmul_ms']:.4f} ms; plan {plan}")
        record(row, err, out_tol(torch, ref),
               ok=err <= out_tol(torch, ref) and row["bitwise_equal_twice"],
               note=f"; two calls bitwise equal: "
                    f"{row['bitwise_equal_twice']}")
        del x, ref
    h, d = 32, 128
    for b, s in DECODE_SHAPES:
        bf = torch.bfloat16
        # a read window of a larger pool, as the engines pass it
        pool = torch.randn(2, b, 512, h, d, device=dev, generator=g).to(bf)
        k, v = pool[0, :, :s], pool[1, :, :s]
        q, k1, v1 = (torch.randn(b, 1, h, d, device=dev, generator=g).to(bf)
                     for _ in range(3))
        lens = torch.randint(0, s + 1, (b,), device=dev, generator=g,
                             dtype=torch.int32)
        lens[0], lens[-1] = 0, s          # a parked slot and a full window
        scale = d ** -0.5
        out = prefix_decode_attention(q, k, v, lens, k1, v1, scale=scale)
        ref = prefix_decode_attention_ref(q, k, v, lens, k1, v1, scale=scale)
        torch.cuda.synchronize()
        # each row against its own tolerance (per_row_err); the parked row
        # (length 0) must be exactly its own v1 (weight exp(0) = 1, sum 1)
        err_b, tol_b = per_row_err(torch, out, ref)
        worst = int((err_b / tol_b.clamp_min(1e-30)).argmax())
        parked_exact = bool(torch.equal(out[0], v1[0]))
        n_rows = int(lens.sum())
        bms, by = bound(n_rows * h * d * 2 * 2 + 4 * b * h * d * 2 + 4 * b,
                        4.0 * n_rows * h * d, "fp32")
        row = {"name": "prefix_decode_attention", "site": f"b{b}_s{s}",
               "route": "cuda", "source": DECODE_SRC,
               "replaces": DECODE_REPLACES,
               "shape": f"q({b},1,{h},{d}) cache({b},{s},{h},{d}) bfloat16, "
                        f"{n_rows} valid rows",
               "ms": cuda_ms(lambda: prefix_decode_attention(
                   q, k, v, lens, k1, v1, scale=scale), 20),
               "plain_ms": cuda_ms(lambda: prefix_decode_attention_ref(
                   q, k, v, lens, k1, v1, scale=scale), 20),
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "tol_rule": "per row", "worst_row": worst,
               "worst_row_err": float(err_b[worst]),
               "parked_row_exact": parked_exact}
        record(row, float(err_b.max()), float(tol_b[worst]),
               ok=bool((err_b <= tol_b).all()) and parked_exact,
               note=f" of row {worst}, the nearest its own limit at "
                    f"{float(err_b[worst]):.3e}; rows {lens.tolist()}; "
                    f"parked row exact: {parked_exact}")
        del pool, k, v
    kernel_phase_sd_modes(torch, dev, g, record)
    return rows, failures


def int8pack_ms(torch, x, w8, ws):
    """(ms, note): PyTorch's int8-weight product `torch._weight_int8pack_mm`
    (x @ (w8 * ws) with per-channel scales, no bias: the W8 matmul's
    function but for the bias add) timed as K4's library yardstick. An
    error it raises fails the run."""
    w8t, sc = w8.t().contiguous(), ws.to(x.dtype)
    return (cuda_ms(lambda: torch._weight_int8pack_mm(x, w8t, sc), 20),
            "torch._weight_int8pack_mm: x @ (w8 * ws), the bias add left out")


def bf16_matmul_ms(torch, x, w8s, ws):
    """(ms, note): `torch.matmul` of x in bf16 with the dequantized bf16
    weight, L2-cold as K4's `ms_cold` (copies >= 2x the L2): a reference
    that reads twice the weight bytes, not the same function; the port
    never calls it."""
    wbs = [(w.bfloat16() * ws.bfloat16())
           for w in (w8s * 2)[:cold_copies(2 * w8s[0].numel())]]
    xb = x.bfloat16()
    ms = cuda_ms_cycled([lambda w=w: torch.matmul(xb, w) for w in wbs], 24)
    return ms, ("torch.matmul(x.bfloat16(), bf16(w8) * bf16(ws)), L2-cold: "
                "2x the weight bytes; a reference the port never calls")


def kernel_phase_sd_modes(torch, dev, g, record):
    """Slice 3's kernels (K7-K10) at the shapes phase D gives them; each
    row goes to `record`."""
    import torch.nn.functional as F

    from gill_tpu_torch.ops.attention import (flash_attention_q8,
                                              flash_attention_q8_ref,
                                              mma_tile, quantize_qk)
    from gill_tpu_torch.ops.geglu import geglu_ff, geglu_ff_ref, geglu_plan
    from gill_tpu_torch.ops.ln_matmul import (ln_matmul, ln_matmul_plan,
                                              ln_matmul_ref,
                                              ln_matmul_stacked,
                                              ln_matmul_stacked_ref)

    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def record_twice(row, out, again, want):
        """Four ulps of the largest output, and two calls bit for bit."""
        err = float((out.float() - want.float()).abs().max())
        tol = geglu_tol(want.float())
        row["bitwise_equal_twice"] = bool(torch.equal(out, again))
        record(row, err, tol, ok=err <= tol and row["bitwise_equal_twice"],
               note=f"; two calls bitwise equal: "
                    f"{row['bitwise_equal_twice']}")

    def ln_params(d):
        return ((1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(bf),
                (0.1 * torch.randn(d, device=dev, generator=g)).to(bf))

    for site, m, d in LN_SHAPES:
        x = (2 * torch.randn(m, d, device=dev, generator=g) + 0.3).to(bf)
        ga, be = ln_params(d)
        w = (torch.randn(3, d, d, device=dev, generator=g)
             / math.sqrt(d)).to(bf)
        for name, kk, fn, ref, src, rep in (
                ("ln_matmul", 1, lambda: ln_matmul(x, ga, be, w[0]),
                 lambda: ln_matmul_ref(x, ga, be, w[0]), LN_SRC,
                 LN_REPLACES),
                ("ln_matmul_stacked", 3,
                 lambda: ln_matmul_stacked(x, ga, be, w),
                 lambda: ln_matmul_stacked_ref(x, ga, be, w), LN_SRC,
                 LN3_REPLACES)):
            out, again, want = fn(), fn(), ref()
            torch.cuda.synchronize()
            bms, by = bound((m * d + 2 * d + kk * d * d + kk * m * d) * 2,
                            2.0 * kk * m * d * d, "bf16")
            plan = ln_matmul_plan(m, d, d, kk, sms)
            row = {"name": name, "site": site, "route": "cuda",
                   "source": src, "replaces": rep,
                   "shape": f"x({m},{d}) w({kk},{d},{d}) bfloat16",
                   "plan": {**plan._asdict(), "blocks": plan.blocks},
                   "ms": cuda_ms(fn, 20),
                   "plain_ms": cuda_ms(ref, 20),
                   "bound_ms": bms, "bound_by": by, "library_ms": None}
            record_twice(row, out, again, want)
    for site, m, d in GEGLU_SHAPES:
        x = (2 * torch.randn(m, d, device=dev, generator=g) - 0.2).to(bf)
        ga, be = ln_params(d)
        w1 = (torch.randn(d, 8 * d, device=dev, generator=g)
              / math.sqrt(d)).to(bf)
        b1 = (0.1 * torch.randn(8 * d, device=dev, generator=g)).to(bf)
        w2 = (torch.randn(4 * d, d, device=dev, generator=g)
              / math.sqrt(4 * d)).to(bf)
        b2 = (0.1 * torch.randn(d, device=dev, generator=g)).to(bf)
        ln = dict(ln_gamma=ga, ln_beta=be)
        out = geglu_ff(x, w1, b1, w2, b2, **ln)
        again = geglu_ff(x, w1, b1, w2, b2, **ln)
        want = geglu_ff_ref(x, w1, b1, w2, b2, **ln)
        torch.cuda.synchronize()
        bms, by = bound((2 * m * d + 12 * d * d + 11 * d) * 2,
                        24.0 * m * d * d, "bf16")
        row = {"name": "geglu_ff_ln", "site": site, "route": "cuda",
               "source": GEGLU_SRC, "replaces": GEGLU_LN_REPLACES,
               "shape": f"x({m},{d}) bfloat16, LayerNorm folded",
               "plan": geglu_plan(m, d, sms)._asdict(),
               "ms": cuda_ms(lambda: geglu_ff(x, w1, b1, w2, b2,
                                                     **ln), 20),
               "plain_ms": cuda_ms(lambda: geglu_ff_ref(
                   x, w1, b1, w2, b2, **ln), 20),
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        record_twice(row, out, again, want)
    for site, b, t, s, h, d in Q8_SHAPES:
        q, k, v = (torch.randn(b, n, h, d, device=dev, generator=g).to(bf)
                   for n in (t, s, s))
        sc = 1.0 / math.sqrt(d)
        out = flash_attention_q8(q, k, v, scale=sc)
        want = flash_attention_q8_ref(q, k, v, scale=sc)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        # QK on the int8 tensor cores, PV on the bf16 ones, an exponential
        # a (query, key) pair
        bms, by = bound((2 * b * t * h * d + 2 * b * s * h * d) * 2,
                        2.0 * b * h * t * s * d, "int8",
                        more=[(2.0 * b * h * t * s * d, "bf16")],
                        exps=b * h * t * s)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        reps = 8 if t * s >= 4096 * 4096 else 20
        qk8 = quantize_qk(q, k)
        row = {"name": "flash_mma_q8", "site": site, "route": "cuda",
               "source": MMA_SRC, "replaces": I8_REPLACES,
               "shape": f"q({b},{t},{h},{d}) kv({b},{s},{h},{d}) bfloat16",
               "tile": "x".join(map(str, mma_tile(t))),
               "ms": cuda_ms(lambda: flash_attention_q8(
                   q, k, v, scale=sc), reps),
               # the pre-pass (quantize_qk) and the main kernel apart
               "prepass_ms": cuda_ms(lambda: quantize_qk(q, k), reps),
               "main_ms": cuda_ms(lambda: flash_attention_q8(
                   q, k, v, scale=sc, qk8=qk8), reps),
               "plain_ms": cuda_ms(lambda: flash_attention_q8_ref(
                   q, k, v, scale=sc), reps),
               "bound_ms": bms, "bound_by": by,
               # the exact bf16 attention that K10 approximates
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, scale=sc), reps),
               "library_computes": "exact bf16 attention (SDPA), the "
                                   "function K10 approximates"}
        # both quantize identically: equal int8 values and int32 scores,
        # only the softmax's summation order differs -> two bf16 ulps
        record(row, err, 2.0 * 2.0 ** -7 * float(want.float().abs().max()))
        del q, k, v, qt, kt, vt, out, want, qk8


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Swaps every kernel of the paths for its plain PyTorch version (the
    reference runs of the checks below; the library itself never does)."""
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.ops import attention as attn_mod
    from gill_tpu_torch.ops import decode_attn
    from gill_tpu_torch.ops import ln_matmul as ln_mod
    from gill_tpu_torch.ops import w8_matmul as w8_mod
    from gill_tpu_torch.ops.geglu import geglu_ff_ref

    def flash_plain(q, k, v, *, causal=False, scale=None, kv_len=None,
                    fast=False, block_q=0, block_k=0):
        return attn_mod.flash_attention_ref(q, k, v, causal=causal,
                                            scale=scale, kv_len=kv_len)

    swaps = [(attn_mod, "flash_attention", flash_plain),
             (unet_mod, "geglu_ff", geglu_ff_ref),
             (w8_mod, "w8_matmul", w8_mod.w8_matmul_ref),
             (decode_attn, "prefix_decode_attention",
              decode_attn.prefix_decode_attention_ref),
             (ln_mod, "ln_matmul", ln_mod.ln_matmul_ref),
             (ln_mod, "ln_matmul_stacked", ln_mod.ln_matmul_stacked_ref),
             (attn_mod, "flash_attention_q8", attn_mod.flash_attention_q8_ref)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _counters():
    """{kernel name: (wrapper, attribute holding its launch count)}; the
    LN-folded GEGLU counts on the GEGLU wrapper's own `ln_launches`, and
    csrc/flash_mma.cu (K2 and K10) on flash_attention's `mma_launches`."""
    from gill_tpu_torch.ops import (attention, decode_attn, flash_variants,
                                    geglu, ln_matmul, mm_probe, w8_matmul)

    return {"flash_attention": (attention.flash_attention, "launches"),
            "flash_mma": (attention.flash_attention, "mma_launches"),
            "geglu_ff": (geglu.geglu_ff, "launches"),
            "w8_matmul": (w8_matmul.w8_matmul, "launches"),
            "prefix_decode_attention": (decode_attn.prefix_decode_attention,
                                        "launches"),
            "ln_matmul": (ln_matmul.ln_matmul, "launches"),
            "ln_matmul_stacked": (ln_matmul.ln_matmul_stacked, "launches"),
            "geglu_ff_ln": (geglu.geglu_ff, "ln_launches"),
            "flash_mma_q8": (attention.flash_attention_q8, "launches"),
            "mm_probe": (mm_probe.mm_probe, "launches"),
            "flash_variant": (flash_variants.flash_variant, "launches"),
            "flash_nomax": (flash_variants.flash_nomax, "launches")}


def zero_launches():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


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

    zero_launches()
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
    launches = read_launches()
    report["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    timer.restore()
    model.sd_pipe.decode_latents = orig_decode
    report["phases"] = timer.summary()
    log("request (a):", repr(out_a[0])[:120])
    log("request (b):", [o if isinstance(o, str) else
                         {k: (v if k == "decision" else len(v))
                          for k, v in o.items()} for o in out_b])
    log("main-path launches:", launches)
    for name in ("flash_attention", "flash_mma", "geglu_ff"):
        if launches[name] <= 0:
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
    # Each must launch its kernels: the UNet call K1 (head dim 160), K2
    # and K3, the decode K1 (head dim 512).
    g = torch.Generator(dev).manual_seed(11)
    lat = torch.randn(2, 64, 64, 4, device=dev, generator=g).bfloat16()
    ctx = (0.5 * torch.randn(2, 77, 768, device=dev, generator=g)).bfloat16()
    t = torch.tensor(981.0, device=dev)
    zero_launches()
    a, b = both(lambda: unet_mod.apply(pipe.params["unet"], pipe.cfg.unet,
                                       lat, t, ctx))
    report["unet_step_launches"] = read_launches()
    checks["unet_step_rel_err"] = rel_err(torch, a, b)
    zero_launches()
    a, b = both(lambda: vae_mod.decode(pipe.params["vae_decoder"],
                                       pipe.cfg.vae, lat[:1]))
    report["vae_decode_launches"] = read_launches()
    checks["vae_decode_rel_err"] = rel_err(torch, a, b)
    for key, names in (("unet_step_launches",
                        ("flash_attention", "flash_mma", "geglu_ff")),
                       ("vae_decode_launches", ("flash_attention",))):
        for name in names:
            if report[key][name] <= 0:
                failures.append(f"{name} was not launched in the {key[:-9]}")
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


# ---------------------------------------------------------------------------
# serving (slice 2)
# ---------------------------------------------------------------------------

def serve_trace(n: int, seed: int = 7):
    """bench.py bench_serve's trace: prompt lengths U[16,240] of random ids,
    generation lengths U[16,192]."""
    import numpy as np

    from gill_tpu_torch.serve.engine import ServeRequest

    rng = np.random.RandomState(seed)
    return [ServeRequest(
        uid=i, prompt=rng.randint(2, 1000, size=int(rng.randint(16, 241)))
        .tolist(), max_new_tokens=int(rng.randint(16, 193))) for i in range(n)]


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_a(torch, lm8, cfg, failures):
    """The plain-LM serving engine on the W8 LM over bench_serve's trace."""
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.ops import attention as attn_mod
    from gill_tpu_torch.serve.engine import DecodeEngine, ServeRequest

    rep = {}
    eng = DecodeEngine(lm8, cfg, slots=16, max_seq=512, chunk=32,
                       prefill_buckets=(64, 128, 256), kv_dtype=torch.bfloat16)
    _, rep["warmup_s"] = timed(torch, eng.warmup)
    eng.run([ServeRequest(uid=0, prompt=[5] * p, max_new_tokens=4)
             for p in (20, 100, 200)])
    reqs = serve_trace(48)
    n_tok = sum(r.max_new_tokens for r in reqs)
    s0 = dict(eng.stats)
    zero_launches()
    out, dt = timed(torch, lambda: eng.run_pipelined(list(reqs)))
    launches = read_launches()
    rep["generated_tokens"] = n_tok
    rep["wall_s"] = dt
    rep["tokens_per_s"] = n_tok / dt
    rep["stats"] = {k: eng.stats[k] - s0[k] for k in eng.stats}
    rep["launches"] = launches
    got = sum(len(v) for v in out.values())
    if got != n_tok or len(out) != len(reqs):
        failures.append(f"phase A generated {got} of {n_tok} tokens")
    if any(not 0 <= t < cfg.vocab_size + 64 for v in out.values() for t in v):
        failures.append("phase A emitted an id outside the vocabulary")
    for name in ("w8_matmul", "prefix_decode_attention"):
        if launches[name] <= 0:
            failures.append(f"{name} was not launched in serving phase A")

    # a steady pool: the trace's first 16 prompts, long budgets; each
    # measurement starts from the same refilled state, in turns
    steady = [ServeRequest(uid=i, prompt=r.prompt, max_new_tokens=192)
              for i, r in enumerate(reqs[:16])]

    def refilled():
        eng._reset_pool()
        eng._refill(list(steady))
        torch.cuda.synchronize()

    def chunk_ms(plain_decode: bool) -> float:
        refilled()
        saved = attn_mod.prefix_decode_eligible
        if plain_decode:
            attn_mod.prefix_decode_eligible = lambda *a, **k: False
        try:
            _, t = timed(torch, lambda: eng._run_chunk().numpy())
        finally:
            attn_mod.prefix_decode_eligible = saved
        return 1e3 * t / eng.chunk

    order = (False, True, True, False)
    times = [chunk_ms(p) for p in order]
    rep["decode_step_ms_with_k6"] = [t for t, p in zip(times, order) if not p]
    rep["decode_step_ms_plain_decode"] = [t for t, p in zip(times, order) if p]
    refilled()
    prof = device_profile(lambda: eng._run_chunk().numpy(), sums=("w8_",))
    rep["profile_one_chunk"] = prof
    # the W8 matmul's (K4's) device time a decode step and its share of
    # the chunk's device-busy time
    rep["w8_us_per_step"] = prof["sum_us"]["w8_"] / eng.chunk
    if prof["busy_share"] is not None:
        rep["w8_share_of_device_busy"] = prof["sum_us"]["w8_"] / max(
            prof["busy_us"], 1e-9)
        # the profiler slows the host, so its own busy share reads low: set
        # the device time a step against the unprofiled step time as well
        steps_ms = sorted(rep["decode_step_ms_with_k6"])
        rep["device_ms_per_step"] = prof["busy_us"] / 1e3 / eng.chunk
        rep["device_share_of_unprofiled_step"] = \
            rep["device_ms_per_step"] / steps_ms[0]

    # one full-width decode step, kernels vs plain versions, same state:
    # bf16 activations through 32 layers, each kernel rounding its fp32
    # sums to bf16 where the plain version rounds the same value in another
    # summation order -> 3e-2 relative, argmax equal on >= 15 of 16 rows
    refilled()
    st = eng._dstate
    emb = opt_mod.embed_tokens(lm8, st["tok"][:, None].long())

    def step():
        return opt_mod.forward(lm8, cfg, emb, cache=eng.cache,
                               cache_pos=st["pos"],
                               lm_head=eng._head)["logits"][:, -1]
    a = step()
    with plain_kernels():
        b = step()
    rep["decode_step_logits_rel_err"] = rel_err(torch, a, b)
    rep["decode_step_argmax_equal_rows"] = int(
        (a.argmax(-1) == b.argmax(-1)).sum())
    if not rep["decode_step_logits_rel_err"] <= 3e-2:
        failures.append(f"phase A decode step logits differ from the plain "
                        f"versions: {rep['decode_step_logits_rel_err']}")
    if rep["decode_step_argmax_equal_rows"] < 15:
        failures.append(f"phase A decode step argmax equal on only "
                        f"{rep['decode_step_argmax_equal_rows']} of 16 rows")

    # whole token lists, kernels vs plain versions: the trace's first 16
    # requests with budgets capped at 64 (the plain decode reads the whole
    # window in fp32, so the full trace would take minutes)
    short = [ServeRequest(uid=r.uid, prompt=r.prompt,
                          max_new_tokens=min(r.max_new_tokens, 64))
             for r in reqs[:16]]
    with_k = eng.run_pipelined(list(short))
    with plain_kernels():
        plain = eng.run_pipelined(list(short))
    rep["requests_equal_to_plain"] = sum(with_k[r.uid] == plain[r.uid]
                                         for r in short) / len(short)
    del eng
    torch.cuda.empty_cache()
    return rep


def phase_b(torch, w8_model, prompt_b, failures):
    """The batch GILL API on the W8 model: 8 prompts on the text route,
    then 2 forced through [IMG] (tap ring, retrieval, decision, GILLMapper,
    SD, re-rank)."""
    import numpy as np
    from PIL import Image

    rep = {}
    tok = w8_model.tokenizer
    imgs = [Image.fromarray(np.random.RandomState(20 + i).randint(
        0, 256, (224, 224, 3), dtype=np.uint8)) for i in range(4)]
    text_batch = [
        [imgs[0], "Q: What is in this picture?\nA:"],
        [imgs[1], "Q: What color is the sky here?\nA:"],
        [imgs[2], imgs[3], "Q: How do these two images differ?\nA:"],
        [dialogue_prompt(64, tok)],
        [dialogue_prompt(128, tok)],
        ["A photo of"],
        [imgs[0], "Describe this scene in detail.\n"],
        [dialogue_prompt(200, tok)],
    ]
    img_batch = [[prompt_b],
                 [imgs[1], "Show me a picture of a red canoe at sunset.\n"]]
    images = []
    orig_decode = w8_model.sd_pipe.decode_latents

    def capture_decode(latents):
        out = orig_decode(latents)
        images.append(out)
        return out

    w8_model.sd_pipe.decode_latents = capture_decode
    zero_launches()
    try:
        out_text, rep["text_batch_s"] = timed(
            torch, lambda: w8_model.generate_for_images_and_texts_batch(
                text_batch, num_words=32, slots=8, chunk=16))
        n_img_before = len(images)
        out_img, rep["img_batch_s"] = timed(
            torch, lambda: w8_model.generate_for_images_and_texts_batch(
                img_batch, num_words=16, gen_scale_factor=1e6, slots=8,
                chunk=16))
    finally:
        w8_model.sd_pipe.decode_latents = orig_decode
    rep["launches"] = read_launches()
    for name in ("w8_matmul", "prefix_decode_attention"):
        if rep["launches"][name] <= 0:
            failures.append(f"{name} was not launched in serving phase B")
    if len(out_text) != len(text_batch) or not all(
            o and isinstance(o[0], str) for o in out_text):
        failures.append(f"phase B text batch gave {out_text!r}")
    rep["text_outputs"] = [o[0][:60] for o in out_text]
    nt = w8_model.core.cfg.num_tokens
    gen_prefix = "".join(f"[IMG{i}]" for i in range(nt))
    forced = [len(o) == 2 and o[0].endswith(gen_prefix)
              and isinstance(o[1], dict) and len(o[1]["gen"]) == 1
              and o[1]["decision"][0] in ("gen", "ret") for o in out_img]
    rep["img_runs_force_committed"] = forced
    if len(out_img) != 2 or not all(forced):
        failures.append(f"phase B [IMG] batch did not commit its runs: "
                        f"{out_img!r}")
    new_images = images[n_img_before:]
    if len(new_images) != 2 or not all(
            tuple(x.shape) == (1, 512, 512, 3) and bool(torch.isfinite(x).all())
            for x in new_images):
        failures.append("phase B gave no two finite (1, 512, 512, 3) images")
    return rep


def phase_c(torch, lm8, cfg, failures):
    """A short int8-KV engine run: the plain int8 decode path on the card."""
    from gill_tpu_torch.serve.engine import DecodeEngine, ServeRequest

    rep = {}
    eng = DecodeEngine(lm8, cfg, slots=16, max_seq=512, chunk=32,
                       prefill_buckets=(64, 128, 256), kv_dtype=torch.int8)
    # the trace's first 16 requests, budgets capped at 64 (the plain int8
    # decode widens the whole window to fp32 every layer)
    reqs = [ServeRequest(uid=r.uid, prompt=r.prompt,
                         max_new_tokens=min(r.max_new_tokens, 64))
            for r in serve_trace(48)[:16]]
    zero_launches()
    out, rep["wall_s"] = timed(torch, lambda: eng.run_pipelined(list(reqs)))
    rep["launches"] = read_launches()
    if rep["launches"]["w8_matmul"] <= 0:
        failures.append("w8_matmul was not launched in serving phase C")
    n_tok = sum(r.max_new_tokens for r in reqs)
    rep["tokens_per_s"] = n_tok / rep["wall_s"]
    full = all(len(out[r.uid]) == r.max_new_tokens for r in reqs)
    in_vocab = all(0 <= t < cfg.vocab_size + 64
                   for v in out.values() for t in v)
    if not (full and in_vocab):
        failures.append("phase C (int8 KV) gave short or out-of-vocabulary "
                        "token lists")
    del eng
    torch.cuda.empty_cache()
    return rep


def serving(torch, dev, model, prompt_b):
    from gill_tpu_torch.api import GILL

    report, failures = {}, []
    w8_model, report["quantize_s"] = timed(torch, lambda: GILL(
        model.core, model.params, model.tokenizer, device=dev,
        sd_pipe=model.sd_pipe, retrieval_index=model.index,
        decision_params=model.decision_params, lm_weight_precision="w8"))
    lm8, cfg = w8_model.params["lm"], model.core.opt_cfg
    report["A"] = phase_a(torch, lm8, cfg, failures)
    log("serving phase A:", json.dumps(report["A"]))
    report["B"] = phase_b(torch, w8_model, prompt_b, failures)
    log("serving phase B:", json.dumps(report["B"]))
    report["C"] = phase_c(torch, lm8, cfg, failures)
    log("serving phase C:", json.dumps(report["C"]))
    return report, failures


# ---------------------------------------------------------------------------
# SD modes (slice 3)
# ---------------------------------------------------------------------------

def _unet_inputs(torch, dev, cfg, dtype):
    """The UNet call of the checks: the CFG batch 2 at the pipeline's
    latent size (64 x 64 for SD v1.5 at 512 x 512)."""
    g = torch.Generator(dev).manual_seed(11)
    h = cfg.default_size // cfg.vae_scale
    lat = torch.randn(2, h, h, 4, device=dev, generator=g).to(dtype)
    ctx = _embeddings(torch, cfg, dev, g, 2).to(dtype)
    return lat, torch.tensor(981.0, device=dev), ctx


def _embeddings(torch, cfg, dev, g, n=1):
    return 0.5 * torch.randn(n, cfg.text.max_positions,
                             cfg.unet.cross_attention_dim, device=dev,
                             generator=g)


def _generation(torch, pipe, steps: int, seed: int):
    """One generation at the pipeline's size from seeded embeddings:
    (images, s)."""
    dev = pipe.params["unet"]["conv_in"]["b"].device
    g = torch.Generator(dev).manual_seed(seed)
    emb = _embeddings(torch, pipe.cfg, dev, g)
    return timed(torch, lambda: pipe(prompt_embeds=emb,
                                     num_inference_steps=steps, generator=g))


def _finite_image(torch, img, size: int) -> bool:
    return (tuple(img.shape) == (1, size, size, 3)
            and bool(torch.isfinite(img).all()))


def phase_d(torch, dev, model, prompt_b):
    """GILL_SD_FUSE_LN (D1), q8 (D2), sd_precision="int8" with the SD
    batch queue (D3) and DPM-Solver++ (D4) at full width on the main path's
    SD v1.5 weights. Launch counts are set to 0 just before each driven
    step and read just after."""
    import threading

    import torch.nn.functional as F

    from gill_tpu_torch.api import GILL
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.ops import quant

    rep, failures = {}, []
    pipe = model.sd_pipe
    params, ucfg = pipe.params["unet"], pipe.cfg.unet
    size = pipe.cfg.default_size
    lat, t, ctx = _unet_inputs(torch, dev, pipe.cfg,
                               params["conv_in"]["b"].dtype)

    def call(p=params, **kw):
        return unet_mod.apply(p, ucfg, lat, t, ctx, **kw)

    def need(launches, names, step):
        for name in names:
            if launches[name] <= 0:
                failures.append(f"{name} was not launched in {step}")

    # D1: LayerNorm folded into the q/k/v projections and the GEGLU
    base, rep["unet_call_bf16_s"] = timed(torch, call)
    unet_mod.FUSE_LN = True
    try:
        zero_launches()
        fused, rep["unet_call_fused_ln_s"] = timed(torch, call)
        rep["unet_call_fused_ln_launches"] = read_launches()
        rep["fused_ln_rel_err_vs_unfused"] = rel_err(torch, fused, base)
        zero_launches()
        img, rep["gen512_fused_ln_50step_s"] = _generation(torch, pipe, 50, 21)
        rep["gen512_fused_ln_launches"] = launches_d1 = read_launches()
    finally:
        unet_mod.FUSE_LN = False
    need(rep["unet_call_fused_ln_launches"],
         ("ln_matmul", "ln_matmul_stacked", "geglu_ff_ln"), "D1's UNet call")
    need(launches_d1, ("ln_matmul", "ln_matmul_stacked", "geglu_ff_ln"),
         "D1's generation")
    if not rep["fused_ln_rel_err_vs_unfused"] <= 3e-2:
        failures.append(f"D1 fused-LN UNet call differs from the unfused "
                        f"call: {rep['fused_ln_rel_err_vs_unfused']}")
    if not _finite_image(torch, img, size):
        failures.append("D1 gave no finite image")
    _, rep["gen512_bf16_50step_s"] = _generation(torch, pipe, 50, 21)

    # D2: int8-QK attention
    zero_launches()
    q8, rep["unet_call_q8_s"] = timed(torch, lambda: call(q8=True))
    rep["unet_call_q8_launches"] = launches_d2 = read_launches()
    need(launches_d2, ("flash_mma", "flash_mma_q8"), "D2's UNet call")
    with plain_kernels():
        q8_plain = call(q8=True)
    torch.cuda.synchronize()
    rep["q8_rel_err_vs_plain_versions"] = rel_err(torch, q8, q8_plain)
    rep["q8_rel_distance_to_bf16_call"] = rel_err(torch, q8, base)
    if not rep["q8_rel_err_vs_plain_versions"] <= 3e-2:
        failures.append(f"D2 q8 UNet call differs from its plain versions: "
                        f"{rep['q8_rel_err_vs_plain_versions']}")
    del q8, q8_plain, fused

    # D3: the W8A8 UNet and the SD batch queue
    pipe8, rep["quantize_s"] = timed(torch, lambda: StableDiffusionPipeline(
        pipe.cfg, pipe.params, quantize=True))
    p8 = pipe8.params["unet"]
    out8, rep["unet_call_int8_s"] = timed(torch, lambda: call(p8))
    _, rep["unet_call_int8_again_s"] = timed(torch, lambda: call(p8))
    rep["int8_rel_distance_to_bf16_call"] = rel_err(torch, out8, base)
    if not bool(torch.isfinite(out8).all()):
        failures.append("D3 int8 UNet call is not finite")
    # int32 sums at UNet shapes against exact CPU products: the first
    # block's GEGLU projection (8192 x 320 @ 320 x 2560 at 512 x 512) and
    # conv_in (K = 36)
    g = torch.Generator(dev).manual_seed(31)
    wq = p8["down"][0]["attns"][0]["block"]["geglu"]["wq"]
    xq = torch.randint(-127, 128, (2 * lat.shape[1] * lat.shape[2],
                                   wq.shape[0]), device=dev, generator=g,
                       dtype=torch.int8)
    sums_ok = torch.equal(quant.int_mm(xq, wq).cpu().long(),
                          xq.cpu().long() @ wq.cpu().long())
    lq = torch.randint(-127, 128, tuple(lat.shape), device=dev, generator=g,
                       dtype=torch.int8)
    cw = p8["conv_in"]["wq"]
    conv = quant.conv2d_int32(lq, cw, padding=1).cpu()
    exact = F.conv2d(lq.cpu().double().permute(0, 3, 1, 2),
                     cw.cpu().double(), padding=1).permute(0, 2, 3, 1)
    rep["int32_sums_equal_exact"] = sums_ok and torch.equal(
        conv.double(), exact)
    if not rep["int32_sums_equal_exact"]:
        failures.append("D3 int8 products differ from exact CPU products")
    del out8, xq, lq

    gq = GILL(model.core, model.params, model.tokenizer, device=dev,
              sd_pipe=pipe8, retrieval_index=model.index,
              decision_params=model.decision_params)
    queue = gq.enable_sd_batching()
    ready = threading.Barrier(3)
    futs = [None] * 3

    def client(i):
        gen = torch.Generator(dev).manual_seed(40 + i)
        emb = _embeddings(torch, pipe.cfg, dev, gen)
        ready.wait()
        futs[i] = queue.submit(emb, guidance_scale=7.5,
                               num_inference_steps=50, generator=gen)

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        imgs = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        rep["queue_batch_s"] = time.perf_counter() - t0
        rep["queue_stats_after_batch"] = dict(queue.stats)
        st = queue.stats
        if (st["batches"], st["jobs"], st["latents"],
                st["padded_latents"]) != (1, 3, 3, 4):
            failures.append(f"D3 queue did not coalesce 3 jobs into one "
                            f"batch of 4: {st}")
        if not all(_finite_image(torch, x, size) for x in imgs):
            failures.append("D3 queue gave no three finite images")
        images = []
        orig_decode = pipe8.decode_latents

        def capture(latents):
            out = orig_decode(latents)
            images.append(out)
            return out

        pipe8.decode_latents = capture
        out_b, rep["request_b_int8_queue_s"] = timed(
            torch, lambda: gq.generate_for_images_and_texts(
                [prompt_b], num_words=16, gen_scale_factor=1e6))
        pipe8.decode_latents = orig_decode
        rep["queue_stats"] = dict(queue.stats)
        if not (len(out_b) == 2 and isinstance(out_b[1], dict)
                and len(out_b[1]["gen"]) == 1 and queue.stats["jobs"] == 4
                and len(images) == 1 and _finite_image(torch, images[0], size)):
            failures.append(f"D3 request (b) did not go through the queue "
                            f"to a finite image: {out_b!r}")
    finally:
        queue.close()
    del gq, pipe8, p8, imgs
    torch.cuda.empty_cache()

    # D4: DPM-Solver++ at 25 steps
    dpm = StableDiffusionPipeline(pipe.cfg, pipe.params, sampler="dpm++")
    img, rep["gen512_dpmpp_25step_s"] = _generation(torch, dpm, 25, 22)
    if not _finite_image(torch, img, size):
        failures.append("D4 gave no finite image")
    return rep, failures


# ---------------------------------------------------------------------------
# probe scripts (slice 4)
# ---------------------------------------------------------------------------

def probe_kernel_rows(torch, dev, record):
    """S1's seven cases and every S2/S3 variant of the sweep at the probes'
    full shapes, each against its plain version; each row goes to
    `record`."""
    import torch.nn.functional as F

    from gill_tpu_torch.ops import flash_variants as fv
    from gill_tpu_torch.ops import mm_probe as mp
    from gill_tpu_torch.scripts import attn_mxu_probe, attn_sweep

    for case, m, k, n, dtype in attn_mxu_probe.CASES:
        a, b = attn_mxu_probe.operands(m, k, n, dtype, dev)
        out, want = mp.mm_probe(a, b), mp.mm_probe_ref(a, b)
        torch.cuda.synchronize()
        i8 = dtype == "int8"
        # int8: exact int32 sums; bf16: fp32 sums of exact products in
        # another order, 1e-5 of the largest output
        err = float((out.double() - want.double()).abs().max())
        tol = 0.0 if i8 else 1e-5 * float(want.abs().max())
        bms, by = bound((m * k + k * n) * a.element_size() + 4 * m * n,
                        2.0 * m * k * n * mp.REPS, "int8" if i8 else "bf16")
        row = {"name": "mm_probe", "site": case.split()[0], "route": "cuda",
               "source": MM_PROBE_SRC, "replaces": MM_PROBE_REPLACES,
               "shape": f"a({m},{k}) b({k},{n}) {dtype}, {mp.REPS} products",
               "ms": cuda_ms(lambda: mp.mm_probe(a, b), 20),
               "plain_ms": cuda_ms(lambda: mp.mm_probe_ref(a, b), 5),
               "bound_ms": bms, "bound_by": by,
               "library_ms": mp.REPS * cuda_ms(
                   lambda: attn_mxu_probe.library_call(a, b), 20),
               "library_computes": f"{mp.REPS} x one "
                                   f"{'torch._int_mm' if i8 else 'torch.matmul'}"
                                   f" product"}
        record(row, err, tol)
        del a, b, out, want
    b_, s_, h_, d_ = attn_sweep.SHAPE
    q, k, v = attn_sweep.inputs(attn_sweep.SHAPE, dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bms, by = bound(4 * b_ * s_ * h_ * d_ * 2, 4.0 * b_ * h_ * s_ * s_ * d_,
                    "bf16", exps=b_ * h_ * s_ * s_)
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 5)
    for spec in attn_sweep.VARIANTS:
        name, _, _, probs, k_t, nomax = spec
        fn, bq, bk = attn_sweep.build(spec, s_)
        if nomax:
            ref = lambda: fv.flash_nomax_ref(q, k, v)  # noqa: E731
        else:
            ref = lambda: fv.flash_variant_ref(  # noqa: E731
                q, k, v, block_k=bk, bf16_probs=probs == "bfloat16")
        mode = fv.NOMAX if nomax else fv.SINGLE if bk == s_ else fv.ONLINE
        plan = fv.variant_plan(b_, s_, s_, h_, d_, mode, probs == "bfloat16",
                               k_t, bq)
        out, again, want = fn(q, k, v), fn(q, k, v), ref()
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        row = {"name": "flash_nomax" if nomax else "flash_variant",
               "site": name, "route": "cuda",
               "source": FV_SRC,
               "replaces": NOMAX_REPLACES if nomax else FV_REPLACES,
               "shape": f"q/k/v({b_},{s_},{h_},{d_}) bfloat16, block_q {bq} "
                        f"block_k {bk}{' kt' if k_t else ''}",
               "hopper_tile": "x".join(map(str, fv.hopper_tile(bq))),
               "plan": plan._asdict(),
               "ms": cuda_ms(lambda: fn(q, k, v), 5),
               "plain_ms": cuda_ms(ref, 3),
               "bound_ms": bms, "bound_by": by, "library_ms": sdpa_ms,
               "library_computes": "exact bf16 attention (SDPA)",
               "bitwise_equal_twice": bool(torch.equal(out, again))}
        row["vs_library"] = row["ms"] / sdpa_ms
        if k_t:   # the wrapper's (B*H, D, S) copy of k, inside `ms`
            row["k_copy_ms"] = cuda_ms(
                lambda: k.permute(0, 2, 3, 1).contiguous(), 5)
        # one fp32 quotient rounded to bf16 on both sides, sums in another
        # order: two bf16 ulps of the largest output, as for K1/K2
        tol = 2.0 * 2.0 ** -7 * float(want.float().abs().max())
        record(row, err, tol, ok=err <= tol and row["bitwise_equal_twice"],
               note=f"; {row['vs_library']:.2f}x SDPA; two calls bitwise "
                    f"equal: {row['bitwise_equal_twice']}")
        del out, again, want
        torch.cuda.empty_cache()


def phase_e(torch, dev):
    """The probe kernels S1-S3 against their plain versions, then every
    ported probe script's measuring function once at its default shapes
    with its repetitions cut (it prints its rows). The launch counts are set
    to 0 just before the probes and read just after: S1-S3 must have
    launched there. Returns (kernel rows, report, failures)."""
    from gill_tpu_torch.scripts import (attn_mxu_probe, attn_sweep,
                                        int8_probe, profile_ln_fuse,
                                        profile_prefix_decode, profile_sd,
                                        profile_sd_ablate, w8_probe)

    rows, failures, rep = [], [], {}
    t0 = time.perf_counter()
    probe_kernel_rows(torch, dev, recorder(rows, failures))
    rep["kernel_rows_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    probes = [("attn_mxu_probe", lambda: attn_mxu_probe.probe(
                   device="cuda", n1=1, n2=3)),
              ("attn_sweep", lambda: attn_sweep.sweep(
                  device="cuda", n1=1, n2=3)),
              ("int8_probe", lambda: int8_probe.probe(
                  device="cuda", n1=1, n2=3)),
              ("profile_sd", lambda: profile_sd.profile(
                  device="cuda", n1=1, n2=3, unet_reps=1)),
              ("profile_sd_ablate", lambda: profile_sd_ablate.ablate(
                  device="cuda", reps=1)),
              ("profile_ln_fuse", lambda: profile_ln_fuse.probe(
                  device="cuda", n1=1, n2=3, unet_reps=1)),
              ("profile_prefix_decode", lambda: profile_prefix_decode.probe(
                  device="cuda", n_lo=2, n_hi=6)),
              ("w8_probe", lambda: w8_probe.probe(device="cuda", reps=12))]
    zero_launches()
    for name, run in probes:
        t0 = time.perf_counter()
        log(f"probe {name}:")
        out = run()
        rep[f"{name}_s"] = time.perf_counter() - t0
        bad = [r for r in out if "failed" in r]
        if not out or bad:
            failures.append(f"probe {name}: {len(out)} rows, failed: {bad}")
        nums = [v for r in out for v in r.values()
                if isinstance(v, float)]
        if not all(math.isfinite(v) for v in nums):
            failures.append(f"probe {name} printed a value that is not "
                            f"finite")
        if name == "attn_sweep":
            # every variant computes the first row's attention (K2): each
            # is within two bf16 ulps of the exact output, so within four
            # of K2's
            top = max((r["maxerr"] / (4 * 2.0 ** -7 * r["ref_max"])
                       for r in out if "maxerr" in r), default=0.0)
            rep["attn_sweep_max_err_vs_k2_in_4_ulps"] = top
            if top > 1.0:
                failures.append(f"attn_sweep: a variant is {top} times four "
                                f"bf16 ulps from K2's output")
        torch.cuda.empty_cache()
    rep["launches"] = launches = read_launches()
    for name in ("mm_probe", "flash_variant", "flash_nomax", "w8_matmul"):
        if launches[name] <= 0:
            failures.append(f"{name} was not launched in phase E's probes")
    return rows, rep, failures


# one run of a tree's own main path, in a fresh process (argv[1]: its
# root, argv[2]: this script, whose tree's scripts/_timing.py profiles both
# trees), then ten timed full-width UNet calls and one profiled one
_AB_CHILD = """
import importlib.util, json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from gill_tpu_torch.models.sd import unet as unet_mod
from gill_tpu_torch.ops import _build
spec = importlib.util.spec_from_file_location("timing_ab", os.path.join(
    os.path.dirname(sys.argv[2]), "gill_tpu_torch", "scripts", "_timing.py"))
me = importlib.util.module_from_spec(spec)
spec.loader.exec_module(me)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
dev = torch.device("cuda", 0)
with torch.no_grad():
    model, _, rep, fails = cs.main_path(torch, dev)
    pipe = model.sd_pipe
    g = torch.Generator(dev).manual_seed(11)
    lat = torch.randn(2, 64, 64, 4, device=dev, generator=g).bfloat16()
    ctx = (0.5 * torch.randn(2, 77, 768, device=dev, generator=g)).bfloat16()
    t = torch.tensor(981.0, device=dev)
    step = lambda: unet_mod.apply(pipe.params["unet"], pipe.cfg.unet, lat, t,
                                  ctx)
    unet_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        unet_ms.append(1e3 * (time.perf_counter() - t0))
    prof = me.device_profile(step, top=6)
    # the process's host speed alone: a small CPU tensor op and pure Python
    x = torch.zeros(16)
    t0 = time.perf_counter()
    for _ in range(20000):
        x.add_(1)
    host_op_us = (time.perf_counter() - t0) / 20000 * 1e6
    t0 = time.perf_counter()
    sum(range(5_000_000))
    host_py_ms = 1e3 * (time.perf_counter() - t0)
    # the tree's own W8 matmul at this script's W8_SHAPES (argv[3]), warm
    # and cycling through weight copies >= 2x the L2
    from gill_tpu_torch.ops.w8_matmul import w8_matmul
    w8_ms = {}
    for site, m, k, n, dt in json.loads(sys.argv[3]):
        x = torch.randn(m, k, device=dev, generator=g).to(getattr(torch, dt))
        ws8 = [torch.randint(-127, 128, (k, n), device=dev, generator=g,
                             dtype=torch.int8)
               for _ in range(me.cold_copies(k * n))]
        ws = 1e-4 + 1e-3 * torch.rand(n, device=dev, generator=g)
        w8_ms[site] = {
            "ms": me.cuda_ms(lambda: w8_matmul(x, ws8[0], ws), 20),
            "ms_cold": me.cuda_ms_cycled(
                [lambda w=w: w8_matmul(x, w, ws) for w in ws8], 24)}
        del ws8
ph = rep["phases"]
print("AB " + json.dumps({
    "request_a_s": rep["request_a_s"], "request_b_s": rep["request_b_s"],
    **{k + "_ms": ph[k]["mean_ms"] for k in ("unet_step", "opt_decode_token",
                                              "clip_vision", "vae_decode")},
    "unet_call_ms_min": min(unet_ms), "unet_call_ms_mean": sum(unet_ms) / 10,
    "unet_profiled": prof, "host_cpu_op_us": host_op_us,
    "host_python_ms": host_py_ms, "w8_matmul": w8_ms, "failures": fails,
    "ptxas_if_built_here": {n: [ln.split(":", 1)[-1].strip() for ln in
                                txt.splitlines() if "registers" in ln]
                            for n, txt in _build.BUILD_LOG.items()}}))
"""


def ab_main_path(other: str, rounds: int, order: str = "otto") -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "available")
    other = os.path.abspath(other)
    log(f"device: {smi_line()}")
    ok = True
    for i in range(rounds):
        for name, root in [{"o": ("other", other), "t": ("this", REPO)}[c]
                           for c in order]:
            run = subprocess.run([sys.executable, "-c", _AB_CHILD, root,
                                  os.path.abspath(__file__),
                                  json.dumps(W8_SHAPES)],
                                 cwd=root, capture_output=True, text=True)
            line = [ln for ln in run.stdout.splitlines()
                    if ln.startswith("AB ")]
            if run.returncode != 0 or not line:
                log(run.stdout[-2000:], run.stderr[-4000:])
                raise RuntimeError(f"main path of {root} failed "
                                   f"(rc {run.returncode})")
            res = json.loads(line[0][3:])
            ok = ok and not res["failures"]
            log("AB", json.dumps({"round": i, "tree": name, "root": root,
                                  **res}))
    log(smi_line())
    return 0 if ok else 1


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
        model, launches, report, path_failures = main_path(torch, dev)
        failures += path_failures
        log("main path:", json.dumps(report))
        prompt_b = dialogue_prompt(256, model.tokenizer)
        serve_report, serve_failures = serving(torch, dev, model, prompt_b)
        failures += serve_failures
        t0 = time.perf_counter()
        d_report, d_failures = phase_d(torch, dev, model, prompt_b)
        d_report["wall_s"] = time.perf_counter() - t0
        failures += d_failures
        log("SD modes phase D:", json.dumps(d_report))
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        e_rows, e_report, e_failures = phase_e(torch, dev)
        e_report["wall_s"] = time.perf_counter() - t0
        rows += e_rows
        failures += e_failures
        log("probe phase E:", json.dumps(e_report))
    # launches on each kernel's own paths: slice 1's main path for flash
    # and GEGLU, serving phases A and B for the W8 and decode kernels, the
    # fused-LN generation (D1) for K7-K9, the q8 UNet call (D2) for K10 and
    # phase E's probes for S1-S3
    path_launches = {**d_report["gen512_fused_ln_launches"],
                     "flash_mma_q8": d_report["unet_call_q8_launches"][
                         "flash_mma_q8"],
                     **{name: e_report["launches"][name] for name in
                        ("mm_probe", "flash_variant", "flash_nomax")}}
    for row in rows:
        name = row["name"]
        if name in ("flash_attention", "flash_mma", "geglu_ff"):
            row["launches"] = launches[name]
        elif name in ("w8_matmul", "prefix_decode_attention"):
            row["launches"] = (serve_report["A"]["launches"][name]
                               + serve_report["B"]["launches"][name])
        else:
            row["launches"] = path_launches[name]
    log(f"chip_smoke wall time {time.perf_counter() - T_START:.1f} s")
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
    if sys.argv[1:2] == ["--ab-main-path"]:
        sys.exit(ab_main_path(sys.argv[2], *[f(a) for f, a in zip(
            (int, str), sys.argv[3:5])]))
    sys.exit(main())
