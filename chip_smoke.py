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
   apart. The valid-prefix decode attention (K6) runs at every
   DECODE_SHAPES row (OPT-6.7B's H 32, D 128; B4 S2048 its whole 2,048
   positions) with a parked row, a full one and rows ending on its plan's
   split boundaries: each row within its own tolerance, the parked row
   exactly its v1, two calls bit for bit, and its `decode_plan` the C
   side's; it is also timed L2-cold (`ms_cold`, as a decode step reads
   each layer's cache) beside `flat_read_ms`, one `torch.sum` over as many
   contiguous bytes as its valid rows hold, and its library time is
   `scaled_dot_product_attention` over the rows with each row's own token
   appended and a boolean valid-prefix mask (`decode_sdpa`).
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
       profiled chunk and the W8 matmul's (K4) and the decode attention's
       (K6) device us a step in it;
   (B) `generate_for_images_and_texts_batch` (8 slots, chunk 16): 8 prompts
       on the text route, then 2 with gen_scale_factor=1e6 through the tap
       ring, retrieval, the decision MLP, GILLMapper, SD and the re-rank;
   (C) `DecodeEngine(kv_dtype=torch.int8)` on 16 requests of the trace
       (the plain int8 decode path);
   (P) the serving probes' measuring functions (profile_serve,
       profile_gill_serve, profile_serve_sched, profile_prefix,
       profile_chat_extend, profile_decode, profile_opt67,
       profile_serve_prefix_decode) on that W8 LM and the W8 GILL around
       it, repetitions and traces cut (`serving_probes`): each prints its
       rows; the prefix run's, the incremental chat turns' and K6's tokens
       must equal the plain run's, the cold turns' and the plain decode
       path's; K4 and K6 must launch there.
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
   its seven cases, each row with its `mm_plan` and wgmma's share of the
   type's peak, the sweep's flash variants S2 and S3 at B 8, S 4096,
   H 8, D 40, each row with its `variant_plan`, its ratio to SDPA and two
   calls bit for bit), then every probe of gill_tpu_torch/scripts/ once at
   its default shapes with its repetitions cut, printing its rows (attn_mxu_
   probe, attn_sweep, int8_probe, profile_sd, profile_sd_ablate,
   profile_ln_fuse, profile_prefix_decode, w8_probe, profile_specdec, and
   the block probes flash_blockk_probe, K2 at every tile at B 8, and
   attn_pack_probe); S1-S3, K4 and K2 must launch there and no probe row
   may fail.
8. Online serving (slice 11), phase F, on phase A's engine and tokens
   (`serve/online.py` OnlineEngine): (F1) the trace's first 24 requests
   from 4 threads at once; (F2) the same requests with exponential gaps
   at half the request rate phase A sustained: time to first token and inter-token
   gap p50 / p99, tokens/s, the device's busy share over a 2 s profiled
   window and launches; (F3) a queued and an in-flight request cancelled
   while the scheduler is parked at a chunk boundary; (F4) `make_server`
   on 127.0.0.1: four concurrent clients, two streaming, a prefix and a
   prefixed generate, a client that resets after 3 lines; every request's
   tokens bit for bit phase A's. (F6) `SpeculativeDecoder` (k = 8, a
   100-token prompt) on the W8 target with the target itself (64 tokens)
   and a random OPT-125m (16: it accepts nothing) as drafts: tokens equal
   to the target's greedy one-token decode and, with the target as draft,
   every refutable draft accepted, or each split a near-tie (the two
   sides' logits differ by at least the decode side's top-2 gap); round
   and plain-step ms. After phases B and C, (F5) the async GILL API on
   the main path's bf16 model: three concurrent `generate_async` calls
   (text, image + text, [IMG] with one 50-step 512² generation; at least
   16 word tokens each) held to the batch API's tokens, captions and
   route, and a registered + extended chat prefix to the whole
   conversation. K4 and K6 must launch in F1-F4 and F6, K1 in F1 and F5.
   Each phase prints its `phase_s`.
9. Real-weight loading and the SD text path (slice 12), phase G, after
   phase D on the main path's trees: (G1) a weights directory in the HF /
   diffusers layouts, bf16, written with this script's pure-Python
   safetensors writer (CLIP ViT-L/14 with a random visual projection; SD
   v1.5 `unet/`, `vae/` with a random encoder, `text_encoder/`, a random
   `safety_checker/`, `tokenizer/` of `CLIPBPETokenizer.tiny()`), OPT at
   OPT-6.7B's widths with 4 of its 32 layers as `pytorch_model.bin`, and a
   reference-format `pretrained_ckpt.pth.tar` of the adapters; (G2)
   `load_gill(model_dir, weights_dir=)` and `weights.loader.load_opt`:
   every loaded leaf equal to the tree it was written from, bit for bit,
   the SD tokenizer and the safety checker present (load s, peak host
   RSS); (G3) `sd_pipe(prompt=[...])`, 50 PNDM steps, CFG 7.5, 512², the
   checker on: finite, equal to the same call on the in-memory trees (or
   within 3e-2 relative), its unconditional embeddings `encode_text([""])`
   (their distance from the zeros used before printed), the text encoder
   (K2 at head dim 64, causal, 77 tokens), a UNet call and the VAE decode
   within 3e-2 relative of their plain-version runs; (G4)
   `vae.encode` of the image within 3e-2 of its plain run, decode(encode)
   finite; (G5) the checker's scores within 1e-4 of the plain run, flags
   equal away from the rounding boundary, thresholds of -10 black every
   image out; (G6) `get_log_likelihood_scores` within 1e-4 relative of
   the plain run. K1, K2 and K3 must launch in G3-G6; the phase prints its
   `phase_s`.
10. Training (slice 13), phase H, after phase E and outside the no_grad
   block the other phases run in: (H1) `gill_tpu_torch.main.main(argv)`
   in this process at full width (OPT-6.7B + CLIP ViT-L/14, bf16 frozen
   trees, fp32 adapters, batch 32, 4 steps, a validation before and after
   them) on a stub CC3M-layout set (128 / 32 examples, 224², 77 x 768
   clip_embs) with a byte-level tokenizer of OPT's 50,265 entries: every
   loss finite, the meter lines, TB's train/val scalars and four image
   grids read back, `ckpt/` and `ckpt_best/` leaf for leaf the trained
   adapters, the frozen trees' bits unchanged, the adapters moved, the
   [IMG] rows at the frozen rows' mean norm (1e-3); s a step (median of
   steps 2-4), examples/s, peak memory, the flash kernels' launches a
   step (CLIP's attention, nonzero) and a validation; (H2) one batch-8
   step's loss and adapter gradients against the same step with every
   kernel swapped for its plain version (cosine >= 0.99, norms within
   2e-2, loss within 1e-2), no kernel launched inside an LM forward
   under grad; (H3) the same step with remat (bit for bit, else within
   1e-3), the peak memory of both, and one remat step at batch 200;
   (H4) one step with the LM in W8: finite, the adapters moved, the loss
   within 5e-2 of the bf16 loss, K4 not launched under grad. It prints
   the card's name and power limit and its `phase_s`.
11. The distributed layer (slice 14), phase I, after phase H with every
   earlier model freed: rank groups share cuda:0 over gloo
   (`gill_tpu_torch.parallel.launch.run_ranks`: a file-store rendezvous,
   a process-group timeout and a join limit; a failed or hung rank fails
   the phase). (I1) OPT-6.7B at full width, bf16, random from one seed in
   every process: `DecodeEngine` at tp 1 here, then `DecodeEngine(mesh=,
   device=)` at tp 2, each rank handing it the tree on the host so that
   only its shard reaches the card, over the trace's first 16 requests, budgets capped at 64: each
   request's tokens against tp 1 (the share equal, the first
   divergence), a teacher-forced prefill's last hidden states within
   I_HIDDEN_RTOL, K1 and K6 launches a rank, tokens/s, each rank's gates
   and plans (K1 at h16 d128 causal, K6 at 16 heads for the rank's
   pool); then 8 of the 32 layers in fp32, every token equal to tp 1's,
   and a registered prefix reused; then a world of 1 on NCCL through the
   mesh code path, tokens equal to the plain engine's. (I4) inside I1's
   ranks: the tp-2 bf16 engine behind `OnlineEngine` (rank 0 the leader,
   rank 1 following its ticks), the same 16 requests arriving at I4_RATE
   a second with one cancelled while queued and one in flight (its
   budget raised to I4_FLIGHT_BUDGET, five chunks): every
   other request's tokens equal to that engine's run_pipelined tokens,
   the cancelled ones prefixes of them, K1 and K6 launched on each rank,
   every follower's counters rank 0's; time to first token p50 / p99 and
   tokens/s; then `GillOnlineEngine` over a tp-2 `GillDecodeEngine` on
   the 8-layer fp32 tree with random [IMG] rows and I4_GILL embedding
   prompts, tokens equal to tp 1's `GillDecodeEngine.run`. (I2) the train step
   at full width on a global batch of 16, in one process, then at dp 2 (8
   rows a rank, unequal valid-token counts) and at tp 2: the loss within
   I_LOSS_RTOL, every adapter gradient at cosine >= I_GRAD_COS and its
   norm within I_GRAD_NORM_REL, adapters after the update bit for bit
   equal across the ranks, K2 launched and
   K1 / K4 not on each rank; the dp-2 ranks also build the 2.9M x 256
   index sharded over "data", top-3 ids and scores bit for bit the
   one-process index's (whose topk_batch is timed beside the one product
   it took before its scores were windowed); an fp32 control (4 of 32
   layers) at dp 2, its gradients held to I_GRAD_COS_FP32 and
   I_GRAD_NORM_REL_FP32.
   (I3) `python -m torch.distributed.run --nproc-per-node 2 -m
   gill_tpu_torch.main ... --dp-size 2 --ckpt-backend orbax` at phase H's
   width, batch 16: two steps, the validations, `orbax_2/`, the losses
   finite and equal on both ranks, one TensorBoard file (rank 0), the
   checkpoint as read back equal to torch.distributed.checkpoint's own
   reading, then a one-step resume from it on both ranks. Prints each
   part's report, memory per rank, `phase_s` and the card's name and
   power limit.
12. The evals, the demo, the examples and the data / decision scripts
   (slice 15), phase J, after phase G on the main path's model, each part
   with the launch counts set to 0 before it and read after, on a line
   of its own with its seconds, peak memory and the card's name and power
   limit: (J1) `evals.generate_vist_images` on two synthetic stories of
   five steps (seeded 224² PNGs), sequentially then at --batch 2: one
   finite 512² PNG a story, the two routes' texts equal, K1, K2 and K3
   launched, K6 on --batch; (J2) `evals.compute_clip_similarity` (a random
   fp32 ViT-L/14, as without weights) on J1's images against the stories'
   last ones: scores finite in [-1, 1], an image against itself 1 within
   1e-5, K1 launched; (J3) `evals.lpips_2dirs` at 256² on seeded random
   AlexNet weights in gill_tpu's .npz layout: d(x, x) < 1e-6, d(x, noisy
   x) > 1e-3, the card within 1e-4 relative of --device cpu; (J4)
   `scripts.extract_img_embs` on 64 images at batch 32: the file read back
   bit for bit the model's own retrieval embeddings, images/s, K1
   launched; (J5) `scripts.preprocess_sd_embeddings` on 8 captions ((77,
   768) fp16 files, none pending after) and `scripts.generate_sd_p2_images`
   on 2 prompts with the main path's SD weights (finite 512² PNGs; K1, K2,
   K3); (J6) `scripts.train_decision_classifier` on 64 synthetic prompts
   (features at OPT-6.7B's 4,096), 200 steps, the saved MLP loaded through
   `load_decision_model` routing one forced-[IMG] request; (J7) the demo's
   `ChatSession` (a text turn, then an image forced with
   gen_scale_factor 1e6) and its HTML export, the REPL on scripted stdin,
   `examples.inference_examples`' four examples,
   `scripts.validate_real_weights` without assets (every check SKIPPED,
   status 0) and, inside phase H1, `scripts.prune_model_ckpt` on its
   checkpoint (the `.npz` equal to `ckpt_best/`'s adapters).
13. The native host engines and the closing tools (slice 17), phase N,
   after phase H: (N1) `gill_tpu_torch.native`'s BPE and image engines
   built with g++ here, each printed as `native_bpe` / `native_image`
   "built" or "unavailable: <the compiler's last line>" (a missing
   libjpeg / libpng is reported, not failed); a built image engine's
   `decode_preprocess` within N_IMAGE_TOL of `clip_preprocess` on seeded
   JPEGs, PNGs, a grayscale and a palette PNG, bad bytes giving None; a
   built BPE engine's ids equal to the Python path's on the fixture
   vocabulary (`scripts.make_tokenizer_fixture`) over a long seeded text;
   phase H1's training set (224² PNGs) and as many 500 x 375 JPEGs
   through `TsvDataset` + `DataLoader` with the image engine and under
   GILL_NO_NATIVE_IMAGE=1, in turns: items/s of each and their batches
   within N_IMAGE_TOL. (N2) `scripts.
   profile_kv_window`'s perf phase, cut: a random OPT-6.7B in W8 on phase
   A's engine construction (16 slots, chunk 32), the trace's first 16
   requests with budgets capped at 64, max_seq 512 and 2048 x the read
   ladder off / on: tokens/s and the mean window; the ladder on and off
   give the same tokens, the other depth the same or a near-tie at each
   first divergence; K4 and K6 launch. (N3) inside
   phase I1's two ranks, `scripts.tp_collective_budget`'s decode step of
   OPT-6.7B at full width, tp 2 over gloo on cuda:0, batch 8: each
   collective by kind, dtype and bytes (2 all-reduces a layer and nothing
   else), the ms of one of each size alone, the step's ms, and the step's
   logits and tokens the same with the recorder open.
14. Checks: finite outputs of the expected shapes; request (a) gives the
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
full-width UNet calls and one under torch.profiler, the tree's W8
matmul at every W8_SHAPES row, L2-warm and L2-cold, and its serving
phases A and B (`phase_a`, `phase_b`). OTHER_ROOT holds
another checkout, e.g. the parent commit unpacked with `git archive` into
a directory that .gitignore lists. It prints one "AB" JSON line per run
(request times, stage means, the UNet calls' host-clock times and device
profile, the W8 times, phase A's tokens/s and device ms a step, phase B's
batch s, failures) and the card's name and power limit.

    python3 chip_smoke.py --ab-kernels OTHER_ROOT [ROUNDS] [ORDER]

times each tree's own valid-prefix decode attention (K6) at every
DECODE_SHAPES row, L2-warm and L2-cold, and repeated-product probe (S1) at
its seven cases, on the same inputs, each run in a fresh process, in
ORDER, ROUNDS times: one "ABK" JSON line per run, after one line per K6
row with its lengths, bound and this tree's plan.
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
from gill_tpu_torch.nn.core import layer_view  # noqa: E402
from gill_tpu_torch.scripts._timing import (  # noqa: E402
    PEAK_FLOPS, bound, cold_copies, cuda_ms, cuda_ms_cycled, device_profile,
    smi_line)

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
DECODE_REPLACES = ("gill_tpu/ops/decode_attn.py:140 prefix_decode_attention "
                   "(_kernel :48, pallas_call :178)")
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
# (B, S): the decode kernel's calls (slots x read window), H 32, D 128;
# B4 S2048 is OPT-6.7B's whole 2,048 positions, where a row's chain is
# longest
DECODE_SHAPES = [(16, 256), (16, 512), (8, 256), (8, 512), (4, 2048)]
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


def decode_ms_cold(torch, pool, s, q, lens, k1, v1, scale) -> float:
    """K6's time with its cache out of the L2, as a decode step finds each
    layer's: the calls cycle through copies of the (2, B, S', H, D) pool,
    >= 2x the L2 in all."""
    from gill_tpu_torch.ops.decode_attn import prefix_decode_attention

    pools = [pool] + [pool.clone() for _ in range(
        cold_copies(pool.numel() * pool.element_size()) - 1)]
    ms = cuda_ms_cycled([lambda p=p: prefix_decode_attention(
        q, p[0, :, :s], p[1, :, :s], lens, k1, v1, scale=scale)
        for p in pools], 24)
    del pools
    return ms


def decode_sdpa(torch, q, k, v, lens, k1, v1, scale):
    """K6's function as one library call: a zero-argument callable running
    `scaled_dot_product_attention` over the cache rows with each row's own
    token appended (one copy, made here, outside the call) and a (B, 1,
    1, S + 1) boolean mask that keeps each row's valid prefix and its own
    token; (B, 1, H, D) out, as `prefix_decode_attention`."""
    import torch.nn.functional as F

    s = k.shape[1]
    kk = torch.cat([k, k1.to(k.dtype)], dim=1).transpose(1, 2)
    vv = torch.cat([v, v1.to(v.dtype)], dim=1).transpose(1, 2)
    pos = torch.arange(s + 1, device=q.device)
    mask = ((pos[None] < lens.long().clamp(0, s)[:, None]) | (pos == s)
            )[:, None, None, :]
    qq = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, scale=scale).transpose(1, 2)


def flat_read_ms(torch, dev, n: int) -> float:
    """`torch.sum` over n contiguous bf16 values (a streaming read)."""
    flat = torch.ones(n, device=dev, dtype=torch.bfloat16)
    return cuda_ms(lambda: flat.sum(dtype=torch.float32), 20)


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
    from gill_tpu_torch.ops.decode_attn import (c_plan, decode_plan,
                                                plan_rows,
                                                prefix_decode_attention,
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
        pool = torch.randn(2, b, max(512, s), h, d, device=dev,
                           generator=g).to(bf)
        k, v = pool[0, :, :s], pool[1, :, :s]
        q, k1, v1 = (torch.randn(b, 1, h, d, device=dev, generator=g).to(bf)
                     for _ in range(3))
        lens = torch.randint(0, s + 1, (b,), device=dev, generator=g,
                             dtype=torch.int32)
        lens[0], lens[-1] = 0, s          # a parked slot and a full window
        # the plan's split boundaries: a row ending where the first split
        # ends, one where the last split starts that holds rows (the plan
        # is the pool's, `plan_rows`)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        s_plan = plan_rows(k, v)
        plan = decode_plan(b, s_plan, h, d, sms)
        lens[1] = min(plan.rows, s)
        lens[2] = (min(plan.splits, -(-s // plan.rows)) - 1) * plan.rows
        scale = d ** -0.5
        out = prefix_decode_attention(q, k, v, lens, k1, v1, scale=scale)
        again = prefix_decode_attention(q, k, v, lens, k1, v1, scale=scale)
        ref = prefix_decode_attention_ref(q, k, v, lens, k1, v1, scale=scale)
        torch.cuda.synchronize()
        twice = bool(torch.equal(out, again))
        plan_agrees = c_plan(b, s_plan, h, d, sms) == tuple(plan)
        # each row against its own tolerance (per_row_err); the parked row
        # (length 0) must be exactly its own v1 (weight exp(0) = 1, sum 1)
        err_b, tol_b = per_row_err(torch, out, ref)
        worst = int((err_b / tol_b.clamp_min(1e-30)).argmax())
        parked_exact = bool(torch.equal(out[0], v1[0]))
        lib = decode_sdpa(torch, q, k, v, lens, k1, v1, scale)
        lib_err = float((lib().float() - ref.float()).abs().max())
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
               "ms_cold": decode_ms_cold(torch, pool, s, q, lens, k1, v1,
                                         scale),
               # a practical floor beside the bound: one library reduction
               # reading as many contiguous bytes as the valid rows hold
               "flat_read_ms": flat_read_ms(torch, dev, n_rows * h * d * 2),
               "plain_ms": cuda_ms(lambda: prefix_decode_attention_ref(
                   q, k, v, lens, k1, v1, scale=scale), 20),
               "bound_ms": bms, "bound_by": by,
               "library_ms": cuda_ms(lib, 20),
               "library_computes": "scaled_dot_product_attention over the "
                                   "rows + own token, (B, 1, 1, S + 1) bool "
                                   "mask",
               "library_err": lib_err,
               "tol_rule": "per row", "worst_row": worst,
               "worst_row_err": float(err_b[worst]),
               "parked_row_exact": parked_exact,
               "bitwise_equal_twice": twice, "plan": plan._asdict(),
               "plan_is_c_sides": plan_agrees}
        record(row, float(err_b.max()), float(tol_b[worst]),
               ok=bool((err_b <= tol_b).all()) and parked_exact and twice
               and plan_agrees,
               note=f" of row {worst}, the nearest its own limit at "
                    f"{float(err_b[worst]):.3e}; rows {lens.tolist()}; "
                    f"parked row exact: {parked_exact}; two calls bitwise "
                    f"equal: {twice}; plan {tuple(plan)} is the C side's: "
                    f"{plan_agrees}")
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

    def w8_plain(x, w8, ws, b=None, *, block_n=None, block_k=None,
                 out=None):
        y = w8_mod.w8_matmul_ref(x, w8, ws, b)
        return y if out is None else out.copy_(y.reshape(out.shape))

    swaps = [(attn_mod, "flash_attention", flash_plain),
             (unet_mod, "geglu_ff", geglu_ff_ref),
             (w8_mod, "w8_matmul", w8_plain),
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
    generation lengths U[16,192] (the serving probes' `_serving`)."""
    from gill_tpu_torch.scripts._serving import serve_trace as trace

    return trace(n, seed)


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
    prof = device_profile(lambda: eng._run_chunk().numpy(),
                          sums=("w8_", "prefix_decode"))
    rep["profile_one_chunk"] = prof
    # the W8 matmul's (K4's) and the decode attention's (K6's) device time
    # a decode step and their shares of the chunk's device-busy time
    rep["w8_us_per_step"] = prof["sum_us"]["w8_"] / eng.chunk
    rep["k6_us_per_step"] = prof["sum_us"]["prefix_decode"] / eng.chunk
    if prof["busy_share"] is not None:
        rep["w8_share_of_device_busy"] = prof["sum_us"]["w8_"] / max(
            prof["busy_us"], 1e-9)
        rep["k6_share_of_device_busy"] = prof["sum_us"]["prefix_decode"] \
            / max(prof["busy_us"], 1e-9)
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
    return rep, eng, out


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


def serving_probes(torch, w8_model, failures):
    """The serving probes' measuring functions on phase A's W8 OPT-6.7B
    (the GILL ones on the W8 GILL around it), repetitions and traces cut:
    one chunk size (32), 16 requests where an original takes 48 (32 new
    tokens each for profile_prefix, at most 64 for profile_serve_sched),
    one GILL chunk, two chat turns in one pass, 8 decode steps for the
    ablations and the trace, and the plain decode path on the trace's
    first 8 requests with budgets capped at 64. The launch counts are set to 0 before the
    probes and read after: K4 and K6 must launch; a row with "failed" or a
    value that is not finite fails the run."""
    from gill_tpu_torch.scripts import (profile_chat_extend, profile_decode,
                                        profile_gill_serve, profile_opt67,
                                        profile_prefix, profile_serve,
                                        profile_serve_prefix_decode,
                                        profile_serve_sched)

    lm8, core, gp = w8_model.params["lm"], w8_model.core, w8_model.params
    cfg = core.opt_cfg
    mixed = serve_trace(48)[:8]
    for r in mixed:
        r.max_new_tokens = min(r.max_new_tokens, 64)
    probes = [
        ("profile_serve", lambda: profile_serve.probe(
            model=cfg, params=lm8, n_chunk=2, n_prefill=1, n_round_trip=5)),
        ("profile_gill_serve", lambda: profile_gill_serve.probe(
            model=cfg, core=core, params=gp, n_chunk=1, n_wave=1)),
        ("profile_serve_sched", lambda: profile_serve_sched.probe(
            model=cfg, params=lm8, chunks=(32,), nreq=16, depths=(2,),
            gen=(16, 65))),
        ("profile_prefix", lambda: profile_prefix.probe(
            model=cfg, params=lm8, nreq=16, new=32)),
        ("profile_chat_extend", lambda: profile_chat_extend.probe(
            model=cfg, core=core, params=gp, turns=2, passes=1)),
        ("profile_decode", lambda: profile_decode.probe(
            model=cfg, params=lm8, gen=8)),
        ("profile_opt67", lambda: profile_opt67.probe(model=cfg,
                                                      params=lm8, gen=8)),
        ("profile_serve_prefix_decode",
         lambda: profile_serve_prefix_decode.probe(
             model=cfg, params=lm8, traces={"mixed": mixed}))]
    rep = {}
    zero_launches()
    for name, run in probes:
        t0 = time.perf_counter()
        log(f"serving probe {name}:")
        out = run()
        rep[f"{name}_s"] = time.perf_counter() - t0
        rep[name] = [{k: v for k, v in r.items() if k != "tokens"}
                     for r in out]
        bad = [r for r in rep[name] if "failed" in r]
        if not out or bad:
            failures.append(f"serving probe {name}: {len(out)} rows, "
                            f"failed: {bad}")
        nums = [v for r in out for v in r.values() if isinstance(v, float)]
        if not all(math.isfinite(v) for v in nums):
            failures.append(f"serving probe {name} printed a value that is "
                            f"not finite")
        torch.cuda.empty_cache()
    rep["launches"] = read_launches()
    for name in ("w8_matmul", "prefix_decode_attention"):
        if rep["launches"][name] <= 0:
            failures.append(f"{name} was not launched in the serving probes")
    rep["device"] = smi_line()
    return rep


def serving(torch, dev, model, prompt_b):
    from gill_tpu_torch.api import GILL

    report, failures = {}, []
    w8_model, report["quantize_s"] = timed(torch, lambda: GILL(
        model.core, model.params, model.tokenizer, device=dev,
        sd_pipe=model.sd_pipe, retrieval_index=model.index,
        decision_params=model.decision_params, lm_weight_precision="w8"))
    lm8, cfg = w8_model.params["lm"], model.core.opt_cfg
    report["A"], eng, out_a = phase_a(torch, lm8, cfg, failures)
    log("serving phase A:", json.dumps(report["A"]))
    # online serving (phase F) on phase A's engine and its tokens
    t0 = time.perf_counter()
    report["F"] = phase_f_lm(torch, eng, out_a, serve_trace(48),
                             report["A"], failures)
    del eng
    torch.cuda.empty_cache()
    t6 = time.perf_counter()
    report["F"]["F6"] = f6_speculative(torch, dev, lm8, cfg, failures)
    report["F"]["F6"]["phase_s"] = time.perf_counter() - t6
    log("online phase F6:", json.dumps(report["F"]["F6"]))
    report["F"]["wall_s"] = time.perf_counter() - t0
    report["B"] = phase_b(torch, w8_model, prompt_b, failures)
    log("serving phase B:", json.dumps(report["B"]))
    report["C"] = phase_c(torch, lm8, cfg, failures)
    log("serving phase C:", json.dumps(report["C"]))
    t0 = time.perf_counter()
    report["P"] = serving_probes(torch, w8_model, failures)
    report["P"]["phase_s"] = time.perf_counter() - t0
    log("serving probes phase P:", json.dumps(report["P"]))
    t0 = time.perf_counter()
    report["F"]["F5"] = f5_gill(torch, dev, model, failures)
    report["F"]["F5"]["phase_s"] = time.perf_counter() - t0
    report["F"]["wall_s"] += report["F"]["F5"]["phase_s"]
    log("online phase F5:", json.dumps(report["F"]["F5"]))
    log(f"online phase F: {report['F']['wall_s']:.1f} s in all")
    return report, failures


# ---------------------------------------------------------------------------
# online serving (slice 11)
# ---------------------------------------------------------------------------

class StreamLog:
    """Consumes submitted handles' token streams, one thread each, and
    records each token's host-clock arrival (the instrumentation of this
    script only)."""

    def __init__(self):
        self.rec = {}
        self.threads = []

    def watch(self, key, h, t_submit: float):
        import threading

        def run():
            times, before_done = [], None
            try:
                for _ in h.stream():
                    times.append(time.perf_counter())
                    if before_done is None:
                        before_done = not h.done.is_set()
            except RuntimeError as e:
                self.rec[key] = {"error": str(e)}
                return
            self.rec[key] = {"submit": t_submit, "times": times,
                             "streamed_before_done": bool(before_done)}

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self.threads.append(t)

    def join(self, timeout: float) -> bool:
        for t in self.threads:
            t.join(timeout)
        return not any(t.is_alive() for t in self.threads)

    def latencies(self):
        """(time to first token s, inter-token gaps s) over the requests."""
        ttft, gaps = [], []
        for r in self.rec.values():
            if r.get("times"):
                ttft.append(r["times"][0] - r["submit"])
                gaps += [b - a for a, b in zip(r["times"], r["times"][1:])]
        return ttft, gaps


def pct(xs, q):
    import numpy as np

    return float(np.percentile(xs, q)) if len(xs) else None


def first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def check_tokens(got: dict, want: dict, phase: str, failures, rep):
    """Every request's tokens bit for bit equal to phase A's for its uid."""
    bad = {u: {"first_diff": first_diff(got[u], want[u]),
               "len": len(got[u]), "want_len": len(want[u])}
           for u in got if got[u] != want[u]}
    rep["tokens_equal_to_phase_a"] = f"{len(got) - len(bad)}/{len(got)}"
    if bad:
        rep["mismatches"] = bad
        failures.append(f"phase {phase}: {len(bad)} requests' tokens differ "
                        f"from phase A's: {bad}")


# F1 / F2 serve the trace's first F_REQS of phase A's 48 requests (the
# script's run time; F2 keeps half of phase A's request rate)
F_REQS = 24


def f1_burst(torch, online, reqs, want, launches_a, failures):
    """F1: the trace's first F_REQS requests from 4 threads at once."""
    import threading

    reqs = reqs[:F_REQS]
    rep, handles, lock, slog = {}, {}, threading.Lock(), StreamLog()

    def submitter(part):
        for r in part:
            t = time.perf_counter()
            h = online.submit(r.prompt, r.max_new_tokens)
            with lock:
                handles[r.uid] = h
            slog.watch(r.uid, h, t)

    zero_launches()
    s0 = dict(online.eng.stats)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(reqs[i::4],))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    got = {u: h.result(timeout=600) for u, h in handles.items()}
    rep["wall_s"] = time.perf_counter() - t0
    slog.join(60)
    rep["launches"] = read_launches()
    rep["stats"] = {k: online.eng.stats[k] - s0.get(k, 0)
                    for k in online.eng.stats}
    n_tok = sum(len(v) for v in got.values())
    rep["tokens_per_s"] = n_tok / rep["wall_s"]
    check_tokens(got, want, "F1", failures, rep)
    rep["streamed_before_done"] = sum(r.get("streamed_before_done", False)
                                      for r in slog.rec.values())
    if rep["streamed_before_done"] < 1:
        failures.append("phase F1: no handle streamed tokens before it "
                        "finished")
    need = ["w8_matmul", "prefix_decode_attention"]
    if launches_a["flash_attention"] > 0:
        need.append("flash_attention")
    for name in need:
        if rep["launches"][name] <= 0:
            failures.append(f"{name} was not launched in phase F1")
    return rep


def f2_arrivals(torch, online, reqs, want, wall_a, failures):
    """F2: the trace's first F_REQS requests with exponential gaps at half
    the request rate phase A sustained; a 2 s torch.profiler window in the
    middle reads the device's busy share."""
    import threading

    import numpy as np

    rep, handles, slog = {}, {}, StreamLog()
    rate = 0.5 * len(reqs) / wall_a
    reqs = reqs[:F_REQS]
    gaps = np.random.RandomState(11).exponential(1 / rate, size=len(reqs))
    arrivals = np.cumsum(gaps)
    rep["requests_per_s"] = rate
    rep["arrival_span_s"] = float(arrivals[-1])

    def submitter(t0):
        for r, at in zip(reqs, arrivals):
            delay = t0 + at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            t = time.perf_counter()
            handles[r.uid] = online.submit(r.prompt, r.max_new_tokens)
            slog.watch(r.uid, handles[r.uid], t)

    zero_launches()
    s0 = dict(online.eng.stats)
    t0 = time.perf_counter()
    sub = threading.Thread(target=submitter, args=(t0,), daemon=True)
    sub.start()
    time.sleep(max(0.0, float(arrivals[-1]) / 2 - 1.0))
    window_s = 2.0
    prof = device_profile(lambda: time.sleep(window_s),
                          sums=("w8_", "prefix_decode"))
    sub.join(600)
    got = {u: handles[u].result(timeout=600) for u in handles}
    rep["wall_s"] = time.perf_counter() - t0
    slog.join(60)
    rep["launches"] = read_launches()
    rep["stats"] = {k: online.eng.stats[k] - s0.get(k, 0)
                    for k in online.eng.stats}
    ttft, gaps_s = slog.latencies()
    rep["ttft_ms"] = {"p50": 1e3 * pct(ttft, 50), "p99": 1e3 * pct(ttft, 99)}
    rep["itl_ms"] = {"p50": 1e3 * pct(gaps_s, 50),
                     "p99": 1e3 * pct(gaps_s, 99)}
    rep["tokens_per_s"] = sum(len(v) for v in got.values()) / rep["wall_s"]
    rep["device"] = smi_line()
    rep["device_busy_share_of_window"] = (prof["busy_us"] / (window_s * 1e6)
                                          if "busy_us" in prof else 0.0)
    rep["profile_window"] = {k: prof.get(k) for k in
                             ("busy_share", "device_events", "sum_us")}
    check_tokens(got, want, "F2", failures, rep)
    for name in ("w8_matmul", "prefix_decode_attention"):
        if rep["launches"][name] <= 0:
            failures.append(f"{name} was not launched in phase F2")
    return rep


def f3_cancel(torch, online, reqs, want, failures):
    """F3: 16 long requests fill the slots; the scheduler parks at the start
    of a chunk (an Event-gated `_run_chunk`) while one queued request and
    one in flight are cancelled; the others must keep phase A's tokens."""
    import threading

    rep = {}
    eng = online.eng
    long = [r for r in reqs if r.max_new_tokens >= 100]
    fill, (queued, extra) = long[:16], long[16:18]
    armed, parked, go = [False], threading.Event(), threading.Event()
    orig = eng._run_chunk

    def gated():
        if armed[0]:
            armed[0] = False
            parked.set()
            go.wait(120)
        return orig()

    eng._run_chunk = gated
    zero_launches()
    s0 = dict(eng.stats)
    try:
        handles = {r.uid: online.submit(r.prompt, r.max_new_tokens)
                   for r in fill}
        for h in handles.values():          # every slot holds a request
            next(h.stream())
        armed[0] = True
        if not parked.wait(120):
            raise RuntimeError("phase F3: the scheduler did not park")
        hq = online.submit(queued.prompt, queued.max_new_tokens)
        hq.cancel()
        victim = max(fill, key=lambda r: r.max_new_tokens)
        handles[victim.uid].cancel()
        handles[extra.uid] = online.submit(extra.prompt, extra.max_new_tokens)
        go.set()
        got = {u: h.result(timeout=600) for u, h in handles.items()}
        rep["queued_cancel_tokens"] = len(hq.result(timeout=600))
    finally:
        go.set()
        del eng._run_chunk
    rep["launches"] = read_launches()
    rep["cancelled"] = eng.stats.get("cancelled", 0) - s0.get("cancelled", 0)
    vt = got.pop(victim.uid)
    rep["in_flight_cancel_tokens"] = len(vt)
    if rep["cancelled"] != 2:
        failures.append(f"phase F3: stats['cancelled'] rose by "
                        f"{rep['cancelled']}, not 2")
    if rep["queued_cancel_tokens"] != 0 or not (
            0 < len(vt) < victim.max_new_tokens
            and vt == want[victim.uid][:len(vt)]):
        failures.append(f"phase F3: the cancels gave {rep}")
    check_tokens(got, want, "F3", failures, rep)
    for name in ("w8_matmul", "prefix_decode_attention"):
        if rep["launches"][name] <= 0:
            failures.append(f"{name} was not launched in phase F3")
    return rep


def f4_http(torch, online, reqs, want, failures):
    """F4: `make_server` over the same online engine: four concurrent
    clients (two streaming), a prefix registration and a prefixed
    generate, and a streaming client that resets after 3 lines."""
    import socket
    import struct
    import threading
    import urllib.request

    from gill_tpu_torch.serve.http import make_server

    rep = {}
    srv = make_server(online, host="127.0.0.1", port=0)
    port = srv.server_address[1]
    base = f"http://127.0.0.1:{port}"
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def post(path, body):
        rq = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(rq, timeout=600) as r:
            if body.get("stream"):
                lines = [json.loads(ln) for ln in r.read().splitlines()
                         if ln]
                if lines[-1] != {"done": True, "n": len(lines) - 1}:
                    raise RuntimeError(f"stream ended with {lines[-1]}")
                return [ln["token"] for ln in lines[:-1]]
            return json.loads(r.read())

    def stats():
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            return json.loads(r.read())["lm"]

    zero_launches()
    try:
        four = reqs[20:24]
        got = {}

        def client(i, r):
            out = post("/v1/generate", {"prompt": r.prompt,
                                        "max_new_tokens": r.max_new_tokens,
                                        "stream": i < 2})
            got[r.uid] = out if i < 2 else out["tokens"]

        threads = [threading.Thread(target=client, args=(i, r))
                   for i, r in enumerate(four)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        r = reqs[24]
        pfx = post("/v1/prefix", {"prompt": r.prompt[:len(r.prompt) // 2]})
        got[r.uid] = post("/v1/generate", {
            "prompt": r.prompt, "max_new_tokens": r.max_new_tokens,
            "prefix_id": pfx["prefix_id"]})["tokens"]
        check_tokens(got, want, "F4", failures, rep)
        rep["prefix_hits"] = stats()["prefix_hits"]

        # a client that resets after 3 NDJSON lines: its request is
        # cancelled at the next chunk boundary
        c0 = stats().get("cancelled", 0)
        r = max(reqs[25:], key=lambda q: q.max_new_tokens)
        body = json.dumps({"prompt": r.prompt, "stream": True,
                           "max_new_tokens": r.max_new_tokens}).encode()
        s = socket.create_connection(("127.0.0.1", port), timeout=120)
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while buf.split(b"\r\n\r\n", 1)[-1].count(b"\n") < 6:
            chunk = s.recv(65536)          # chunk sizes and lines both end
            if not chunk:                  # in "\n": 3 lines = 6
                break
            buf += chunk
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.close()
        deadline = time.perf_counter() + 120
        while stats().get("cancelled", 0) == c0 \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        rep["disconnect_cancels"] = stats().get("cancelled", 0) - c0
        if rep["disconnect_cancels"] != 1:
            failures.append(f"phase F4: a reset client gave "
                            f"{rep['disconnect_cancels']} cancels in /stats")
    finally:
        srv.shutdown()
        srv.server_close()
    rep["launches"] = read_launches()
    for name in ("w8_matmul", "prefix_decode_attention"):
        if rep["launches"][name] <= 0:
            failures.append(f"{name} was not launched in phase F4")
    return rep


def phase_f_lm(torch, eng, want, reqs, rep_a, failures):
    """F1-F4 on phase A's engine under one OnlineEngine."""
    from gill_tpu_torch.serve.online import OnlineEngine

    report = {}
    online = OnlineEngine(eng)
    try:
        for name, fn in (("F1", lambda: f1_burst(
                torch, online, reqs, want, rep_a["launches"], failures)),
                         ("F2", lambda: f2_arrivals(
                             torch, online, reqs, want, rep_a["wall_s"],
                             failures)),
                         ("F3", lambda: f3_cancel(torch, online, reqs, want,
                                                  failures)),
                         ("F4", lambda: f4_http(torch, online, reqs, want,
                                                failures))):
            t0 = time.perf_counter()
            report[name] = fn()
            report[name]["phase_s"] = time.perf_counter() - t0
            log(f"online phase {name}:", json.dumps(report[name]))
    finally:
        online.close()
    if online.crash:
        failures.append(f"phase F: {online.crash}")
    return report


def f5_gill(torch, dev, model, failures):
    """F5: the async GILL API at full width on the main path's model (bf16
    OPT-6.7B + CLIP ViT-L/14, bf16 pool): three concurrent generate_async
    calls (text, image + text, forced [IMG] with one 50-step 512² SD
    generation) held to the batch API's tokens, captions and route, then a
    registered + extended conversation prefix held to the whole
    conversation's tokens."""
    import threading

    import numpy as np
    from PIL import Image

    from gill_tpu_torch.serve.gill_engine import GillDecodeEngine

    rep = {}
    # every request writes at least `mw` word tokens before an [IMG] run may
    # start, so each compared token list is at least that long
    mw = 16
    common = dict(slots=4, chunk=8, max_seq=512)
    gen = dict(common, min_word_tokens=mw)
    img = Image.fromarray(np.random.RandomState(3).randint(
        0, 256, (256, 256, 3), dtype=np.uint8))
    cases = {"text": (["A photo of a red canoe on a quiet lake."],
                      dict(num_words=32)),
             "image": ([img, "Q: What is in this picture?\nA:"],
                       dict(num_words=32)),
             "img_route": (["Show me a picture of a red canoe at sunset.\n"],
                           dict(num_words=32, gen_scale_factor=1e6))}
    images = []
    orig_decode = model.sd_pipe.decode_latents

    def capture_decode(latents):
        out = orig_decode(latents)
        images.append(out)
        return out

    zero_launches()
    handles = {}
    model.sd_pipe.decode_latents = capture_decode
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda k=k, p=p, kw=kw: handles.
                                    __setitem__(k, model.generate_async(
                                        p, **kw, **gen)))
                   for k, (p, kw) in cases.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        outs = {k: model.finalize_async(h) for k, h in handles.items()}
        torch.cuda.synchronize()
        rep["async_s"] = time.perf_counter() - t0
    finally:
        model.sd_pipe.decode_latents = orig_decode
    rep["launches"] = read_launches()
    for name in ("flash_attention", "prefix_decode_attention"):
        if rep["launches"][name] <= 0:
            failures.append(f"{name} was not launched in phase F5")
    if len(images) != 1 or tuple(images[0].shape) != (1, 512, 512, 3) \
            or not bool(torch.isfinite(images[0]).all()):
        failures.append("phase F5 gave no one finite (1, 512, 512, 3) image")

    # the batch API on the same prompts, slots, chunk and max_seq (SD off:
    # the [IMG] run's generation embedding stands in for the image)
    served = []
    orig_run = GillDecodeEngine.run

    def run_capture(self, requests, **kw):
        out = orig_run(self, requests, **kw)
        served.append(out)
        return out

    GillDecodeEngine.run = run_capture
    sd, model.sd_pipe = model.sd_pipe, None
    try:
        batch = dict(zip(("text", "image"),
                         model.generate_for_images_and_texts_batch(
                             [cases["text"][0], cases["image"][0]],
                             num_words=32, **gen)))
        batch["img_route"] = model.generate_for_images_and_texts_batch(
            [cases["img_route"][0]], num_words=32, gen_scale_factor=1e6,
            **gen)[0]
    finally:
        model.sd_pipe = sd
        GillDecodeEngine.run = orig_run
    batch_tokens = {"text": served[0][0]["tokens"],
                    "image": served[0][1]["tokens"],
                    "img_route": served[1][0]["tokens"]}
    rep["token_lengths"] = {k: [len(handles[k].tokens),
                                len(batch_tokens[k])] for k in cases}
    short = {k: n for k, n in rep["token_lengths"].items() if min(n) < mw}
    if short:
        failures.append(f"phase F5: token lists shorter than {mw}: {short}")
    same = {}
    for k in cases:
        o, b = outs[k], batch[k]
        route = [x if isinstance(x, str) else x["decision"][0] for x in o]
        same[k] = {"tokens": handles[k].tokens == batch_tokens[k],
                   "captions_and_route": route == [
                       x if isinstance(x, str) else x["decision"][0]
                       for x in b] and all(len(x["gen"]) == 1 for x in o
                                           if isinstance(x, dict))}
        rep[f"{k}_output"] = [x if isinstance(x, str) else
                              {"decision": x["decision"][0],
                               "gen": len(x["gen"])} for x in o]
    rep["equal_to_batch"] = same
    if not all(v for d in same.values() for v in d.values()):
        failures.append(f"phase F5 differs from the batch API: {same}")
    if not (len(outs["img_route"]) == 2
            and isinstance(outs["img_route"][1], dict)):
        failures.append(f"phase F5 [IMG] request took no [IMG] route: "
                        f"{rep['img_route_output']}")

    # a chat turn: registered history + extension vs the whole conversation
    h1 = [img, "User: What is in this picture?\nAssistant: A field.\n"]
    h2 = ["User: Where could it be?\nAssistant: In the countryside.\n"]
    turn = ["User: Show me the same field at night.\nAssistant:"]
    pid0 = model.register_prefix_async(h1, **common)
    pid1 = model.extend_prefix_async(pid0, h2, **common)
    hp = model.generate_async(turn, num_words=32, prefix_id=pid1, **gen)
    hw = model.generate_async(h1 + h2 + turn, num_words=32, **gen)
    rep["prefix_turn_tokens_equal"] = hp.result(timeout=600) == \
        hw.result(timeout=600)
    rep["prefix_turn_token_lengths"] = [len(hp.tokens), len(hw.tokens)]
    if min(rep["prefix_turn_token_lengths"]) < mw:
        failures.append(f"phase F5: the chat turn's token lists are shorter "
                        f"than {mw}: {rep['prefix_turn_token_lengths']}")
    if not rep["prefix_turn_tokens_equal"]:
        failures.append(f"phase F5: the prefixed chat turn differs from the "
                        f"whole conversation at token "
                        f"{first_diff(hp.tokens, hw.tokens)}")
    for online in model._online_engines.values():
        online.close()
        if online.crash:
            failures.append(f"phase F5: {online.crash}")
    model._online_engines.clear()
    model._serve_engines.clear()
    torch.cuda.empty_cache()
    return rep


def _top2_gap(logits) -> float:
    top = logits.float().topk(2).values
    return float(top[0] - top[1])


def near_tie(decode_logits, spec_logits) -> dict:
    """A split between a one-token step's and a verify window's argmax is a
    near-tie when the two sides' logits differ, somewhere, by at least the
    decode side's top-2 gap."""
    diff = float((decode_logits.float() - spec_logits.float()).abs().max())
    gap = _top2_gap(decode_logits)
    return {"decode_top2_gap": gap, "verify_top2_gap": _top2_gap(spec_logits),
            "max_logit_diff": diff, "near_tie": diff >= gap}


def f6_speculative(torch, dev, lm8, cfg, failures):
    """F6: SpeculativeDecoder on phase A's W8 OPT-6.7B target, k = 8,
    greedy tokens from a 100-token prompt: 64 with (a) the target as its
    own draft, 16 with (b) a random OPT-125m (it accepts nothing, so each
    token is a round); held to the target's own greedy one-token decode
    (the per-row decode path, K6 at every step), every split analysed as
    a near-tie or a fault."""
    import dataclasses

    import numpy as np

    from gill_tpu_torch.config import OPTConfig
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.nn.core import Init
    from gill_tpu_torch.serve.speculative import SpeculativeDecoder

    rep, k, n_new = {}, 8, 64
    vocab = lm8["embed_tokens"]["weight"].shape[0]
    tcfg = dataclasses.replace(cfg, vocab_size=vocab)
    dcfg = OPTConfig.from_name("facebook/opt-125m", vocab_size=vocab)
    drafts = {"a_target": (lm8, tcfg, n_new),
              "b_opt125m": (opt_mod.init(Init(torch.Generator(dev)
                                              .manual_seed(13), dev,
                                              torch.bfloat16), dcfg), dcfg,
                            16)}
    prompt = np.random.RandomState(5).randint(2, 1000, size=100).tolist()
    plen = len(prompt)

    # the target's own greedy decode: one-token steps on the same prefill
    kv = lm8["embed_tokens"]["weight"].dtype
    ref = SpeculativeDecoder(lm8, tcfg, lm8, tcfg, k=k, kv_dtype=kv)
    tcache, _, first = ref._prefill(prompt)
    ref_tokens, ref_logits, step_s = [first], [None], []
    tok = torch.tensor([[first]], device=dev)
    zero_launches()
    for pos in range(plen, plen + n_new - 1):
        t0 = time.perf_counter()
        out = opt_mod.forward(lm8, tcfg, opt_mod.embed_tokens(lm8, tok),
                              cache=tcache, cache_pos=torch.full(
                                  (1,), pos, device=dev, dtype=torch.int32),
                              lm_head=ref._thead)
        lg = out["logits"][0, -1]
        ref_tokens.append(int(lg.argmax()))
        step_s.append(time.perf_counter() - t0)
        ref_logits.append(lg)
        tok = torch.tensor([[ref_tokens[-1]]], device=dev)
    rep["plain_step_ms"] = 1e3 * float(np.median(step_s))
    total = {n: c for n, c in read_launches().items()
             if n in ("w8_matmul", "prefix_decode_attention")}
    rep["plain_launches_per_step"] = {n: c / (n_new - 1)
                                      for n, c in total.items()}
    del tcache

    orig_forward = opt_mod.forward
    for name, (dparams, dc, n_tok) in drafts.items():
        calls, round_s = [], []

        def spy(params, cfg_, embs, **kw):
            out = orig_forward(params, cfg_, embs, **kw)
            if params is lm8 and "logits" in out:
                calls.append((kw.get("cache_pos"), embs.shape[1],
                              out["logits"][0]))
            return out

        dec = SpeculativeDecoder(lm8, tcfg, dparams, dc, k=k, kv_dtype=kv)
        orig_round = dec._round

        def timed_round(*a):
            t0 = time.perf_counter()
            out = orig_round(*a)           # ends in the accepted count's sync
            round_s.append(time.perf_counter() - t0)
            return out

        dec._round = timed_round
        opt_mod.forward = spy
        zero_launches()
        try:
            toks = dec.generate(prompt, n_tok)
        finally:
            opt_mod.forward = orig_forward
        launches = read_launches()
        st = dec.last_stats
        r = {"stats": st, "acceptance": st["accepted"] / max(
                 1, st["rounds"] * (k - 1)),
             "round_ms": 1e3 * float(np.median(round_s)),
             "launches_per_round": {
                 n: c / st["rounds"] for n, c in launches.items()
                 if n in ("w8_matmul", "prefix_decode_attention")},
             "tokens": len(toks),
             "tokens_equal_to_target_greedy": toks == ref_tokens[:n_tok]}
        if len(toks) != n_tok:
            failures.append(f"phase F6 ({name}): {len(toks)} tokens, not "
                            f"{n_tok}")
        verify = [(p, lg) for p, t, lg in calls if t == k + 1]
        if toks != ref_tokens[:n_tok]:
            p = first_diff(toks, ref_tokens)
            pos, lg = [(q, x) for q, x in verify if q <= plen + p - 1][-1]
            r["first_mismatch"] = {"position": p, **near_tie(
                ref_logits[p], lg[plen + p - 1 - pos])}
            if not r["first_mismatch"]["near_tie"]:
                failures.append(f"phase F6 ({name}): token {p} differs from "
                                f"the target's greedy decode beyond a "
                                f"near-tie: {r['first_mismatch']}")
        if name == "a_target":
            # each rejection of the target by itself: the draft's one-token
            # step against the verify row that refused it
            # (the k one-token steps before each verify are its drafts)
            pending, rejections = [], []
            for pos, t, lg in calls:
                if t == 1:
                    pending.append(lg[0])
                    continue
                steps, pending = pending[-k:], []
                drafted = [int(x.argmax()) for x in steps]
                agree = lg.argmax(-1).tolist()
                n = next((j for j in range(k - 1)
                          if drafted[j] != agree[j]), k - 1)
                if n < k - 1:
                    rejections.append({"position": pos + n + 1 - plen,
                                       **near_tie(steps[n], lg[n])})
            r["rejections"] = rejections
            faults = [x for x in rejections if not x["near_tie"]]
            if faults:
                failures.append(f"phase F6: the target refused itself "
                                f"beyond a near-tie: {faults}")
        rep[name] = r
        for kname in total:
            total[kname] += launches[kname]
        del calls, dec
    rep["launches"] = total
    for kname, n in total.items():
        if n <= 0:
            failures.append(f"{kname} was not launched in phase F6")
    rep["device"] = smi_line()
    del drafts
    torch.cuda.empty_cache()
    return rep


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
# weight directories (slice 12): a safetensors writer and the inverse maps
# from this package's trees to HF / diffusers / reference key names
# ---------------------------------------------------------------------------

_ST_NAMES = {"float64": "F64", "float32": "F32", "float16": "F16",
             "bfloat16": "BF16", "int64": "I64", "int32": "I32",
             "int16": "I16", "int8": "I8", "uint8": "U8", "bool": "BOOL"}


def write_safetensors(path: str, tensors: dict) -> None:
    """Pure-Python safetensors writer (the card's machine has no
    `safetensors` package): an 8-byte little-endian header length, the
    JSON header (dtype, shape, data_offsets per tensor) padded with spaces
    to 8 bytes, then each tensor's bytes in order, one tensor at a time on
    the host."""
    import struct

    import torch

    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[str(t.dtype).split(".")[-1]],
                        "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(
                    torch.uint8).numpy().data)


def _put_lin(sd, prefix, p):
    """(in, out) Linear -> torch's (out, in) weight and bias."""
    sd[prefix + ".weight"] = p["w"].t().contiguous()
    if "b" in p:
        sd[prefix + ".bias"] = p["b"]


def _put_norm(sd, prefix, p):
    sd[prefix + ".weight"] = p["scale"]
    sd[prefix + ".bias"] = p["bias"]


def _put_conv(sd, prefix, p):
    """OIHW (channels_last memory) -> contiguous OIHW."""
    sd[prefix + ".weight"] = p["w"].contiguous()
    if "b" in p:
        sd[prefix + ".bias"] = p["b"]


def opt_to_hf(lm, num_layers: int, vocab_size: int) -> dict:
    """The first `num_layers` layers of an OPT tree as an HF
    OPTForCausalLM state dict (the table's first vocab_size rows; the
    head tied to it). Every tensor is a copy, so torch.save writes no
    storage beyond it."""
    sd = {"model.decoder.embed_tokens.weight":
          lm["embed_tokens"]["weight"][:vocab_size],
          "model.decoder.embed_positions.weight":
          lm["embed_positions"]["weight"]}
    for i in range(num_layers):
        lp, p = layer_view(lm["layers"], i), f"model.decoder.layers.{i}"
        for a, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("o", "out_proj")):
            _put_lin(sd, f"{p}.self_attn.{n}", lp["attn"][a])
        _put_norm(sd, f"{p}.self_attn_layer_norm", lp["attn_ln"])
        _put_lin(sd, f"{p}.fc1", lp["fc1"])
        _put_lin(sd, f"{p}.fc2", lp["fc2"])
        _put_norm(sd, f"{p}.final_layer_norm", lp["mlp_ln"])
    if "final_ln" in lm:
        _put_norm(sd, "model.decoder.final_layer_norm", lm["final_ln"])
    for name in ("project_in", "project_out"):
        if name in lm:
            _put_lin(sd, f"model.decoder.{name}", lm[name])
    sd = {k: v.clone() for k, v in sd.items()}
    sd["lm_head.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd


def _clip_layers_to_hf(sd, prefix, layers):
    for i in range(layers["ln1"]["scale"].shape[0]):
        lp, p = layer_view(layers, i), f"{prefix}encoder.layers.{i}"
        _put_norm(sd, f"{p}.layer_norm1", lp["ln1"])
        for a, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("o", "out_proj")):
            _put_lin(sd, f"{p}.self_attn.{n}", lp["attn"][a])
        _put_norm(sd, f"{p}.layer_norm2", lp["ln2"])
        _put_lin(sd, f"{p}.mlp.fc1", lp["fc1"])
        _put_lin(sd, f"{p}.mlp.fc2", lp["fc2"])


def clip_vision_to_hf(vision) -> dict:
    """A CLIP vision tree as an HF CLIPVisionModel / CLIPModel state dict
    (`visual_projection.weight` when the tree holds one)."""
    p = "vision_model."
    sd = {p + "embeddings.class_embedding": vision["class_embedding"],
          p + "embeddings.patch_embedding.weight":
          vision["patch_embedding"]["w"].contiguous(),
          p + "embeddings.position_embedding.weight":
          vision["position_embedding"]["weight"]}
    _put_norm(sd, p + "pre_layrnorm", vision["pre_ln"])
    _clip_layers_to_hf(sd, p, vision["layers"])
    _put_norm(sd, p + "post_layernorm", vision["post_ln"])
    if "visual_projection" in vision:
        _put_lin(sd, "visual_projection", vision["visual_projection"])
    return sd


def clip_text_to_hf(text) -> dict:
    sd = {"text_model.embeddings.token_embedding.weight":
          text["token_embedding"]["weight"],
          "text_model.embeddings.position_embedding.weight":
          text["position_embedding"]["weight"]}
    _clip_layers_to_hf(sd, "text_model.", text["layers"])
    _put_norm(sd, "text_model.final_layer_norm", text["final_ln"])
    return sd


def safety_to_diffusers(params) -> dict:
    """A safety-checker tree as diffusers' StableDiffusionSafetyChecker
    state dict (the tower nested under vision_model.vision_model.)."""
    vision = {k: v for k, v in params["vision"].items()
              if k != "visual_projection"}
    sd = {"vision_model." + k: v for k, v in clip_vision_to_hf(vision).items()}
    _put_lin(sd, "visual_projection", params["vision"]["visual_projection"])
    for k in ("concept_embeds", "special_care_embeds",
              "concept_embeds_weights", "special_care_embeds_weights"):
        sd[k] = params[k]
    return sd


def _resnet_to_hf(sd, p, r):
    _put_norm(sd, f"{p}.norm1", r["norm1"])
    _put_conv(sd, f"{p}.conv1", r["conv1"])
    _put_norm(sd, f"{p}.norm2", r["norm2"])
    _put_conv(sd, f"{p}.conv2", r["conv2"])
    if "time_emb" in r:
        _put_lin(sd, f"{p}.time_emb_proj", r["time_emb"])
    if "shortcut" in r:
        _put_conv(sd, f"{p}.conv_shortcut", r["shortcut"])


def _tfm_to_hf(sd, p, a):
    tb, blk = f"{p}.transformer_blocks.0", a["block"]
    _put_norm(sd, f"{p}.norm", a["norm"])
    _put_conv(sd, f"{p}.proj_in", a["proj_in"])
    for i in (1, 2, 3):
        _put_norm(sd, f"{tb}.norm{i}", blk[f"ln{i}"])
    for i in (1, 2):
        for k, n in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                     ("o", "to_out.0")):
            _put_lin(sd, f"{tb}.attn{i}.{n}", blk[f"attn{i}"][k])
    _put_lin(sd, f"{tb}.ff.net.0.proj", blk["geglu"])
    _put_lin(sd, f"{tb}.ff.net.2", blk["ff_out"])
    _put_conv(sd, f"{p}.proj_out", a["proj_out"])


def unet_to_diffusers(unet) -> dict:
    """A UNet tree as a diffusers UNet2DConditionModel state dict."""
    sd = {}
    _put_conv(sd, "conv_in", unet["conv_in"])
    _put_lin(sd, "time_embedding.linear_1", unet["time_fc1"])
    _put_lin(sd, "time_embedding.linear_2", unet["time_fc2"])
    for kind, blocks in (("down", unet["down"]), ("up", unet["up"])):
        for i, blk in enumerate(blocks):
            p = f"{kind}_blocks.{i}"
            for j, r in enumerate(blk["resnets"]):
                _resnet_to_hf(sd, f"{p}.resnets.{j}", r)
            for j, a in enumerate(blk["attns"]):
                _tfm_to_hf(sd, f"{p}.attentions.{j}", a)
            for key, name in (("downsample", "downsamplers"),
                              ("upsample", "upsamplers")):
                if key in blk:
                    _put_conv(sd, f"{p}.{name}.0.conv", blk[key])
    _resnet_to_hf(sd, "mid_block.resnets.0", unet["mid"]["res1"])
    _tfm_to_hf(sd, "mid_block.attentions.0", unet["mid"]["attn"])
    _resnet_to_hf(sd, "mid_block.resnets.1", unet["mid"]["res2"])
    _put_norm(sd, "conv_norm_out", unet["norm_out"])
    _put_conv(sd, "conv_out", unet["conv_out"])
    return sd


def _vae_mid_to_hf(sd, p, mid):
    _resnet_to_hf(sd, f"{p}.mid_block.resnets.0", mid["res1"])
    a, q = mid["attn"], f"{p}.mid_block.attentions.0"
    _put_norm(sd, f"{q}.group_norm", a["norm"])
    for k, n in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                 ("o", "to_out.0")):
        _put_lin(sd, f"{q}.{n}", a[k])
    _resnet_to_hf(sd, f"{p}.mid_block.resnets.1", mid["res2"])


def vae_to_diffusers(decoder, encoder=None) -> dict:
    """VAE decoder (and encoder) trees as a diffusers AutoencoderKL state
    dict, in the new key style (to_q / group_norm / to_out.0)."""
    sd = {}
    _put_conv(sd, "post_quant_conv", decoder["post_quant_conv"])
    _put_conv(sd, "decoder.conv_in", decoder["conv_in"])
    _vae_mid_to_hf(sd, "decoder", decoder["mid"])
    for i, blk in enumerate(decoder["up"]):
        for j, r in enumerate(blk["resnets"]):
            _resnet_to_hf(sd, f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "upsample" in blk:
            _put_conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                      blk["upsample"])
    _put_norm(sd, "decoder.conv_norm_out", decoder["norm_out"])
    _put_conv(sd, "decoder.conv_out", decoder["conv_out"])
    if encoder is not None:
        _put_conv(sd, "encoder.conv_in", encoder["conv_in"])
        for i, blk in enumerate(encoder["down"]):
            for j, r in enumerate(blk["resnets"]):
                _resnet_to_hf(sd, f"encoder.down_blocks.{i}.resnets.{j}", r)
            if "downsample" in blk:
                _put_conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                          blk["downsample"])
        _vae_mid_to_hf(sd, "encoder", encoder["mid"])
        _put_norm(sd, "encoder.conv_norm_out", encoder["norm_out"])
        _put_conv(sd, "encoder.conv_out", encoder["conv_out"])
        _put_conv(sd, "quant_conv", encoder["quant_conv"])
    return sd


def _mha_to_hf(sd, p, a):
    """q/k/v/o -> torch.nn.MultiheadAttention's packed in_proj."""
    import torch

    sd[f"{p}.in_proj_weight"] = torch.cat([a[k]["w"].t() for k in "qkv"])
    sd[f"{p}.in_proj_bias"] = torch.cat([a[k]["b"] for k in "qkv"])
    _put_lin(sd, f"{p}.out_proj", a["o"])


def mapper_to_hf(sd, prefix: str, m) -> None:
    """A mapper tree as the reference TextFcLayer's keys under `prefix`."""
    if "fc" not in m:                                   # linear mode
        _put_lin(sd, prefix + "model", m["model"])
        return
    _put_lin(sd, prefix + "fc", m["fc"])
    for side in ("encoder", "decoder"):
        t = m["tfm"][side]
        for i in range(t["layers"]["ln1"]["scale"].shape[0]):
            lp, p = layer_view(t["layers"], i), f"{prefix}tfm.{side}.layers.{i}"
            _mha_to_hf(sd, f"{p}.self_attn", lp["self_attn"])
            if side == "decoder":
                _mha_to_hf(sd, f"{p}.multihead_attn", lp["cross_attn"])
            for n in (1, 2, 3) if side == "decoder" else (1, 2):
                _put_norm(sd, f"{p}.norm{n}", lp[f"ln{n}"])
            _put_lin(sd, f"{p}.linear1", lp["fc1"])
            _put_lin(sd, f"{p}.linear2", lp["fc2"])
        _put_norm(sd, f"{prefix}tfm.{side}.norm", t["norm"])
    _put_lin(sd, prefix + "model", m["model"])
    sd[prefix + "query_embs"] = m["query_embs"]


def adapters_to_reference(adapters, core, table) -> dict:
    """Adapters as the reference's pretrained_ckpt.pth.tar state_dict
    (DDP `module.` prefixes; `table` is the LM's input embedding table,
    whose last num_tokens rows the loader takes as the [IMG] rows)."""
    sd = {"model.input_embeddings.weight": table,
          "model.logit_scale": adapters["logit_scale"]}
    _put_lin(sd, "model.visual_embeddings", adapters["visual_embeddings"])
    _put_lin(sd, "model.visual_fc", adapters["visual_fc"])
    for i, (suffix, _, _) in enumerate(core.tap_specs()):
        mapper_to_hf(sd, f"model.ret_text_hidden_fcs.{i}.",
                     adapters[f"ret_fc{suffix}"])
        mapper_to_hf(sd, f"model.gen_text_hidden_fcs.{i}.",
                     adapters[f"gen_fc{suffix}"])
    return {"module." + k: v.detach().cpu().clone() for k, v in sd.items()}


def tree_mismatches(torch, got, want, path: str = "") -> list:
    """The paths where two trees differ in structure, shape, dtype or any
    bit of a leaf."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [f"{path}: keys {sorted(got) if isinstance(got, dict) else type(got)} "
                    f"vs {sorted(want)}"]
        return [m for k in want
                for m in tree_mismatches(torch, got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [f"{path}: length"]
        return [m for i, (a, b) in enumerate(zip(got, want))
                for m in tree_mismatches(torch, a, b, f"{path}/{i}")]
    if (got.shape != want.shape or got.dtype != want.dtype
            or not torch.equal(got.reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8))):
        return [f"{path}: {tuple(got.shape)} {got.dtype} vs "
                f"{tuple(want.shape)} {want.dtype}"]
    return []


class RssPeak:
    """The process's peak resident set (VmRSS, GiB) inside a `with` block,
    sampled every 20 ms by a thread, beside its value on entry."""

    def __enter__(self):
        import threading

        self.base = self.peak = self.read()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def read() -> float:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20
        return 0.0

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self.read())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.read())


def write_weights_dir(torch, root: str, *, vision, unet, vae_decoder,
                      vae_encoder, text_encoder, checker, lm, opt_layers: int,
                      opt_vocab: int, opt_name: str, core, adapters) -> dict:
    """A weights directory in the HF / diffusers layouts `load_gill(
    weights_dir=)` reads, and a model directory with model_args.json and a
    reference-format pretrained_ckpt.pth.tar, all written from trees in
    memory. Returns {"weights": ..., "model": ...} paths."""
    from gill_tpu_torch.tokenizer import CLIPBPETokenizer

    wdir, mdir = os.path.join(root, "weights"), os.path.join(root, "model")
    sd_dir = os.path.join(wdir, "stable-diffusion-v1-5")
    clip_dir = os.path.join(wdir, core.cfg.visual_encoder.split("/")[-1])
    for d in (mdir, clip_dir, os.path.join(wdir, opt_name),
              *(os.path.join(sd_dir, s) for s in (
                  "unet", "vae", "text_encoder", "tokenizer",
                  "safety_checker"))):
        os.makedirs(d, exist_ok=True)
    write_safetensors(os.path.join(clip_dir, "model.safetensors"),
                      clip_vision_to_hf(vision))
    write_safetensors(os.path.join(sd_dir, "unet",
                                   "diffusion_pytorch_model.safetensors"),
                      unet_to_diffusers(unet))
    write_safetensors(os.path.join(sd_dir, "vae",
                                   "diffusion_pytorch_model.safetensors"),
                      vae_to_diffusers(vae_decoder, vae_encoder))
    write_safetensors(os.path.join(sd_dir, "text_encoder",
                                   "model.safetensors"),
                      clip_text_to_hf(text_encoder))
    write_safetensors(os.path.join(sd_dir, "safety_checker",
                                   "model.safetensors"),
                      safety_to_diffusers(checker))
    tok = CLIPBPETokenizer.tiny()
    with open(os.path.join(sd_dir, "tokenizer", "vocab.json"), "w") as f:
        json.dump(tok.encoder, f)
    with open(os.path.join(sd_dir, "tokenizer", "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    torch.save(opt_to_hf(lm, opt_layers, opt_vocab),
               os.path.join(wdir, opt_name, "pytorch_model.bin"))
    nt = core.cfg.num_tokens
    table = torch.cat([lm["embed_tokens"]["weight"][:-nt].float(),
                       adapters["img_embeddings"].float()])
    torch.save({"state_dict": adapters_to_reference(adapters, core, table)},
               os.path.join(mdir, "pretrained_ckpt.pth.tar"))
    core.cfg.to_json(os.path.join(mdir, "model_args.json"))
    return {"weights": wdir, "model": mdir}


def _dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs)


def phase_g(torch, dev, model):
    """Slice 12 (docstring item 9): a weights directory written from the
    main path's trees (G1), `load_gill(weights_dir=)` held to them bit for
    bit (G2), a text prompt through the SD text path with the safety
    checker (G3), VAE encode (G4), the checker's scores (G5) and the
    log-likelihood scorer (G6). Launch counts are set to 0 after the load
    and read after G6."""
    import dataclasses

    import numpy as np
    from PIL import Image

    from gill_tpu_torch.api import load_gill
    from gill_tpu_torch.models import safety as safety_mod
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.models.sd import vae as vae_mod
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.nn.core import Init, tree_map
    from gill_tpu_torch.weights import loader as wloader

    rep, failures = {}, []
    t_phase = time.perf_counter()
    core, pipe = model.core, model.sd_pipe
    lm, adapters = model.params["lm"], model.params["adapters"]
    bf16, size = torch.bfloat16, pipe.cfg.default_size
    # the trees the main path lacks: CLIP's visual projection, a VAE
    # encoder and a safety checker, random from their own generator
    init = Init(torch.Generator(dev).manual_seed(41), dev, bf16)
    checker_cfg = safety_mod.SafetyCheckerConfig()
    vision = dict(model.params["vision"])
    vision["visual_projection"] = {"w": init.normal(
        (core.vis_cfg.hidden_size, checker_cfg.projection_dim), 0.02)}
    vae_enc = vae_mod.init_encoder(init, pipe.cfg.vae)
    checker = safety_mod.init(init, checker_cfg)
    n_opt, vocab = min(4, core.opt_cfg.num_layers), core.opt_cfg.vocab_size
    opt_name = f"opt-6.7b-{n_opt}-layers"
    log(f"phase G: OPT is written at OPT-6.7B's widths with {n_opt} of its "
        f"{core.opt_cfg.num_layers} layers (the cut keeps a ~13 GB write out "
        f"of the run) and read with weights.loader.load_opt; load_gill "
        f"finds no OPT directory and keeps its random full-depth OPT")

    with tempfile.TemporaryDirectory(prefix="gill_weights_") as root:
        # G1: write
        with RssPeak() as rss:
            t0 = time.perf_counter()
            dirs = write_weights_dir(
                torch, root, vision=vision, unet=pipe.params["unet"],
                vae_decoder=pipe.params["vae_decoder"], vae_encoder=vae_enc,
                text_encoder=pipe.params["text_encoder"], checker=checker,
                lm=lm, opt_layers=n_opt, opt_vocab=vocab, opt_name=opt_name,
                core=core, adapters=adapters)
            rep["g1_write_s"] = time.perf_counter() - t0
        rep["g1_written_gib"] = _dir_bytes(root) / 2**30
        rep["g1_rss_gib_before_peak"] = [rss.base, rss.peak]

        # G2: load, and hold every loaded leaf to the tree it was written from
        with RssPeak() as rss:
            t0 = time.perf_counter()
            loaded = load_gill(dirs["model"], device=dev,
                               weights_dir=dirs["weights"],
                               load_ret_embs=False, decision_model_fn=None,
                               dtype=bf16, seed=0)
            opt4 = wloader.load_opt(
                opt_name, dataclasses.replace(core.opt_cfg,
                                              num_layers=n_opt),
                core.vocab_len, dirs["weights"], device=dev, dtype=bf16)
            torch.cuda.synchronize()
            rep["g2_load_s"] = time.perf_counter() - t0
        rep["g2_rss_gib_before_peak"] = [rss.base, rss.peak]
    lpipe = loaded.sd_pipe
    want_opt = {"embed_tokens": {"weight": lm["embed_tokens"]["weight"][:vocab]},
                "embed_positions": lm["embed_positions"],
                "layers": tree_map(lambda x: x[:n_opt], lm["layers"]),
                "final_ln": lm["final_ln"]}
    got_opt = dict(opt4, embed_tokens={
        "weight": opt4["embed_tokens"]["weight"][:vocab]})
    pairs = {
        "clip_vision": (loaded.params["vision"], vision),
        "adapters": (loaded.params["adapters"], adapters),
        "unet": (lpipe.params["unet"], pipe.params["unet"]),
        "vae_decoder": (lpipe.params["vae_decoder"],
                        pipe.params["vae_decoder"]),
        "vae_encoder": (lpipe.params.get("vae_encoder"), vae_enc),
        "text_encoder": (lpipe.params["text_encoder"],
                         pipe.params["text_encoder"]),
        "safety_checker": (getattr(lpipe.safety_checker, "params", None),
                           checker),
        "opt_4_layers": (got_opt, want_opt)}
    rep["g2_mismatched_leaves"] = {}
    for name, (got, want) in pairs.items():
        bad = (["missing"] if got is None else
               tree_mismatches(torch, got, want))
        rep["g2_mismatched_leaves"][name] = len(bad)
        if bad:
            failures.append(f"G2 loaded {name} differs from the written "
                            f"tree: {bad[:4]}")
    if opt4["embed_tokens"]["weight"].shape[0] != max(vocab, core.vocab_len):
        failures.append("G2 load_opt did not grow the table to the vocab")
    if lpipe.tokenizer is None or lpipe.safety_checker is None:
        failures.append("G2 load_gill loaded no SD tokenizer or no safety "
                        "checker")
    del loaded, opt4, got_opt, want_opt, pairs
    torch.cuda.empty_cache()
    log(f"phase G load: {json.dumps(rep)}")
    if failures:
        return rep, failures

    # G3: generate from text, 50 PNDM steps at CFG 7.5, the checker on
    prompt = ["a red canoe near the shore of a lake at sunset"]
    mem_pipe = StableDiffusionPipeline(
        pipe.cfg, dict(pipe.params, vae_encoder=vae_enc),
        tokenizer=lpipe.tokenizer,
        safety_checker=safety_mod.SafetyChecker(checker_cfg, checker))
    seen = []

    def capture(latents):
        seen.append(latents)
        return type(lpipe).decode_latents(lpipe, latents)

    def generate(p):
        return p(prompt=prompt, num_inference_steps=50, guidance_scale=7.5,
                 generator=torch.Generator(dev).manual_seed(5))

    zero_launches()
    lpipe.decode_latents = capture
    img, rep["g3_gen512_prompt_50step_s"] = timed(torch,
                                                 lambda: generate(lpipe))
    del lpipe.decode_latents
    img_mem = generate(mem_pipe)
    rep["g3_bitwise_equal_in_memory"] = bool(torch.equal(img, img_mem))
    rep["g3_rel_err_vs_in_memory"] = rel_err(torch, img, img_mem)
    if not _finite_image(torch, img, size):
        failures.append("G3 gave no finite image")
    if not (rep["g3_bitwise_equal_in_memory"]
            or rep["g3_rel_err_vs_in_memory"] <= 3e-2):
        failures.append(f"G3 image differs from the in-memory trees': "
                        f"{rep['g3_rel_err_vs_in_memory']}")
    uncond, empty = lpipe._uncond_embeds(1), lpipe.encode_text([""])
    rep["g3_uncond_equal_encoded_empty"] = bool(torch.equal(uncond, empty))
    rep["g3_uncond_max_abs_vs_zeros"] = float(uncond.float().abs().max())
    if not rep["g3_uncond_equal_encoded_empty"]:
        failures.append("G3 unconditional embeddings are not encode_text('')")
    ctx = torch.cat([uncond, lpipe.encode_text(prompt)]).to(bf16)
    g = torch.Generator(dev).manual_seed(43)
    hl = size // pipe.cfg.vae_scale
    lat = torch.randn(2, hl, hl, 4, device=dev, generator=g).to(bf16)
    t = torch.tensor(981.0, device=dev)

    def both(fn):
        a = fn()
        with plain_kernels():
            b = fn()
        torch.cuda.synchronize()
        return a, b

    # the 77-token causal text tower takes K2 (head dim 64) on the card
    before = read_launches()["flash_mma"]
    a, b = both(lambda: lpipe.encode_text(prompt))
    rep["g3_encode_text_k2_launches"] = read_launches()["flash_mma"] - before
    rep["g3_encode_text_rel_err_vs_plain"] = rel_err(torch, a, b)
    if rep["g3_encode_text_k2_launches"] <= 0:
        failures.append("G3's text encoder did not launch K2")
    a, b = both(lambda: unet_mod.apply(lpipe.params["unet"], pipe.cfg.unet,
                                       lat, t, ctx))
    rep["g3_unet_rel_err_vs_plain"] = rel_err(torch, a, b)
    a, b = both(lambda: lpipe.decode_latents(seen[0]))
    rep["g3_vae_decode_rel_err_vs_plain"] = rel_err(torch, a, b)

    # G4: VAE encode of G3's image (the posterior's mean)
    x = (img * 2 - 1).to(bf16)
    enc_p = lpipe.params["vae_encoder"]
    a, b = both(lambda: vae_mod.encode(enc_p, pipe.cfg.vae, x))
    rep["g4_encode_rel_err_vs_plain"] = rel_err(torch, a, b)
    rt = vae_mod.decode(lpipe.params["vae_decoder"], pipe.cfg.vae, a)
    if tuple(a.shape) != (1, hl, hl, 4) \
            or not bool(torch.isfinite(rt).all()) \
            or tuple(rt.shape) != (1, size, size, 3):
        failures.append("G4 encode / decode(encode) gave no finite result "
                        "of the expected shape")
    for key in ("g3_encode_text_rel_err_vs_plain", "g3_unet_rel_err_vs_plain",
                "g3_vae_decode_rel_err_vs_plain",
                "g4_encode_rel_err_vs_plain"):
        if not rep[key] <= 3e-2:
            failures.append(f"{key} {rep[key]} > 3e-2")

    # G5: the checker's scores on G3's image and three random ones
    chk = lpipe.safety_checker
    imgs = torch.cat([img, torch.rand(3, size, size, 3, device=dev,
                                      generator=g)])
    (sa, ca), (sb, cb) = both(lambda: safety_mod.scores(chk.params, chk.cfg,
                                                        imgs))
    tol = 1e-4
    rep["g5_score_max_abs_err_vs_plain"] = max(
        float((sa - sb).abs().max()), float((ca - cb).abs().max()))
    _, fa = safety_mod.check_images(chk.params, chk.cfg, imgs)
    with plain_kernels():
        _, fb = safety_mod.check_images(chk.params, chk.cfg, imgs)
    # round3(s) > 0 flips at s = 5e-4: compare flags only away from it
    adj = torch.where(((sb * 1000).round() / 1000 > 0).any(1), 0.01, 0.0)
    margin = torch.cat([(sb - 5e-4).abs(),
                        (cb + adj[:, None] - 5e-4).abs()], 1).amin(1)
    clear = margin > tol
    rep["g5_flags"] = fa.tolist()
    rep["g5_flags_compared"] = int(clear.sum())
    if not rep["g5_score_max_abs_err_vs_plain"] <= tol:
        failures.append(f"G5 scores differ from the plain run by "
                        f"{rep['g5_score_max_abs_err_vs_plain']} > {tol}")
    if not bool((fa == fb)[clear].all()):
        failures.append("G5 flags differ from the plain run")
    hot = dict(chk.params, concept_embeds_weights=chk.params[
        "concept_embeds_weights"] - 10)
    out, flags = safety_mod.check_images(hot, chk.cfg, imgs)
    if not (bool(flags.all()) and bool((out == 0).all())):
        failures.append("G5 thresholds of -10 did not black out every image")

    # G6: the log-likelihood scorer on the main-path model
    pil = Image.fromarray((img[0].float().cpu().numpy() * 255).round()
                          .astype(np.uint8))
    prompts = [pil, "A red canoe near the shore of a lake at sunset, with "
                    "pine trees and a small wooden dock."]
    before = read_launches()["flash_attention"]
    a, b = both(lambda: model.get_log_likelihood_scores(prompts))
    rep["g6_k1_launches"] = read_launches()["flash_attention"] - before
    if rep["g6_k1_launches"] <= 0:
        failures.append("G6's causal prefill did not launch K1")
    rep["g6_log_likelihood"] = a
    rep["g6_rel_err_vs_plain"] = abs(a - b) / max(abs(b), 1e-30)
    if not (math.isfinite(a) and rep["g6_rel_err_vs_plain"] <= 1e-4):
        failures.append(f"G6 score {a} against the plain run's {b}")
    rep["launches"] = launches = read_launches()
    for name in ("flash_attention", "flash_mma", "geglu_ff"):
        if launches[name] <= 0:
            failures.append(f"{name} was not launched in phase G")
    rep["phase_s"] = time.perf_counter() - t_phase
    return rep, failures


# ---------------------------------------------------------------------------
# probe scripts (slice 4)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase J: the evals, the demo, the examples and the data / decision scripts
# ---------------------------------------------------------------------------

J_STEPS = 50            # the protocol's PNDM steps at 512², CFG 7.5


def _j_png_dir(d: str, names, size: int, seed: int) -> list:
    """Seeded random RGB PNGs `<name>.png` in d; returns their paths."""
    import numpy as np
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for name in names:
        path = os.path.join(d, f"{name}.png")
        Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8)
                        ).save(path)
        paths.append(path)
    return paths


def _j_pngs_ok(paths, size: int) -> bool:
    """Each file a (size, size) RGB image that is not one flat colour."""
    import numpy as np
    from PIL import Image

    for p in paths:
        a = np.asarray(Image.open(p))
        if a.shape != (size, size, 3) or a.std() == 0:
            return False
    return True


class _FiniteImages:
    """Counts the SD outputs a GILL converts to images, and the non-finite
    ones among them (GILL._to_pil rounds NaN away)."""

    def __init__(self, torch, model):
        self.torch, self.model, self.n, self.bad = torch, model, 0, 0

    def __enter__(self):
        orig = type(self.model)._to_pil

        def check(arr):
            self.n += arr.shape[0]
            self.bad += int((~self.torch.isfinite(arr)).any(
                dim=(1, 2, 3)).sum())
            return orig(arr)

        self.model._to_pil = check
        return self

    def __exit__(self, *exc):
        del self.model._to_pil


def j1_vist(torch, model, tmp, rep):
    """Two synthetic VIST stories of five steps through #6, sequentially
    then --batch 2 (the retrieval index off, as the script loads)."""
    import json as _json

    from gill_tpu_torch.evals import generate_vist_images as gv

    vist = os.path.join(tmp, "vist")
    _j_png_dir(os.path.join(vist, "val_images"),
               [f"s{s}i{i}" for s in range(2) for i in range(5)], 224, 61)
    stories = {f"story{s}": [
        {"caption": f"{w} step {i} of the trip to the lake.",
         "image_id": f"s{s}i{i}", "sequence_index": i}
        for i, w in enumerate(["We", "Then", "Later", "Next", "Finally"])]
        for s in range(2)}
    with open(os.path.join(vist, "val_formatted.json"), "w") as f:
        _json.dump({"annotations": stories}, f)
    index, model.index = model.index, None
    out = {}
    try:
        for batch, name in ((1, "seq"), (2, "batch")):
            zero_launches()
            t0 = time.perf_counter()
            with _FiniteImages(torch, model) as fin:
                out[name] = gv.generate_all(
                    model, gv.story_prompts(vist),
                    os.path.join(tmp, f"vist_{name}"), batch=batch,
                    num_inference_steps=J_STEPS)
            torch.cuda.synchronize()
            paths = [os.path.join(tmp, f"vist_{name}", f"{k}.png")
                     for k in ("s0i4", "s1i4")]
            rep[name] = {"s": time.perf_counter() - t0,
                         "launches": read_launches(),
                         "images": fin.n, "non_finite": fin.bad,
                         "pngs_ok": _j_pngs_ok(paths, 512),
                         "texts": out[name]}
    finally:
        model.index = index
    rep["tokens_equal"] = out["seq"] == out["batch"]
    fails = []
    for name, need in (("seq", ("flash_attention", "flash_mma", "geglu_ff")),
                       ("batch", ("flash_attention", "flash_mma", "geglu_ff",
                                  "prefix_decode_attention"))):
        r = rep[name]
        if sorted(r["texts"]) != ["s0i4", "s1i4"] or not r["pngs_ok"] \
                or r["images"] != 2 or r["non_finite"]:
            fails.append(f"J1 {name}: {r}")
        fails += [f"J1 {name}: {k} not launched" for k in need
                  if not r["launches"][k]]
    if not rep["tokens_equal"]:
        fails.append(f"J1: --batch texts {out['batch']} != {out['seq']}")
    rep["vist_dir"] = vist
    return fails


def j2_clip_sim(torch, dev, tmp, vist, rep):
    """#4 on J1's sequential outputs against the stories' last images."""
    from gill_tpu_torch.evals import compute_clip_similarity as ccs

    params, cfg = ccs.load_clip("openai/clip-vit-large-patch14", None, dev)
    scores = ccs.score_pairs(params, cfg, ccs.pairs_vist(
        os.path.join(vist, "val_formatted.json"),
        os.path.join(vist, "val_images"), os.path.join(tmp, "vist_seq")),
        dev)
    px = torch.randn(1, cfg.image_size, cfg.image_size, 3, device=dev,
                     generator=torch.Generator(dev).manual_seed(62))
    rep["scores"] = scores
    rep["self_sim_err"] = float((ccs.cos_sim(params, cfg, px, px) - 1
                                 ).abs().max())
    del params
    fails = []
    if len(scores) != 2 or not all(math.isfinite(x) and -1 <= x <= 1
                                   for x in scores):
        fails.append(f"J2: scores {scores}")
    if rep["self_sim_err"] > 1e-5:
        fails.append(f"J2: an image against itself {rep['self_sim_err']}")
    return fails


def _j_lpips_npz(path: str) -> str:
    import numpy as np

    from gill_tpu_torch.evals.lpips_2dirs import ALEX_CONVS

    rng = np.random.RandomState(63)
    blobs, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(ALEX_CONVS):
        blobs[f"conv{i}_w"] = (rng.randn(k, k, cin, cout)
                               * (2.0 / (k * k * cin)) ** 0.5
                               ).astype(np.float32)
        blobs[f"conv{i}_b"] = np.zeros(cout, np.float32)
        blobs[f"lin{i}_w"] = rng.rand(cout).astype(np.float32)
        cin = cout
    np.savez(path, **blobs)
    return path


def j3_lpips(torch, dev, tmp, rep):
    """#3 at 256² on seeded random AlexNet and calibration weights in
    gill_tpu's .npz layout: d(x, x), d(x, noisy x), card against CPU."""
    import numpy as np
    from PIL import Image

    from gill_tpu_torch.evals import lpips_2dirs

    w = _j_lpips_npz(os.path.join(tmp, "lpips.npz"))
    d0, d1 = os.path.join(tmp, "lp0"), os.path.join(tmp, "lp1")
    a, b = _j_png_dir(d0, ["same", "noisy"], 256, 64)
    os.makedirs(d1)
    Image.open(a).save(os.path.join(d1, "same.png"))
    x = np.asarray(Image.open(b), np.float32)
    noise = np.random.RandomState(65).randn(*x.shape) * 40
    Image.fromarray(np.clip(x + noise, 0, 255).astype(np.uint8)).save(
        os.path.join(d1, "noisy.png"))
    got = {}
    for dev_name in (dev.type, "cpu"):
        out = os.path.join(tmp, f"lpips_{dev_name}.txt")
        lpips_2dirs.main(["-d0", d0, "-d1", d1, "-o", out,
                          "--lpips-weights", w, "--device", dev_name])
        got[dev_name] = {ln.split(": ")[0]: float(ln.split(": ")[1])
                         for ln in open(out).read().splitlines()[:-1]}
    card = got[dev.type]
    rep["card"], rep["cpu"] = card, got["cpu"]
    rel = {k: abs(card[k] - got["cpu"][k]) / max(abs(got["cpu"][k]), 1e-30)
           for k in got["cpu"]}
    rep["card_vs_cpu_rel"] = rel
    fails = []
    if not card["same.png"] < 1e-6:
        fails.append(f"J3: d(x, x) = {card['same.png']}")
    if not card["noisy.png"] > 1e-3:
        fails.append(f"J3: d(x, noisy x) = {card['noisy.png']}")
    if not rel["noisy.png"] <= 1e-4 or abs(
            card["same.png"] - got["cpu"]["same.png"]) > 1e-6:
        fails.append(f"J3: card vs CPU {rel}")
    return fails


def j4_embeddings(torch, model, tmp, rep):
    """#5 on 64 images at batch 32: the file read back through
    `load_embeddings` equals the model's own retrieval embeddings."""
    import numpy as np
    from PIL import Image

    from gill_tpu_torch.retrieval import load_embeddings, save_embeddings
    from gill_tpu_torch.scripts import extract_img_embs as ex
    from gill_tpu_torch.utils.image import clip_preprocess

    paths = _j_png_dir(os.path.join(tmp, "emb_imgs"),
                       [f"{i:03d}" for i in range(64)], 256, 66)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = ex.extract(model, paths, 32)
    torch.cuda.synchronize()
    rep["images_per_s"] = len(paths) / (time.perf_counter() - t0)
    save_embeddings(os.path.join(tmp, "cc3m_j4.npy"), paths, embs)
    got_paths, got = load_embeddings(tmp, "cc3m_j4.npy")
    want = []
    for i in range(0, 64, 32):
        px = np.stack([clip_preprocess(Image.open(p), model.core.cfg.image_size)
                       for p in paths[i:i + 32]])
        want.append(model.core.get_visual_embs(
            model.params, torch.from_numpy(px).to(model.device),
            "retrieval")[:, 0].float().cpu().numpy())
    want = np.concatenate(want)
    rep["shape"] = list(got.shape)
    rep["bitwise_equal"] = bool(got_paths == paths
                                and np.array_equal(got, want))
    return [] if rep["bitwise_equal"] and got.shape == (64, 256) else \
        [f"J4: {rep}"]


def j5_sd_text_and_p2(torch, dev, model, tmp, rep):
    """#8 on 8 captions (its random fp32 SD v1.5 text tower, as without
    weights) and #9 on 2 prompts with the main path's SD weights."""
    import numpy as np

    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.scripts import generate_sd_p2_images as p2
    from gill_tpu_torch.scripts import preprocess_sd_embeddings as pre
    from gill_tpu_torch.tokenizer import CLIPBPETokenizer

    tsv = os.path.join(tmp, "caps.tsv")
    with open(tsv, "w") as f:
        f.write("caption\timage\n")
        for i in range(8):
            f.write(f"a photo of a {['red', 'blue'][i % 2]} boat number "
                    f"{i}\timg{i}.jpg\n")
    out_dir = os.path.join(tmp, "clip_embs")
    os.makedirs(out_dir)
    zero_launches()
    t0 = time.perf_counter()
    pipe = pre.text_pipeline(os.path.join(tmp, "no_sd"), dev)
    pre.encode_rows(pipe, pre.pending_rows(tsv, out_dir))
    torch.cuda.synchronize()
    del pipe
    embs = [np.load(os.path.join(out_dir, f"img{i}.jpg.npy"))
            for i in range(8)]
    rep["sd_text"] = {"s": time.perf_counter() - t0,
                      "launches": read_launches(),
                      "files_ok": all(e.shape == (77, 768)
                                      and e.dtype == np.float16
                                      and np.isfinite(e).all() for e in embs),
                      "pending_after": len(pre.pending_rows(tsv, out_dir))}
    zero_launches()
    t0 = time.perf_counter()
    sd = model.sd_pipe
    pipe = StableDiffusionPipeline(sd.cfg, sd.params,
                                   tokenizer=CLIPBPETokenizer.tiny())
    p2_tsv = os.path.join(tmp, "p2.tsv")
    with open(p2_tsv, "w") as f:
        f.write("Prompt\tCategory\n"
                "a watercolor of a lighthouse\tArt\n"
                "two dogs playing in the snow\tAnimals\n")
    finite = []
    decode = pipe.decode_latents

    def checked(latents):
        img = decode(latents)
        finite.append(bool(torch.isfinite(img).all()))
        return img

    pipe.decode_latents = checked
    paths = p2.generate_p2(pipe, p2.read_prompts(p2_tsv),
                           os.path.join(tmp, "p2_out"),
                           num_inference_steps=J_STEPS)
    torch.cuda.synchronize()
    rep["p2"] = {"s": time.perf_counter() - t0, "launches": read_launches(),
                 "files": [os.path.basename(p) for p in paths],
                 "finite": finite, "pngs_ok": _j_pngs_ok(paths, 512)}
    fails = []
    if not rep["sd_text"]["files_ok"] or rep["sd_text"]["pending_after"]:
        fails.append(f"J5 SD text: {rep['sd_text']}")
    if rep["p2"]["files"] != ["0.png", "1.png"] or finite != [True] \
            or not rep["p2"]["pngs_ok"]:
        fails.append(f"J5 P2: {rep['p2']}")
    fails += [f"J5 P2: {k} not launched" for k in
              ("flash_attention", "flash_mma", "geglu_ff")
              if not rep["p2"]["launches"][k]]
    return fails


def j6_decision(torch, dev, model, tmp, rep):
    """#10 on 64 synthetic prompts (features at OPT-6.7B's width), 200
    steps; the saved MLP routes one forced-[IMG] request."""
    import numpy as np

    from gill_tpu_torch.api import _to_device
    from gill_tpu_torch.models import decision as decision_mod
    from gill_tpu_torch.scripts import train_decision_classifier as tdc
    from gill_tpu_torch.utils.ckpt import load_decision_model

    tsv = os.path.join(tmp, "decisions.tsv")
    with open(tsv, "w") as f:
        f.write("Prompt\tCategory\tDecision\n")
        for i in range(64):
            kind = ["gen", "ret"][i % 2]
            what = ["an imaginary castle on a cloud",
                    "a photo of a city street"][i % 2]
            f.write(f"{what} number {i}\tc\t{kind}\n")
    prompts, labels = tdc.read_annotations(tsv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = tdc.extract_features(model, prompts)
    torch.cuda.synchronize()
    rep["features_s"] = time.perf_counter() - t0
    for key in ("train_s", "train_again_s"):     # cold, then warm
        t0 = time.perf_counter()
        best, f1 = tdc.train_classifier(x, labels, dev, steps=200)
        torch.cuda.synchronize()
        rep[key] = time.perf_counter() - t0
        if key == "train_s":
            first = best
    rep["same_seed_same_weights"] = all(np.array_equal(first[k], best[k])
                                        for k in best)
    out = os.path.join(tmp, "decision_model.npz")
    np.savez(out, w=best["w"], b=best["b"])
    rep["features"] = list(x.shape)
    rep["best_macro_f1"] = f1
    saved = model.decision_params
    model.decision_params = _to_device(load_decision_model(out), dev,
                                       torch.float32)
    try:
        outs = model.generate_for_images_and_texts(
            ["a watercolor painting of a lighthouse at sunset"], num_words=2,
            gen_scale_factor=1e5, num_inference_steps=J_STEPS,
            generator=torch.Generator(dev).manual_seed(67))
        label, probs = decision_mod.decide(model.decision_params,
                                           torch.ones(1, x.shape[1],
                                                      device=dev))
    finally:
        model.decision_params = saved
    rep["decision"] = outs[1]["decision"] if len(outs) > 1 else None
    fails = []
    if x.shape != (64, 4096) or not np.isfinite(x).all():
        fails.append(f"J6: features {x.shape}")
    if not rep["same_seed_same_weights"]:
        fails.append("J6: two trainings from one seed differ")
    d = rep["decision"]
    if not d or d[0] not in ("gen", "ret") or abs(sum(d[1]) - 1) > 1e-5 \
            or label not in ("gen", "ret"):
        fails.append(f"J6: routed {d}")
    return fails


def j7_apps(torch, dev, model, tmp, rep):
    """The demo's ChatSession (a text turn, then an image forced with
    gen_scale_factor 1e6) and HTML export, its REPL on scripted stdin,
    the four inference examples and validate_real_weights with no assets
    (every check SKIPPED, status 0)."""
    import io
    import json as _json
    import types

    import numpy as np
    from PIL import Image

    from gill_tpu_torch.demo import app_gradio
    from gill_tpu_torch.examples import inference_examples as ex
    from gill_tpu_torch.scripts import validate_real_weights as vrw

    fails = []
    zero_launches()
    t0 = time.perf_counter()
    session = app_gradio.ChatSession(model)
    first = session.user_turn("what should I pack for a picnic")
    session.gen_scale_factor = 1e6
    second = session.user_turn("show me a picnic by the lake")
    html = app_gradio.export_conversation_html(
        session.conversation, os.path.join(tmp, "chat.html"))
    torch.cuda.synchronize()
    rep["chat"] = {"s": time.perf_counter() - t0,
                   "launches": read_launches(),
                   "replies": [[r if isinstance(r, str) else list(r.size)
                                for r in x] for x in (first, second)],
                   "html_images": open(html).read().count(
                       "data:image/png;base64,")}
    if not all(isinstance(r, str) for r in first) or not any(
            isinstance(r, Image.Image) and r.size == (512, 512)
            for r in second) or rep["chat"]["html_images"] != 1:
        fails.append(f"J7 chat: {rep['chat']}")
    args = types.SimpleNamespace(save_dir=os.path.join(tmp, "repl"))
    os.makedirs(args.save_dir)
    stdin = sys.stdin
    sys.stdin = io.StringIO("hello there\n/save\n/quit\n")
    try:
        app_gradio.launch_repl(model, args)
    finally:
        sys.stdin = stdin
    rep["repl_files"] = sorted(os.listdir(args.save_dir))
    if not any(f.startswith("conversation_") and f.endswith(".html")
               for f in rep["repl_files"]):
        fails.append(f"J7 REPL: {rep['repl_files']}")
    zero_launches()
    t0 = time.perf_counter()
    img = Image.fromarray(np.random.RandomState(68).randint(
        0, 256, (300, 260, 3), np.uint8))
    res = ex.run_examples(model, os.path.join(tmp, "examples"), img)
    torch.cuda.synchronize()
    rep["examples"] = {"s": time.perf_counter() - t0,
                       "launches": read_launches(),
                       "files": sorted(os.listdir(os.path.join(
                           tmp, "examples"))),
                       "log_likelihood": res["log_likelihood"],
                       "routes": {k: [type(o).__name__ for o in v]
                                  for k, v in res.items()
                                  if k != "log_likelihood"}}
    if not math.isfinite(res["log_likelihood"]) or not isinstance(
            res["forced_image"][-1], dict) or \
            "forced_image_gen0.png" not in rep["examples"]["files"]:
        fails.append(f"J7 examples: {rep['examples']}")
    empty = os.path.join(tmp, "no_assets")
    os.makedirs(empty)
    report = os.path.join(tmp, "weights_report.json")
    saved_env = {k: os.environ.pop(k, None) for k in (
        "GILL_TPU_WEIGHTS_DIR", "GILL_TPU_TOKENIZER_DIR",
        "GILL_TPU_LPIPS_WEIGHTS")}
    try:
        rc = vrw.main(["--weights-dir", empty, "--tokenizer-dir", empty,
                       "--out", report])
    finally:
        os.environ.update({k: v for k, v in saved_env.items()
                           if v is not None})
    results = _json.load(open(report))["results"]
    rep["validate"] = {"rc": rc, "status": {k: v["status"]
                                            for k, v in results.items()}}
    if rc != 0 or set(results) != set(vrw.CHECKS) or any(
            v["status"] != "SKIPPED" or not v["reason"]
            for v in results.values()):
        fails.append(f"J7 validate: {rep['validate']}")
    return fails


def phase_j(torch, dev, model):
    """Slice 15 (docstring item 12), on the main path's model: each part
    with its launch counts set to 0 before it and read after, its
    seconds, peak memory and the card's name and power limit on a line of
    its own; a part that raises is a failure. J7's pruning of a training
    checkpoint runs inside phase H (`j7_prune`), where one exists."""
    import traceback

    rep, failures = {}, []
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        parts = [("J1", lambda r: j1_vist(torch, model, tmp, r)),
                 ("J2", lambda r: j2_clip_sim(torch, dev, tmp,
                                              rep["J1"]["vist_dir"], r)),
                 ("J3", lambda r: j3_lpips(torch, dev, tmp, r)),
                 ("J4", lambda r: j4_embeddings(torch, model, tmp, r)),
                 ("J5", lambda r: j5_sd_text_and_p2(torch, dev, model, tmp,
                                                    r)),
                 ("J6", lambda r: j6_decision(torch, dev, model, tmp, r)),
                 ("J7", lambda r: j7_apps(torch, dev, model, tmp, r))]
        for name, fn in parts:
            r = rep[name] = {}
            zero_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                fails = fn(r)
            except Exception:
                fails = [f"{name}: {traceback.format_exc(limit=6)}"]
            torch.cuda.synchronize()
            r.setdefault("launches", read_launches())
            r["part_s"] = time.perf_counter() - t0
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            r["device"] = smi_line()
            failures += fails
            log(f"apps phase {name}:", json.dumps(r, default=str))
            torch.cuda.empty_cache()
        for name, need in (("J2", "flash_attention"),
                           ("J4", "flash_attention")):
            if not rep[name]["launches"][need]:
                failures.append(f"{name}: {need} not launched")
    rep["phase_s"] = time.perf_counter() - t_phase
    return rep, failures


def j7_prune(log_dir: str) -> tuple:
    """#2 on a training run's checkpoint (phase H1's): the `.npz` holds
    the adapters of `ckpt_best/` under gill_tpu's names, no optimizer
    state. Returns (report, failures)."""
    import numpy as np

    from gill_tpu_torch.scripts import prune_model_ckpt
    from gill_tpu_torch.utils import ckpt as ckpt_utils

    t0 = time.perf_counter()
    path = prune_model_ckpt.main([log_dir])
    got = dict(np.load(path))
    tree, _ = ckpt_utils.load_checkpoint(os.path.join(log_dir, "ckpt_best"))
    want = ckpt_utils._flatten(tree["adapters"])
    rep = {"s": time.perf_counter() - t0, "keys": len(got),
           "mb": os.path.getsize(path) / 1e6,
           "equal": sorted(got) == sorted(want) and all(
               np.array_equal(got[k], want[k]) for k in want)}
    return rep, [] if rep["equal"] else [f"J7 prune: {rep}"]


def probe_kernel_rows(torch, dev, record):
    """S1's seven cases and every S2/S3 variant of the sweep at the probes'
    full shapes, each against its plain version; each row goes to
    `record`."""
    import torch.nn.functional as F

    from gill_tpu_torch.ops import flash_variants as fv
    from gill_tpu_torch.ops import mm_probe as mp
    from gill_tpu_torch.scripts import attn_mxu_probe, attn_sweep

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
                                   f" product",
               "plan": mp.mm_plan(m, k, n, dtype, sms)._asdict()}
        # wgmma's share of the card's published peak for the type (the
        # real M, not the 64 rows a padded tile issues), and the share of
        # the device time the K-chunk sum (a second pass, K > one chunk)
        # takes over ten profiled calls (None where the trace holds none)
        row["peak_share"] = 2.0 * m * k * n * mp.REPS / (
            row["ms"] * 1e-3) / PEAK_FLOPS["int8" if i8 else "bf16"]
        su = device_profile(lambda: [mp.mm_probe(a, b) for _ in range(10)],
                            sums=("mm_rep", "sum_chunks"))["sum_us"]
        row["chunk_sum_share"] = su["sum_chunks"] / (
            su["mm_rep"] + su["sum_chunks"]) if su["mm_rep"] > 0 else None
        record(row, err, tol, note=f"; {row['peak_share']:.3f} of the "
                                   f"{'int8' if i8 else 'bf16'} peak")
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
    from gill_tpu_torch.scripts import (attn_mxu_probe, attn_pack_probe,
                                        attn_sweep, flash_blockk_probe,
                                        int8_probe, profile_ln_fuse,
                                        profile_prefix_decode, profile_sd,
                                        profile_sd_ablate, profile_specdec,
                                        w8_probe)

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
              ("w8_probe", lambda: w8_probe.probe(device="cuda", reps=12)),
              ("profile_specdec", lambda: profile_specdec.probe(
                  device="cuda", rounds=(1, 3), steps=(4, 12))),
              ("flash_blockk_probe", lambda: flash_blockk_probe.probe(
                  device="cuda", n1=1, n2=3)),
              ("attn_pack_probe", lambda: attn_pack_probe.probe(
                  device="cuda", n_lo=1, n_hi=3))]
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
    for name in ("mm_probe", "flash_variant", "flash_nomax", "w8_matmul",
                 "flash_mma"):
        if launches[name] <= 0:
            failures.append(f"{name} was not launched in phase E's probes")
    return rows, rep, failures


# ---------------------------------------------------------------------------
# phase H: training (slice 13)
# ---------------------------------------------------------------------------

H_TRAIN_N, H_VAL_N, H_BATCH, H_GRAD_BATCH, H_REMAT_BATCH = 128, 32, 32, 8, 200
# H2: the kernels (CLIP's attention) against their plain versions change
# the step's inputs by bf16 roundings only, compounded over CLIP's 24
# layers: the leaves whose gradient is CLIP's pooled output times the
# contrastive loss's (visual_fc, ret_fc, visual_embeddings) read cosines
# of 0.9984-0.9996 on the card (both versions are bitwise deterministic),
# where a kernel cutting the LM's attention gradient reads 0.009
H_GRAD_COS, H_GRAD_NORM_RTOL, H_LOSS_RTOL = 0.99, 2e-2, 1e-2
H_REMAT_RTOL = 1e-3      # remat against the plain step, where not bitwise
H_W8_LOSS_RTOL = 5e-2    # tests/test_train_step.py:181
H_RENORM_RTOL = 1e-3


def write_opt_sized_tokenizer(path: str) -> int:
    """vocab.json / merges.txt of a byte-level tokenizer with OPT's 50,265
    entries (the tiny byte vocabulary and unused filler tokens), so that
    setup_gill_tokenizer places <|image|> and [IMG0..8) where GILL's OPT
    tokenizer has them. Returns the vocabulary size."""
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer

    vocab = dict(GPT2BPETokenizer.tiny().encoder)
    i = 0
    while len(vocab) < 50265:
        vocab[f"<|unused{i}|>"] = len(vocab)
        i += 1
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return len(vocab)


def tree_checksum(torch, tree) -> list:
    """Two int64 sums (of the raw bits and of their squares, wrapping) of
    every leaf, a layer at a time: equal lists mean the trees' bits are
    (with overwhelming likelihood) equal."""
    from gill_tpu_torch.nn.core import tree_leaves

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    out = []
    for leaf in tree_leaves(tree):
        if not torch.is_tensor(leaf):
            continue
        for part in (leaf if leaf.ndim >= 3 else [leaf]):
            v = part.contiguous().view(-1).view(
                ints[part.element_size()]).long()
            out.append((int(v.sum()), int((v * v).sum())))
    return out


class _Tee:
    """Copies what is printed to the real stdout and keeps it."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _flash_count(launches: dict) -> int:
    return launches["flash_attention"] + launches["flash_mma"]


def h1_cli(torch, dev, tmp, failures):
    """`gill_tpu_torch.main.main(argv)` in this process at full width on a
    stub dataset; the train step and `validate` are wrapped to time them
    and read the launch counts around them. Returns (report, what H2-H4
    reuse: the core, the frozen trees, the final state, the data root)."""
    from gill_tpu_torch import main as train_main
    from gill_tpu_torch.data.dataset import make_stub_dataset
    from gill_tpu_torch.nn.core import tree_leaves
    from gill_tpu_torch.train import trainer as trainer_mod
    from gill_tpu_torch.train import validate as validate_mod
    from gill_tpu_torch.utils import ckpt as ckpt_utils
    from gill_tpu_torch.utils.tb import read_events

    rep = {}
    t0 = time.perf_counter()
    root = os.path.join(tmp, "data")
    make_stub_dataset(root, n=H_TRAIN_N, image_size=224, num_clip_tokens=77,
                      gen_emb_dim=768, split="train")
    make_stub_dataset(root, n=H_VAL_N, image_size=224, num_clip_tokens=77,
                      gen_emb_dim=768, split="val")
    tok_dir = os.path.join(tmp, "tokenizer")
    rep["tokenizer_entries"] = write_opt_sized_tokenizer(tok_dir)
    rep["stub_data_s"] = time.perf_counter() - t0

    seen = {"steps": [], "val": []}
    make_step, validate = trainer_mod.make_train_step, validate_mod.validate

    def timed_make_step(core, tc, prefix_ids=None):
        step = make_step(core, tc, prefix_ids)

        def run(state, frozen, batch, concat=False):
            if "frozen" not in seen:
                seen.update(core=core, frozen=frozen,
                            sum0=tree_checksum(torch, frozen),
                            adapters0=[x.detach().clone()
                                       for x in tree_leaves(state.adapters)])
            torch.cuda.synchronize()
            zero_launches()
            t = time.perf_counter()
            state, metrics = step(state, frozen, batch, concat)
            loss = float(metrics["loss"])
            seen["steps"].append({"s": time.perf_counter() - t,
                                  "loss": loss, "concat": concat,
                                  "launches": read_launches()})
            seen["state"] = state
            return state, metrics

        return run

    def timed_validate(*a, **kw):
        torch.cuda.synchronize()
        zero_launches()
        t = time.perf_counter()
        top1 = validate(*a, **kw)
        torch.cuda.synchronize()
        seen["val"].append({"s": time.perf_counter() - t,
                            "launches": read_launches()})
        return top1

    argv = ["--batch-size", str(H_BATCH), "--epochs", "1",
            "--steps-per-epoch", "4", "--val-steps-per-epoch", "1",
            "--concat-captions-prob", "0.5", "--seed", "0",
            "--precision", "bf16", "--lr-warmup-steps", "2",
            "--print-freq", "2", "--workers", "8",
            "--dataset-dir", os.path.join(root, "datasets"),
            "--image-dir", root, "--log-base-dir", os.path.join(tmp, "runs"),
            "--exp-name", "h1", "--tokenizer-dir", tok_dir,
            "--device", str(dev)]
    rep["argv"] = " ".join(argv)
    trainer_mod.make_train_step = timed_make_step
    validate_mod.validate = timed_validate
    tee = _Tee(sys.stdout)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            log_dir = train_main.main(argv)
    finally:
        trainer_mod.make_train_step = make_step
        validate_mod.validate = validate
    torch.cuda.synchronize()
    rep["main_s"] = time.perf_counter() - t0
    rep["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    steps, vals = seen["steps"], seen["val"]
    core, state = seen["core"], seen["state"]
    rep["img_start"] = core.img_start
    rep["vocab_len"] = core.vocab_len
    rep["embed_rows"] = int(seen["frozen"]["lm"]["embed_tokens"][
        "weight"].shape[0])
    rep["step_s"] = [s["s"] for s in steps]
    rep["losses"] = [s["loss"] for s in steps]
    rep["concat"] = [s["concat"] for s in steps]
    med = sorted(rep["step_s"][1:4])[1]
    rep["s_a_step_median_2_4"] = med
    rep["examples_per_s"] = H_BATCH / med
    rep["flash_launches_a_step"] = [_flash_count(s["launches"])
                                    for s in steps]
    rep["launches_step_2"] = steps[1]["launches"]
    rep["val_s"] = [v["s"] for v in vals]
    rep["flash_launches_a_validation"] = [_flash_count(v["launches"])
                                          for v in vals]
    rep["launches_validation"] = vals[-1]["launches"]

    text = tee.text()
    if len(steps) != 4 or not all(math.isfinite(x) for x in rep["losses"]):
        failures.append(f"H1: steps {len(steps)}, losses {rep['losses']}")
    if "Epoch: [0]" not in text or " * val/loss=" not in text:
        failures.append("H1: the meter lines were not printed")
    if len(vals) != 2:
        failures.append(f"H1: {len(vals)} validations, want 2")
    if min(rep["flash_launches_a_step"]) <= 0:
        failures.append("H1: CLIP's flash kernel did not launch in a step")
    if min(rep["flash_launches_a_validation"]) <= 0:
        failures.append("H1: no flash kernel launched in validation")
    (ev,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)
             if f.startswith("events.out.tfevents.")]
    events = read_events(ev, verify_crc=True)
    scalars = {t for e in events for t in e["scalars"]}
    images = {t for e in events for t in e["images"]}
    rep["tb_tags"] = len(scalars | images)
    want_s = {"train/loss", "train/cap_ce", "train/cont_loss",
              "train/gen_l2", "train/grad_norm", "train/lr", "val/loss",
              "val/top1", "val/bleu4", "metrics/examples_per_sec"}
    want_i = {"train/images_gen_cap", "train/t2i_ret", "train/i2t_ret",
              "val/images_captioning"}
    if not (want_s <= scalars and want_i <= images):
        failures.append(f"H1: TB lacks {sorted(want_s - scalars)} "
                        f"{sorted(want_i - images)}")
    mism = 0
    for sub in ("ckpt", "ckpt_best"):
        tree, meta = ckpt_utils.load_checkpoint(os.path.join(log_dir, sub))
        got = ckpt_utils._flatten(tree["adapters"])
        want = ckpt_utils._flatten(state.adapters)
        mism += sum(not (k in got and (got[k] == want[k]).all())
                    for k in want) + len(set(got) - set(want))
        if meta["step"] != 4:
            failures.append(f"H1: {sub} step {meta['step']}")
    rep["ckpt_leaf_mismatches"] = mism
    if mism:
        failures.append(f"H1: {mism} checkpoint leaves differ")
    rep["frozen_bits_unchanged"] = \
        tree_checksum(torch, seen["frozen"]) == seen["sum0"]
    if not rep["frozen_bits_unchanged"]:
        failures.append("H1: a frozen tree changed")
    moved = [float((a.detach() - b).abs().max()) for a, b in
             zip(tree_leaves(state.adapters), seen["adapters0"])]
    rep["adapter_leaves_moved"] = sum(m > 0 for m in moved)
    if rep["adapter_leaves_moved"] < len(moved) - 1:
        failures.append(f"H1: adapters moved {moved}")
    with torch.no_grad():
        table = seen["frozen"]["lm"]["embed_tokens"]["weight"]
        target = float(torch.linalg.vector_norm(
            table[:core.vocab_len - core.cfg.num_tokens].float(),
            dim=1).mean())
        norms = torch.linalg.vector_norm(
            state.adapters["img_embeddings"].float(), dim=1)
    rep["img_norm_rel_err"] = float((norms / target - 1).abs().max())
    if rep["img_norm_rel_err"] > H_RENORM_RTOL:
        failures.append(f"H1: [IMG] norms {norms.tolist()} vs {target}")
    # phase J7's checkpoint pruning, on this run's checkpoint
    rep["j7_prune"], prune_failures = j7_prune(log_dir)
    failures += prune_failures
    return rep, (core, seen["frozen"], state, root)


def _h_batch(torch, dev, root, core, n: int):
    """The first n training examples (cycled) as one device batch."""
    import numpy as np

    from gill_tpu_torch.data.dataset import TsvDataset
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer, setup_gill_tokenizer
    from gill_tpu_torch.train.trainer import put_batch

    tok = GPT2BPETokenizer.from_pretrained_dir(
        os.path.join(os.path.dirname(root), "tokenizer"))
    ids = setup_gill_tokenizer(tok, core.cfg.num_tokens)
    ds = TsvDataset(os.path.join(root, "datasets", "cc3m_train.tsv"),
                    os.path.join(root, "cc3m/training"), tok, ids,
                    max_len=core.cfg.max_len, image_size=224)
    items = [ds.get(i % len(ds)) for i in range(n)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]
             if k != "path"}
    return put_batch(batch, dev, torch.bfloat16)


@contextlib.contextmanager
def decoder_launches():
    """While the block runs, records each LM forward's launch counts (read
    just before and just after it) into the yielded list."""
    from gill_tpu_torch.models import opt as opt_mod

    forward, rec = opt_mod.forward, []

    def counted(*a, **kw):
        before = read_launches()
        out = forward(*a, **kw)
        after = read_launches()
        rec.append({k: after[k] - before[k] for k in after
                    if after[k] != before[k]})
        return out

    opt_mod.forward = counted
    try:
        yield rec
    finally:
        opt_mod.forward = forward


def h_grads(torch, core, frozen, adapters0, batch, tc):
    """Loss and adapter gradients of one step's three forwards from the
    adapters `adapters0` (copied)."""
    from gill_tpu_torch.nn.core import tree_leaves, tree_map
    from gill_tpu_torch.train.trainer import compute_losses

    adapters = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                        adapters0)
    params = {"lm": frozen["lm"], "vision": frozen["vision"],
              "adapters": adapters}
    with torch.enable_grad():
        loss, _ = compute_losses(core, params, batch, tc, False)
        leaves = tree_leaves(adapters)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.detach()
             for p, g in zip(leaves, grads)]
    return float(loss.detach()), grads


def _leaf_paths(tree, prefix="") -> list:
    """"a/b/c" for each leaf, in tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}/{k}")]
    return [prefix]


def _grad_agreement(torch, got, want, names) -> dict:
    """Per adapter leaf: the cosine of the two gradients and the relative
    difference of their norms; the worst of each, and its leaf."""
    cos, rel = [], []
    for name, g, w in zip(names, got, want):
        g, w = g.double().flatten(), w.double().flatten()
        ng, nw = float(g.norm()), float(w.norm())
        if nw == 0.0 and ng == 0.0:
            continue
        cos.append((float(g @ w) / max(ng * nw, 1e-300), name))
        rel.append((abs(ng - nw) / max(nw, 1e-300), name))
    return {"min_cos": min(cos)[0], "min_cos_leaf": min(cos)[1],
            "max_norm_rel": max(rel)[0], "max_norm_rel_leaf": max(rel)[1],
            "leaves": len(cos)}


def _lm_kernel_launches(records) -> int:
    return sum(d.get(k, 0) for d in records
               for k in ("flash_attention", "flash_mma", "w8_matmul",
                         "prefix_decode_attention", "flash_mma_q8"))


def h2_to_h4(torch, dev, core, frozen, state, root, failures):
    """H2: one step's loss and adapter gradients at batch 8 as the port
    runs it and with every kernel swapped for its plain version; no kernel
    may launch inside the LM forwards under grad. H3: the same with remat
    (peak memory of both), then one remat step at batch 200. H4: one step
    with the LM quantized to W8."""
    import dataclasses

    from gill_tpu_torch.config import TrainConfig
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.nn.core import tree_leaves
    from gill_tpu_torch.train import trainer as trainer_mod

    rep = {}
    tc = TrainConfig(batch_size=H_GRAD_BATCH, precision="bf16")
    batch = _h_batch(torch, dev, root, core, H_GRAD_BATCH)
    adapters = state.adapters

    def run(tc):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t = time.perf_counter()
        with decoder_launches() as lm_launches:
            loss, grads = h_grads(torch, core, frozen, adapters, batch, tc)
        torch.cuda.synchronize()
        return {"loss": loss, "grads": grads,
                "s": time.perf_counter() - t,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": read_launches(),
                "lm_kernel_launches": _lm_kernel_launches(lm_launches)}

    # H2
    kern = run(tc)
    with plain_kernels():
        plain = run(tc)
    names = _leaf_paths(adapters)
    agree = _grad_agreement(torch, kern["grads"], plain["grads"], names)
    rep["h2"] = {"loss": kern["loss"], "loss_plain": plain["loss"],
                 "loss_rel": abs(kern["loss"] - plain["loss"])
                 / abs(plain["loss"]), **agree,
                 "s": kern["s"], "s_plain": plain["s"],
                 "flash_launches": _flash_count(kern["launches"]),
                 "lm_kernel_launches_under_grad":
                     kern["lm_kernel_launches"]}
    if not (rep["h2"]["loss_rel"] <= H_LOSS_RTOL
            and agree["min_cos"] >= H_GRAD_COS
            and agree["max_norm_rel"] <= H_GRAD_NORM_RTOL):
        failures.append(f"H2: kernel step vs plain {rep['h2']}")
    if kern["lm_kernel_launches"]:
        failures.append("H2: a kernel launched in an LM forward under grad")
    if rep["h2"]["flash_launches"] <= 0:
        failures.append("H2: CLIP's flash kernel did not launch")

    # H3 (its first call pays a one-time warm-up of several seconds on
    # the card, so the second is timed)
    run(dataclasses.replace(tc, remat=True))
    remat = run(dataclasses.replace(tc, remat=True))
    bitwise = remat["loss"] == kern["loss"] and all(
        torch.equal(a, b) for a, b in zip(remat["grads"], kern["grads"]))
    agree = _grad_agreement(torch, remat["grads"], kern["grads"], names)
    rep["h3"] = {"bitwise_equal": bitwise, **agree,
                 "peak_gb": remat["peak_gb"], "peak_gb_no_remat":
                     kern["peak_gb"], "s": remat["s"], "s_no_remat": kern["s"],
                 "lm_kernel_launches_under_grad":
                     remat["lm_kernel_launches"]}
    if not bitwise and (abs(remat["loss"] / kern["loss"] - 1) > H_REMAT_RTOL
                        or agree["max_norm_rel"] > H_REMAT_RTOL
                        or agree["min_cos"] < 1 - H_REMAT_RTOL):
        failures.append(f"H3: remat vs plain step {rep['h3']}")
    del remat, kern, plain
    torch.cuda.empty_cache()
    big = _h_batch(torch, dev, root, core, H_REMAT_BATCH)
    tc200 = dataclasses.replace(tc, batch_size=H_REMAT_BATCH, remat=True)
    st = trainer_mod.init_state(tc200, adapters)
    step = trainer_mod.make_train_step(core, tc200)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    st, m = step(st, frozen, big)
    loss200 = float(m["loss"])
    rep["h3"].update(batch200_s=time.perf_counter() - t,
                     batch200_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                     batch200_loss=loss200)
    if not math.isfinite(loss200):
        failures.append(f"H3: batch-200 remat loss {loss200}")
    del st, m, big, step
    torch.cuda.empty_cache()

    # H4
    t = time.perf_counter()
    with torch.no_grad():
        lm8 = opt_mod.quantize_params_w8(frozen["lm"])
    rep["h4"] = {"quantize_s": time.perf_counter() - t}
    frozen8 = {"lm": lm8, "vision": frozen["vision"]}
    tc8 = dataclasses.replace(tc, lr_warmup_steps=0)
    st = trainer_mod.init_state(tc8, adapters)
    step = trainer_mod.make_train_step(core, tc8)
    bf16_loss = float(trainer_mod.make_eval_step(core, tc8)(
        adapters, frozen, batch)["loss"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    with decoder_launches() as lm_launches:
        st, m = step(st, frozen8, batch)
        loss8 = float(m["loss"])
    rep["h4"].update(
        s=time.perf_counter() - t, loss=loss8, loss_bf16=bf16_loss,
        loss_rel=abs(loss8 / bf16_loss - 1),
        k4_launches_under_grad=sum(d.get("w8_matmul", 0)
                                   for d in lm_launches),
        lm_kernel_launches_under_grad=_lm_kernel_launches(lm_launches),
        adapter_leaves_moved=sum(
            not torch.equal(a, b) for a, b in
            zip(tree_leaves(st.adapters), tree_leaves(adapters))))
    if not (math.isfinite(loss8)
            and rep["h4"]["loss_rel"] <= H_W8_LOSS_RTOL):
        failures.append(f"H4: W8 loss {loss8} vs bf16 {bf16_loss}")
    if rep["h4"]["lm_kernel_launches_under_grad"]:
        failures.append("H4: a kernel launched in an LM forward under grad")
    if rep["h4"]["adapter_leaves_moved"] < len(tree_leaves(adapters)) - 1:
        failures.append(f"H4: adapters moved {rep['h4']}")
    return rep


def phase_h(torch, dev):
    """Training (slice 13), outside the script's no_grad block; returns
    (report, failures)."""
    failures = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rep, (core, frozen, state, root) = h1_cli(torch, dev, tmp, failures)
        rep = {"h1": rep}
        torch.cuda.empty_cache()
        rep.update(h2_to_h4(torch, dev, core, frozen, state, root, failures))
        del core, frozen, state
    torch.cuda.empty_cache()
    rep["device"] = smi_line()
    rep["phase_s"] = time.perf_counter() - t0
    return rep, failures


# ---------------------------------------------------------------------------
# phase N: the native host engines and the closing tools (slice 17)
# ---------------------------------------------------------------------------

# N1: the native image engine against the PIL path (tests/test_native_image.py's
# bound on CLIP-normalized values: PIL resamples uint8 in 8-bit fixed point),
# on seeded JPEG / PNG sizes and a grayscale and a palette PNG
N_IMAGE_TOL = 0.02
N_IMAGE_CASES = [("JPEG", (320, 240)), ("JPEG", (100, 467)),
                 ("JPEG", (224, 224)), ("JPEG", (37, 61)),
                 ("PNG", (320, 240)), ("PNG", (100, 467)),
                 ("PNG", (224, 224)), ("PNG", (37, 61))]
N_BPE_WORDS, N_LOADER_BATCH, N_LOADER_THREADS = 20_000, 32, 8
# N2: profile_kv_window's perf phase, cut: OPT-6.7B W8 as phase A builds
# its engine, the trace's first N2_REQS requests with budgets capped at
# N2_BUDGET (phase I's cap), max_seq N2_SEQS x the read ladder off / on,
# no profiled chunk (phase A profiles one at max_seq 512; the script
# profiles each run)
N2_SEQS, N2_REQS, N2_BUDGET = (512, 2048), 16, 64
# N3 (inside phase I1's tp-2 ranks): tp_collective_budget's decode step
N3_BATCH, N3_MAX_SEQ, N3_REPS = 8, 128, 10


def _last_line(text) -> str:
    lines = [ln.strip() for ln in (text or "").splitlines() if ln.strip()]
    return lines[-1] if lines else "no compiler output"


def _first_error(text) -> str:
    """The compiler's first line that names an error (its last line is
    often just "compilation terminated.")."""
    lines = [ln.strip() for ln in (text or "").splitlines()
             if "error" in ln.lower()]
    return lines[0] if lines else _last_line(text)


def _n_image_bytes(fmt: str, wh, seed: int, mode: str = "RGB") -> bytes:
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    if mode == "L":
        img = Image.fromarray(rng.randint(0, 255, (wh[1], wh[0]), np.uint8),
                              "L")
    else:
        img = Image.fromarray(rng.randint(0, 255, (wh[1], wh[0], 3),
                                          np.uint8))
        if mode == "P":
            img = img.convert("P", palette=Image.ADAPTIVE)
    buf = io.BytesIO()
    img.save(buf, fmt, quality=95)
    return buf.getvalue()


def n1_image(native, failures) -> dict:
    """decode_preprocess against clip_preprocess on seeded images."""
    import io

    import numpy as np
    from PIL import Image

    from gill_tpu_torch.utils import image as iu

    mean, std = iu.CLIP_MEAN.reshape(-1), iu.CLIP_STD.reshape(-1)
    cases = [(f, wh, "RGB", 224) for f, wh in N_IMAGE_CASES] + [
        ("PNG", (128, 96), "L", 64), ("PNG", (128, 96), "P", 64)]
    errs = {}
    t_native = t_pil = 0.0
    for i, (fmt, wh, mode, size) in enumerate(cases):
        data = _n_image_bytes(fmt, wh, 100 + i, mode)
        t0 = time.perf_counter()
        out = native.decode_preprocess(data, size, mean, std)
        t1 = time.perf_counter()
        ref = iu.clip_preprocess(Image.open(io.BytesIO(data)), size)
        t_pil += time.perf_counter() - t1
        t_native += t1 - t0
        key = f"{fmt} {mode} {wh[0]}x{wh[1]}"
        if out is None or out.shape != ref.shape:
            failures.append(f"N1: decode_preprocess gave "
                            f"{None if out is None else out.shape} for {key}")
            continue
        errs[key] = float(np.abs(out - ref).max())
        if not errs[key] < N_IMAGE_TOL:
            failures.append(f"N1: {key} {errs[key]} >= {N_IMAGE_TOL}")
    bad = native.decode_preprocess(b"\xff\xd8\xffgarbage", 32, mean, std)
    if bad is not None:
        failures.append("N1: bad JPEG bytes gave an image")
    return {"max_abs_err": errs, "worst": max(errs.values(), default=None),
            "tol": N_IMAGE_TOL, "native_s": t_native, "pil_s": t_pil}


def n1_bpe(tmp, failures) -> dict:
    """The native BPE ids against the Python path's on the fixture
    vocabulary (written by make_tokenizer_fixture) over a long seeded
    text of mostly unseen words."""
    import numpy as np

    from gill_tpu_torch.scripts import make_tokenizer_fixture as fixture
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer

    d = os.path.join(tmp, "tok")
    fixture.write_fixture(d)
    rng = np.random.RandomState(17)
    alphabet = list("abcdefghijklmnopqrstuvwxyz") + ["é", "ï", "北", "🙂"]
    words = ["".join(rng.choice(alphabet, rng.randint(1, 12)))
             for _ in range(N_BPE_WORDS)]
    text = " ".join(words) + fixture.CORPUS
    nat = GPT2BPETokenizer.from_pretrained_dir(d)
    py = GPT2BPETokenizer.from_pretrained_dir(d)
    py._native = None
    if nat._native is None:
        failures.append("N1: the BPE library built but the tokenizer took "
                        "no engine")
        return {}
    t0 = time.perf_counter()
    a = nat.encode(text, add_special_tokens=False)
    t1 = time.perf_counter()
    b = py.encode(text, add_special_tokens=False)
    t2 = time.perf_counter()
    if a != b:
        at = next(i for i, (x, y) in enumerate(zip(a + [-1], b + [-2]))
                  if x != y)
        failures.append(f"N1: native BPE ids differ from Python's at {at}")
    return {"chars": len(text), "ids": len(a), "ids_equal": a == b,
            "native_s": t1 - t0, "python_s": t2 - t1}


def _n_jpeg_split(root: str, n: int, wh=(500, 375)) -> None:
    """A cc3m-layout split of `n` seeded JPEGs at CC3M's typical 500 x 375
    (the stub set's PNGs are already 224², so the resample does no work
    there), with the stub's 77 x 768 clip_embs and captions."""
    import numpy as np

    img_dir = os.path.join(root, "cc3m", "training")
    os.makedirs(os.path.join(img_dir, "clip_embs"), exist_ok=True)
    os.makedirs(os.path.join(root, "datasets"), exist_ok=True)
    rng = np.random.RandomState(21)
    with open(os.path.join(root, "datasets", "cc3m_train.tsv"), "w") as f:
        f.write("caption\timage\n")
        for i in range(n):
            name = f"train_{i}.jpg"
            with open(os.path.join(img_dir, name), "wb") as g:
                g.write(_n_image_bytes("JPEG", wh, 300 + i))
            np.save(os.path.join(img_dir, "clip_embs", name + ".npy"),
                    rng.randn(77, 768).astype(np.float16))
            f.write(f"a photo number {i}\t{name}\n")


def n1_loader(tmp, failures) -> dict:
    """Phase H1's training set (128 stub PNGs at 224², its OPT-sized
    tokenizer), and as many CC3M-sized JPEGs, through the loader, native
    and under GILL_NO_NATIVE_IMAGE=1, in turns: items/s of each epoch and
    the batches held to each other."""
    import numpy as np

    from gill_tpu_torch.data.dataset import (DataLoader, TsvDataset,
                                             make_stub_dataset)
    from gill_tpu_torch.tokenizer import (GPT2BPETokenizer,
                                          setup_gill_tokenizer)

    stub, jpeg = os.path.join(tmp, "data"), os.path.join(tmp, "jpeg")
    make_stub_dataset(stub, n=H_TRAIN_N, image_size=224, num_clip_tokens=77,
                      gen_emb_dim=768, split="train")
    _n_jpeg_split(jpeg, H_TRAIN_N)
    write_opt_sized_tokenizer(os.path.join(tmp, "opt_tok"))
    tok = GPT2BPETokenizer.from_pretrained_dir(os.path.join(tmp, "opt_tok"))
    img_ids = setup_gill_tokenizer(tok, 8)

    def epoch(root: str, no_native: bool):
        saved = os.environ.pop("GILL_NO_NATIVE_IMAGE", None)
        if no_native:
            os.environ["GILL_NO_NATIVE_IMAGE"] = "1"
        try:
            ds = TsvDataset(os.path.join(root, "datasets", "cc3m_train.tsv"),
                            os.path.join(root, "cc3m/training"), tok,
                            img_ids, max_len=32, image_size=224)
            t0 = time.perf_counter()
            batches = list(DataLoader(ds, N_LOADER_BATCH, shuffle=False,
                                      num_threads=N_LOADER_THREADS))
            return batches, len(ds) / (time.perf_counter() - t0)
        finally:
            os.environ.pop("GILL_NO_NATIVE_IMAGE", None)
            if saved is not None:
                os.environ["GILL_NO_NATIVE_IMAGE"] = saved

    rep = {"items": H_TRAIN_N, "threads": N_LOADER_THREADS}
    for name, root in (("stub_png_224", stub), ("jpeg_500x375", jpeg)):
        rates = {"native": [], "pil": []}
        got = {}
        for no_native in (False, True, True, False):
            batches, rate = epoch(root, no_native)
            key = "pil" if no_native else "native"
            rates[key].append(rate)
            got[key] = batches
        err = max((float(np.abs(a["pixels"] - b["pixels"]).max())
                   for a, b in zip(got["native"], got["pil"])),
                  default=float("inf"))
        same_tokens = all(np.array_equal(a["ret_tokens"], b["ret_tokens"])
                          for a, b in zip(got["native"], got["pil"]))
        if not err < N_IMAGE_TOL or not same_tokens:
            failures.append(f"N1 {name}: loader batches native vs PIL: "
                            f"pixels {err}, tokens equal {same_tokens}")
        rep[name] = {"native_items_per_s": rates["native"],
                     "pil_items_per_s": rates["pil"],
                     "native_over_pil": max(rates["native"])
                     / max(rates["pil"]),
                     "pixels_max_abs_native_vs_pil": err}
    return rep


def n1_native(torch, tmp, failures) -> dict:
    """N1: both native engines built with g++ here; where built, each
    held to its Python / PIL counterpart, and the loader timed with and
    without the image engine. An engine that does not build (no g++,
    libjpeg or libpng) is reported, not failed, as gill_tpu does."""
    from gill_tpu_torch import native

    rep = {}
    t0 = time.perf_counter()
    libs = {"bpe": native.bpe_lib(), "image": native.image_lib()}
    rep["build_s"] = time.perf_counter() - t0
    for name, lib in libs.items():
        rep[f"native_{name}"] = "built" if lib is not None else \
            f"unavailable: {_last_line(native.build_error(name))}"
        log(f"native_{name}: {rep[f'native_{name}']}")
        if lib is None:
            rep[f"native_{name}_error"] = _first_error(
                native.build_error(name))
    if libs["image"] is not None:
        rep["image"] = n1_image(native, failures)
    if libs["bpe"] is not None:
        rep["bpe"] = n1_bpe(tmp, failures)
    rep["loader"] = n1_loader(tmp, failures)
    return rep


def n2_kv_window(torch, dev, failures) -> dict:
    """N2: profile_kv_window's perf phase, cut, on a random W8 OPT-6.7B:
    tokens/s at N2_SEQS x the ladder off / on; the ladder on and off give
    the same tokens at each max_seq, and the runs at other pool depths the
    same tokens or a near-tie at each first divergence (K6 plans for the
    pool, so its split, and the bf16 rounding of a row, follow max_seq)."""
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.scripts import _serving as S
    from gill_tpu_torch.scripts import profile_kv_window as kvw

    params, cfg = _i_opt(torch, dev, torch.bfloat16)
    lm8 = opt_mod.quantize_params_w8(params)
    del params
    torch.cuda.empty_cache()
    reqs = serve_trace(N2_REQS)
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, N2_BUDGET)
    rep = {"runs": []}
    zero_launches()
    for max_seq in N2_SEQS:
        for ladder in (False, True):
            # the three warm-up requests, not warmup()'s every wave and
            # window: the kernels are built and the allocator warm by now
            r = kvw.run_engine(lm8, cfg, reqs, max_seq=max_seq,
                               ladder=ladder, device=dev, warmup=False,
                               profile=False, **kvw.PERF_ENGINE)
            rep["runs"].append(r)
            log("phase N2 run:", json.dumps(
                {k: v for k, v in r.items() if k != "tokens"}))
    rep["launches"] = read_launches()
    base = rep["runs"][0]
    for r in rep["runs"]:
        if r["generated"] != r["budget"]:
            failures.append(f"N2 {r['max_seq']} {r['ladder']}: "
                            f"{r['generated']} of {r['budget']} tokens")
    for a, b in zip(rep["runs"][::2], rep["runs"][1::2]):
        if a["tokens"] != b["tokens"]:
            failures.append(f"N2 max_seq {a['max_seq']}: the ladder changes "
                            f"the tokens")
    prompts = {r.uid: r.prompt for r in reqs}
    rep["divergences_vs_first"] = {}
    for r in rep["runs"][2::2]:
        div = S.token_divergences(lm8, cfg, base["tokens"], r["tokens"],
                                  prompts)
        rep["divergences_vs_first"][r["max_seq"]] = div
        if S.unexplained(div):
            failures.append(f"N2 max_seq {r['max_seq']}: tokens differ from "
                            f"max_seq {base['max_seq']}'s beyond a near-tie: "
                            f"{S.unexplained(div)}")
    for name in ("w8_matmul", "prefix_decode_attention"):
        if rep["launches"][name] <= 0:
            failures.append(f"N2: {name} not launched")
    rep["tokens_equal_all"] = all(r["tokens"] == base["tokens"]
                                  for r in rep["runs"])
    for r in rep["runs"]:
        r.pop("tokens")
    by = {(r["max_seq"], r["ladder"]): r["tokens_per_s"] for r in rep["runs"]}
    rep["tokens_per_s"] = {f"{s} {g}": v for (s, g), v in by.items()}
    rep["s2048_on_over_s512_on"] = by[(N2_SEQS[-1], "on")] / \
        by[(N2_SEQS[0], "on")]
    del lm8
    torch.cuda.empty_cache()
    return rep


def phase_n(torch, dev):
    """Phase N: N1 (native engines) and N2 (KV read window); N3 runs in
    phase I1's ranks. Returns (report, failures)."""
    failures = []
    rep = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rep["n1"] = n1_native(torch, tmp, failures)
    rep["n1"]["phase_s"] = time.perf_counter() - t0
    log("phase N1:", json.dumps(rep["n1"]))
    t0 = time.perf_counter()
    with torch.no_grad():
        rep["n2"] = n2_kv_window(torch, dev, failures)
    rep["n2"]["phase_s"] = time.perf_counter() - t0
    log("phase N2:", json.dumps(rep["n2"], default=str))
    rep["device"] = smi_line()
    return rep, failures


def n3_collectives(torch, params, cfg, mesh, dev) -> dict:
    """N3 on one tp rank: tp_collective_budget's one decode step over the
    rank's engine (from the host tree), the launches of that step's run."""
    from gill_tpu_torch.scripts import tp_collective_budget as tcb

    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    rep = tcb.measure(params, cfg, mesh, dev, batch=N3_BATCH,
                      max_seq=N3_MAX_SEQ, reps=N3_REPS)
    rep["launches"] = read_launches()
    rep["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return rep


def _n3_report(ranks, failures) -> dict:
    """N3's checks: every rank's step issued 2 all-reduces a layer (the
    attention and MLP blocks' row-parallel products) and nothing else, in
    the activations' bf16, and its logits and tokens are the same with the
    recorder open."""
    n3 = [r["n3"] for r in ranks]
    lead = n3[0]
    rep = {k: lead[k] for k in ("tp", "batch", "layers", "hidden", "dtype",
                                "backend", "rows", "collectives",
                                "all_reduces", "mb_a_step", "mb_a_token",
                                "step_ms", "collective_ms_a_step")}
    rep["launches_per_rank"] = [r["launches"] for r in n3]
    rep["s_per_rank"] = [r["s"] for r in n3]
    for i, r in enumerate(n3):
        want = 2 * r["layers"]
        if r["collectives"] != want or r["all_reduces"] != want:
            failures.append(f"N3 rank {i}: {r['collectives']} collectives "
                            f"({r['all_reduces']} all-reduces), want {want}")
        if not (r["tokens_equal_with_recorder"]
                and r["logits_equal_with_recorder"]):
            failures.append(f"N3 rank {i}: the recorder changed the step")
        if [dict(x, ms=None) for x in r["rows"]] != \
                [dict(x, ms=None) for x in lead["rows"]]:
            failures.append(f"N3 rank {i}: other collectives than rank 0's")
    log("phase N3:", json.dumps(rep, default=str))
    return rep


# ---------------------------------------------------------------------------
# phase I: the distributed layer (slice 14)
# ---------------------------------------------------------------------------

# I1: the bf16 teacher-forced prefill's last hidden states at tp 2 against
# tp 1, as ||a - b|| / ||b|| over every position (stated before the first
# run on the card: the row-parallel products sum two bf16 partials where
# tp 1 sums one product's fp32 accumulator, a rounding of ~2^-9 a reduce,
# 64 reduces deep)
I_HIDDEN_RTOL = 3e-2
I_SEED, I_FP32_LAYERS, I_REQS, I_BUDGET = 5, 8, 16, 64
I_SLOTS, I_MAX_SEQ, I_CHUNK = 16, 512, 32
# I2: the step at dp 2 and tp 2 against one process's on the same global
# batch of 16: the loss within I_LOSS_RTOL, every adapter gradient at a
# cosine >= I_GRAD_COS, the adapters after the update bit for bit equal
# across the ranks. The cosine limit is 0.99, not 0.999: in bf16 the
# worst leaf (the GILLMapper decoder's cross-attention q weight) read
# 0.9934 at dp 2 and 0.9930 at tp 2 on the card, the loss 9e-6 off, as
# the frozen LM's bf16 products take other roundings at 8 rows a rank or
# as two partial sums; the fp32 control (I_CONTROL_LAYERS of the 32
# layers at full width, dp 2) holds the same gradients to I_GRAD_COS_FP32.
# A cosine does not see a gradient's scale (a sum taken twice over "data"
# or "model" doubles it, and the loss and AdamW's update barely move), so
# every leaf's norm must also lie within I_GRAD_NORM_REL of one process's:
# the sound steps read 0.025 (dp 2) and 0.028 (tp 2) in bf16 and 1.2e-5
# in the fp32 control on the card, a doubled gradient reads 1.0
I_LOSS_RTOL, I_GRAD_COS, I_BATCH = 1e-3, 0.99, 16
I_GRAD_COS_FP32, I_CONTROL_LAYERS = 0.9999, 4
I_GRAD_NORM_REL, I_GRAD_NORM_REL_FP32 = 0.1, 1e-4
I_INDEX_ROWS = 2_900_000
I_GROUP_TIMEOUT, I_PG_TIMEOUT = 600.0, 300.0
# I4: the tp-2 engine online, the trace's first I_REQS requests arriving at
# I4_RATE a second (exponential gaps from I4_SEED), one cancelled while
# queued and one in flight; then a GILL engine on the fp32 tree, I4_GILL
# embedding prompts
I4_RATE, I4_SEED, I4_GILL = 8.0, 11, 6
# the in-flight cancel's request runs I4_FLIGHT_BUDGET tokens, so that the
# cancel, sent once its first chunk has streamed, lands while chunks are
# left: within I_BUDGET (two chunks) the scheduler can have dispatched the
# second before the first reaches the host, and the request then ends
# with its whole budget whatever the cancel
I4_FLIGHT_BUDGET = 5 * I_CHUNK
# where the rank functions live and run (a CPU rehearsal at tiny widths
# points these elsewhere)
I_MODULE, I_DEVICE, I_CLI_EXTRA = "chip_smoke", "cuda", ()


def _i_device(torch):
    if I_DEVICE == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _i_opt(torch, dev, dtype, layers=None, seed=I_SEED, host=False):
    """OPT-6.7B at full width (`layers` of its 32), random from `seed` on
    the card: the same bits in every process. `host`: the same tree on the
    host, each leaf drawn on the card and copied out (the card holds one
    leaf at a time)."""
    import dataclasses

    from gill_tpu_torch.config import OPTConfig
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.nn.core import Init
    from gill_tpu_torch.scripts.tp_collective_budget import HostInit

    cfg = OPTConfig.from_name("facebook/opt-6.7b")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    g = torch.Generator(dev).manual_seed(seed)
    return opt_mod.init((HostInit if host else Init)(g, dev, dtype),
                        cfg), cfg


def _i_requests(prefix=None):
    """The trace's first I_REQS requests, budgets capped at I_BUDGET; with
    `prefix`, every prompt starts with it and names its id."""
    reqs = serve_trace(I_REQS)
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, I_BUDGET)
        if prefix is not None:
            r.prompt = prefix[0] + r.prompt[:64]
            r.prefix_id = prefix[1]
    return reqs


def _i_prefix_tokens():
    import numpy as np

    return np.random.RandomState(3).randint(2, 1000, size=48).tolist()


def _i_serve(torch, params, cfg, dtype, mesh, device=None, online=None):
    """DecodeEngine over the trace (run_pipelined), a teacher-forced prefill
    of the first two prompts, and for fp32 a prefix registered and reused:
    tokens, hidden states, tokens/s and launches. `device`: the engine's,
    for a tree on the host. `online(eng, rep)`: a report of the same engine
    served online after that (phase I4), under rep["online"]."""
    import numpy as np

    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.serve.engine import DecodeEngine, to_device

    eng = DecodeEngine(params, cfg, slots=I_SLOTS, max_seq=I_MAX_SEQ,
                       chunk=I_CHUNK, kv_dtype=dtype, mesh=mesh,
                       device=device)
    rep = {"kv_heads": int(eng.cache["k"].shape[3])}
    reqs = _i_requests()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = eng.run_pipelined(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rep["launches"] = read_launches()
    rep["tokens"] = {u: out[u] for u in sorted(out)}
    rep["tokens_per_s"] = sum(len(v) for v in out.values()) / dt
    rep["serve_s"] = dt
    # the run's wall time over its decode steps (its one prefill wave
    # included): what a step costs, the reduces of tp 2 included
    rep["ms_a_decode_step"] = 1e3 * dt / eng.stats["decode_steps"]
    if dtype == torch.bfloat16:
        toks = np.ones((2, 256), np.int64)
        for i, r in enumerate(reqs[:2]):
            toks[i, :len(r.prompt)] = r.prompt
        small = eng._small_cache(2, 256)
        with torch.no_grad():
            h = opt_mod.forward(
                eng.params, cfg, opt_mod.embed_tokens(
                    eng.params, to_device(toks, eng.device)),
                cache=small, cache_pos=0, skip_logits=True, mesh=mesh)
        rep["hidden"] = h["last_hidden"].float().cpu()
    else:
        pfx = _i_prefix_tokens()
        pid = eng.register_prefix(pfx)
        zero_launches()
        pout = eng.run_pipelined(_i_requests((pfx, pid)))
        rep["prefix_launches"] = read_launches()
        rep["prefix_tokens"] = {u: pout[u] for u in sorted(pout)}
        rep["prefix_hits"] = eng.stats["prefix_hits"]
    if online is not None:
        rep["online"] = online(eng, rep)
    del eng
    torch.cuda.empty_cache()
    return rep


def _i_gates(torch, heads: int, head_dim: int, failures):
    """The kernels' gates and plans at a rank's shapes: K1 takes the causal
    prefill at its heads and head dim, K6 plans for the rank's pool; a
    refusal is a failure, never a quiet plain path."""
    from gill_tpu_torch.ops import attention as attn
    from gill_tpu_torch.ops import decode_attn

    rep = {}
    ok = attn.flash_eligible(on_cuda=True, t=256, s=256, has_bias=False,
                             has_kv_offset=False, impl="auto", causal=True)
    rep["k1_eligible"] = ok
    rep["k1_plan"] = str(attn.flash_plan(torch.bfloat16, I_SLOTS, 256,
                                         heads, head_dim))
    plan = decode_attn.decode_plan(I_SLOTS, I_MAX_SEQ, heads, head_dim)
    rep["k6_plan"] = str(plan)
    c = decode_attn.c_plan(I_SLOTS, I_MAX_SEQ, heads, head_dim,
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    rep["k6_c_plan"] = c
    rep["k6_heads_a_block"] = plan.heads
    if not ok:
        failures.append(f"I1: K1's gate refuses h{heads} d{head_dim}")
    if c is None or c[0] != plan.heads:
        failures.append(f"I1: K6's C side plans {c} for {plan}")
    return rep


def _i4_lm_online(torch, eng, served):
    """I4 on one rank: I1's tp-2 bf16 engine behind OnlineEngine. Rank 0
    submits the trace's requests at I4_RATE a second, cancels one right
    after its submit (queued: the scheduler is inside a chunk then) and one
    once its first token has streamed (in flight); every other rank
    follows rank 0's ticks. Rank 0 reports its handles' tokens against the
    engine's own run_pipelined tokens (`served`), time to first token and
    tokens/s; every rank its launches and engine counters."""
    import threading

    import numpy as np

    from gill_tpu_torch.serve.online import OnlineEngine

    torch.cuda.synchronize()
    zero_launches()
    online = OnlineEngine(eng)
    rep = {"leader": online.leader}
    if not online.leader:
        online.wait_closed()
        rep["launches"] = read_launches()
        rep["stats"] = dict(eng.stats)
        return rep
    want = served["tokens"]
    reqs = _i_requests()
    arrivals = np.cumsum(np.random.RandomState(I4_SEED).exponential(
        1 / I4_RATE, size=len(reqs)))
    queued = reqs[len(reqs) // 2].uid
    flight = max(reqs[:4], key=lambda r: r.max_new_tokens).uid
    for r in reqs:
        if r.uid == flight:
            r.max_new_tokens = I4_FLIGHT_BUDGET
    handles, slog = {}, StreamLog()

    def cancel_after_first_token(h):
        while not h.tokens and not h.done.is_set():
            time.sleep(0.002)
        h.cancel()

    t0 = time.perf_counter()
    for r, at in zip(reqs, arrivals):
        delay = t0 + float(at) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t = time.perf_counter()
        handles[r.uid] = h = online.submit(r.prompt, r.max_new_tokens)
        if r.uid == queued:
            h.cancel()
            continue
        slog.watch(r.uid, h, t)
        if r.uid == flight:
            canceller = threading.Thread(target=cancel_after_first_token,
                                         args=(h,), daemon=True)
            canceller.start()
    canceller.join(600)
    got = {u: hh.result(timeout=600) for u, hh in handles.items()}
    rep["wall_s"] = time.perf_counter() - t0
    slog.join(60)
    online.close()
    rep["launches"] = read_launches()
    rep["stats"] = dict(eng.stats)
    ttft, _ = slog.latencies()
    rep["ttft_ms"] = {"p50": 1e3 * pct(ttft, 50), "p99": 1e3 * pct(ttft, 99)}
    rep["tokens_per_s"] = sum(len(v) for v in got.values()) / rep["wall_s"]
    rest = [u for u in got if u not in (queued, flight)]
    rep["uncancelled_equal"] = sum(got[u] == want[u] for u in rest)
    rep["uncancelled"] = len(rest)
    rep["first_divergence"] = {u: first_diff(got[u], want[u]) for u in rest
                               if got[u] != want[u]}
    # the served run's budget was I_BUDGET: compare the common prefix
    for name, u, budget in (("queued", queued, len(want[queued])),
                            ("in_flight", flight, I4_FLIGHT_BUDGET)):
        n = min(len(got[u]), len(want[u]))
        rep[name] = {"uid": u, "tokens": len(got[u]), "budget": budget,
                     "prefix_of_served": got[u][:n] == want[u][:n]}
    return rep


def _i4_gill(torch, lm, cfg, dev, mesh=None):
    """I4's GILL engine on the 8-layer fp32 tree `lm`: the table's last 8
    rows are the [IMG] rows, their embeddings drawn from I_SEED + 2 on the
    card (the same bits on every rank), I4_GILL embedding prompts from
    RandomState(I_SEED), every other one with the [IMG] logit boosted.
    Without `mesh`: GillDecodeEngine.run, the tp-1 reference; with it:
    GillOnlineEngine over GillDecodeEngine(mesh=), rank 0 submitting
    every prompt and every other rank following. Returns {uid: tokens} and
    the [IMG] taps (rank 0, or the reference)."""
    import numpy as np

    from gill_tpu_torch.config import CLIPVisionConfig, GILLConfig
    from gill_tpu_torch.models.gill import GILLCore
    from gill_tpu_torch.serve.gill_engine import (GillDecodeEngine,
                                                  GillServeRequest)
    from gill_tpu_torch.serve.online import GillOnlineEngine

    nt = 8
    core = GILLCore(cfg=GILLConfig(num_tokens=nt), opt_cfg=cfg,
                    vis_cfg=CLIPVisionConfig(hidden_size=32,
                                             intermediate_size=64,
                                             num_layers=1, num_heads=2,
                                             image_size=32, patch_size=16),
                    vocab_len=cfg.vocab_size, img_start=cfg.vocab_size - nt,
                    pad_token_id=1, bos_token_id=2)
    g = torch.Generator(dev).manual_seed(I_SEED + 2)
    img = (torch.randn((nt, cfg.word_embed_proj_dim), device=dev, generator=g)
           * 0.02).to(lm["embed_tokens"]["weight"].device)
    params = {"lm": lm, "adapters": {"img_embeddings": img}}
    rng = np.random.RandomState(I_SEED)
    cases = [dict(embs=(rng.randn(int(rng.randint(16, 120)),
                                  cfg.word_embed_proj_dim) * 0.02)
                  .astype(np.float32), num_words=16,
                  img_scale=100.0 if i % 2 == 0 else 1.0)
             for i in range(I4_GILL)]
    eng = GillDecodeEngine(core, params, slots=8, max_seq=256, chunk=16,
                           prefill_buckets=(64, 128), kv_dtype=torch.float32,
                           mesh=mesh, device=dev if mesh else None)
    rep = {"img_start": core.img_start}
    t0 = time.perf_counter()
    if mesh is None:
        out = eng.run([GillServeRequest(uid=u, **c)
                       for u, c in enumerate(cases)])
        rep["tokens"] = {u: out[u]["tokens"] for u in out}
        rep["img_runs"] = {u: out[u]["img_runs"] for u in out}
    else:
        online = GillOnlineEngine(eng)
        rep["leader"] = online.leader
        if online.leader:
            hs = [online.submit(c["embs"], c["num_words"],
                                img_scale=c["img_scale"]) for c in cases]
            rep["tokens"] = {u: h.result(timeout=600)
                             for u, h in enumerate(hs)}
            rep["img_runs"] = {u: h.img_runs for u, h in enumerate(hs)}
            online.close()
        else:
            online.wait_closed()
        rep["stats"] = dict(eng.stats)
    rep["s"] = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()
    return rep


def i1_rank(workdir: str):
    """One rank of the tp = world group: OPT-6.7B bf16 served over the trace
    with the teacher-forced prefill, then online (I4); then 8 of 32 layers
    in fp32 with a prefix, and a GILL engine on them online (I4); each
    built whole on the host from the seed's draws, the engine moving only
    this rank's shard to the card."""
    import torch

    from gill_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _i_device(torch)
    mesh = create_mesh(1, torch.distributed.get_world_size())
    failures = []
    rep = {"coords": mesh.coords}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cfg = _i_opt(torch, dev, torch.bfloat16, host=True)
    rep["host_tree_s"] = time.perf_counter() - t0
    rep["gates"] = _i_gates(torch, cfg.num_heads // mesh.tp, cfg.head_dim,
                            failures)
    rep["bf16"] = _i_serve(torch, params, cfg, torch.bfloat16, mesh, dev,
                           online=lambda eng, served: _i4_lm_online(
                               torch, eng, served))
    rep["n3"] = n3_collectives(torch, params, cfg, mesh, dev)
    del params
    torch.cuda.empty_cache()
    rep["bf16_max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    params, cfg = _i_opt(torch, dev, torch.float32, I_FP32_LAYERS,
                         I_SEED + 1, host=True)
    rep["fp32"] = _i_serve(torch, params, cfg, torch.float32, mesh, dev)
    rep["i4_gill"] = _i4_gill(torch, params, cfg, dev, mesh)
    del params
    torch.cuda.empty_cache()
    rep["failures"] = failures
    return rep


def i1_nccl_rank(workdir: str):
    """A world of 1 on NCCL through the mesh code path: the fp32 engine's
    tokens (8 of 32 layers), and an NCCL all-gather of them."""
    import torch

    from gill_tpu_torch.parallel import create_mesh
    from gill_tpu_torch.parallel.collectives import all_equal

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _i_device(torch)
    mesh = create_mesh(1, 1)
    params, cfg = _i_opt(torch, dev, torch.float32, I_FP32_LAYERS,
                         I_SEED + 1)
    rep = _i_serve(torch, params, cfg, torch.float32, mesh)
    del params
    flat = torch.tensor([t for u in sorted(rep["tokens"])
                         for t in rep["tokens"][u]], device=dev)
    rep["nccl_all_gather_equal"] = all_equal(flat)
    rep["backend"] = str(torch.distributed.get_backend())
    for k in ("prefix_tokens", "prefix_launches"):
        rep.pop(k, None)
    return rep


def _i_cmp_tokens(got: dict, want: dict) -> dict:
    same = sum(got[u] == want[u] for u in want)
    diffs = {u: first_diff(got[u], want[u]) for u in want
             if got[u] != want[u]}
    first = min(diffs.values()) if diffs else None
    return {"requests_equal": same, "requests": len(want),
            "share_equal": same / len(want), "first_divergence": first}


def _i4_report(ranks, gill1, failures) -> dict:
    """Phase I4's checks and printed figures from the I1 ranks' reports:
    rank 0's uncancelled tokens equal to the engine's run_pipelined ones,
    the cancelled ones prefixes of them (the in-flight one shorter), K1
    and K6 launched on every rank, every follower's engine counters equal
    to rank 0's, and the tp-2 GILL tokens equal to tp 1's."""
    lead = ranks[0]["bf16"]["online"]
    g = ranks[0]["i4_gill"]
    rep = {"ttft_ms": lead["ttft_ms"], "tokens_per_s": lead["tokens_per_s"],
           "wall_s": lead["wall_s"], "uncancelled_equal":
           f"{lead['uncancelled_equal']}/{lead['uncancelled']}",
           "first_divergence": lead["first_divergence"],
           "queued": lead["queued"], "in_flight": lead["in_flight"],
           "k1_launches_per_rank": [r["bf16"]["online"]["launches"][
               "flash_attention"] for r in ranks],
           "k6_launches_per_rank": [r["bf16"]["online"]["launches"][
               "prefix_decode_attention"] for r in ranks],
           "gill_tp2_s": g["s"], "gill_tp1_s": gill1["s"],
           "gill_tokens_equal_tp1": sum(
               g["tokens"][u] == gill1["tokens"][u] for u in gill1["tokens"]),
           "gill_requests": len(gill1["tokens"]),
           "gill_img_runs_max_abs_vs_tp1": max(
               float(abs(g["img_runs"][u] - gill1["img_runs"][u]).max())
               for u in gill1["tokens"]),
           "gill_requests_with_img": sum(
               1 for t in gill1["tokens"].values()
               if any(x >= gill1["img_start"] for x in t))}
    if lead["uncancelled_equal"] != lead["uncancelled"]:
        failures.append(f"I4: online tokens differ from run_pipelined's: "
                        f"{lead['first_divergence']}")
    if not lead["queued"]["prefix_of_served"] or \
            not lead["in_flight"]["prefix_of_served"] or \
            lead["in_flight"]["tokens"] >= lead["in_flight"]["budget"]:
        failures.append(f"I4: cancels {lead['queued']}, "
                        f"{lead['in_flight']}")
    for r, out in enumerate(ranks):
        o = out["bf16"]["online"]
        for k in ("flash_attention", "prefix_decode_attention"):
            if o["launches"][k] <= 0:
                failures.append(f"I4 rank {r}: {k} not launched online")
        for key in ("chunks", "prefills", "decode_steps", "kv_rows_read"):
            if o["stats"][key] != lead["stats"][key]:
                failures.append(f"I4 rank {r}: {key} {o['stats'][key]} "
                                f"against rank 0's {lead['stats'][key]}")
        if out["i4_gill"]["stats"]["chunks"] != g["stats"]["chunks"]:
            failures.append(f"I4 rank {r}: the GILL engine's chunks differ")
    if rep["gill_tokens_equal_tp1"] != rep["gill_requests"]:
        failures.append(f"I4: tp-2 GILL tokens equal tp 1's for only "
                        f"{rep['gill_tokens_equal_tp1']} of "
                        f"{rep['gill_requests']}")
    log("phase I4:", json.dumps(rep, default=str))
    return rep


def phase_i1(torch, dev, tmp, failures):
    from gill_tpu_torch.parallel.launch import run_ranks

    rep = {}
    t0 = time.perf_counter()
    params, cfg = _i_opt(torch, dev, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    ref16 = _i_serve(torch, params, cfg, torch.bfloat16, None)
    rep["tp1_bf16_max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    params, cfg = _i_opt(torch, dev, torch.float32, I_FP32_LAYERS,
                         I_SEED + 1)
    ref32 = _i_serve(torch, params, cfg, torch.float32, None)
    gill1 = _i4_gill(torch, params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    rep["tp1_s"] = time.perf_counter() - t0
    rep["tp1_bf16_tokens_per_s"] = ref16["tokens_per_s"]
    rep["tp1_bf16_ms_a_decode_step"] = ref16["ms_a_decode_step"]
    rep["tp1_fp32_tokens_per_s"] = ref32["tokens_per_s"]

    t0 = time.perf_counter()
    ranks = run_ranks(f"{I_MODULE}:i1_rank", 2, {"workdir": tmp},
                      workdir=os.path.join(tmp, "i1"), timeout=I_GROUP_TIMEOUT,
                      device=I_DEVICE, pg_timeout=I_PG_TIMEOUT,
                      pythonpath=[REPO], threads=4)
    rep["tp2_group_s"] = time.perf_counter() - t0
    per = []
    for r, out in enumerate(ranks):
        failures += [f"rank {r}: {f}" for f in out["failures"]]
        b16, b32 = out["bf16"], out["fp32"]
        a, b = b16["hidden"], ref16["hidden"]
        rel = float((a - b).norm() / b.norm())
        row = {"rank": r, "coords": out["coords"], "gates": out["gates"],
               "kv_heads": b16["kv_heads"],
               "bf16_vs_tp1": _i_cmp_tokens(b16["tokens"], ref16["tokens"]),
               "bf16_hidden_rel": rel,
               "bf16_hidden_max_abs": float((a - b).abs().max()),
               "bf16_tokens_per_s": b16["tokens_per_s"],
               "bf16_ms_a_decode_step": b16["ms_a_decode_step"],
               "fp32_vs_tp1": _i_cmp_tokens(b32["tokens"], ref32["tokens"]),
               "fp32_prefix_vs_tp1": _i_cmp_tokens(b32["prefix_tokens"],
                                                   ref32["prefix_tokens"]),
               "prefix_hits": b32["prefix_hits"],
               "k1_launches": b16["launches"]["flash_attention"],
               "k6_launches": b16["launches"]["prefix_decode_attention"],
               "fp32_k1_launches": b32["launches"]["flash_attention"],
               "fp32_k6_launches": b32["launches"][
                   "prefix_decode_attention"],
               "max_memory_gb": out["bf16_max_memory_gb"],
               "host_tree_s": out["host_tree_s"]}
        per.append(row)
        if rel > I_HIDDEN_RTOL:
            failures.append(f"I1 rank {r}: hidden rel {rel} > "
                            f"{I_HIDDEN_RTOL}")
        if row["fp32_vs_tp1"]["share_equal"] < 1:
            failures.append(f"I1 rank {r}: fp32 tokens differ from tp 1: "
                            f"{row['fp32_vs_tp1']}")
        if row["fp32_prefix_vs_tp1"]["share_equal"] < 1 or \
                b32["prefix_hits"] != I_REQS:
            failures.append(f"I1 rank {r}: prefix run "
                            f"{row['fp32_prefix_vs_tp1']}, hits "
                            f"{b32['prefix_hits']}")
        # K6 takes bf16 caches only (decode_attn.supported): the fp32 run
        # decodes on the plain path
        for k in ("k1_launches", "k6_launches", "fp32_k1_launches"):
            if row[k] <= 0:
                failures.append(f"I1 rank {r}: {k} = 0")
        if b16["kv_heads"] != 16:
            failures.append(f"I1 rank {r}: pool heads {b16['kv_heads']}")
        # a rank holds its shard, not the tree
        if row["max_memory_gb"] >= rep["tp1_bf16_max_memory_gb"]:
            failures.append(f"I1 rank {r}: peak {row['max_memory_gb']} GB "
                            f"against tp 1's "
                            f"{rep['tp1_bf16_max_memory_gb']} GB")
    if ranks[0]["bf16"]["tokens"] != ranks[1]["bf16"]["tokens"]:
        failures.append("I1: the two tp ranks' tokens differ")
    rep["tp2"] = per
    rep["i4"] = _i4_report(ranks, gill1, failures)
    rep["n3"] = _n3_report(ranks, failures)
    rep["tp2_vs_tp1_tokens_per_s"] = (per[0]["bf16_tokens_per_s"]
                                      / ref16["tokens_per_s"])

    t0 = time.perf_counter()
    (nccl,) = run_ranks(f"{I_MODULE}:i1_nccl_rank", 1, {"workdir": tmp},
                        workdir=os.path.join(tmp, "i1n"),
                        timeout=I_GROUP_TIMEOUT, device=I_DEVICE,
                        pg_timeout=I_PG_TIMEOUT, pythonpath=[REPO],
                        threads=4)
    rep["nccl_world1"] = {
        "backend": nccl["backend"], "s": time.perf_counter() - t0,
        "all_gather_equal": nccl["nccl_all_gather_equal"],
        "vs_plain": _i_cmp_tokens(nccl["tokens"], ref32["tokens"]),
        "k1_launches": nccl["launches"]["flash_attention"]}
    if "nccl" not in nccl["backend"] or \
            rep["nccl_world1"]["vs_plain"]["share_equal"] < 1 or \
            not nccl["nccl_all_gather_equal"]:
        failures.append(f"I1 NCCL world 1: {rep['nccl_world1']}")
    return rep


def _i_train_setup(torch, dev, root, tok_dir, mesh, dtype=None,
                   layers=None):
    """Phase H's model at full width (OPT-6.7B + ViT-L/14 frozen in `dtype`,
    default bf16, `layers` of OPT's 32; fp32 adapters; the OPT-sized
    tokenizer) from seed 0, and the global batch's first I_BATCH
    examples."""
    import dataclasses

    from gill_tpu_torch.config import GILLConfig, TrainConfig
    from gill_tpu_torch.models.gill import GILLCore
    from gill_tpu_torch.nn.core import Init
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer, setup_gill_tokenizer
    from gill_tpu_torch.weights import loader as wloader

    tok = GPT2BPETokenizer.from_pretrained_dir(tok_dir)
    ids = setup_gill_tokenizer(tok, 8)
    cfg = GILLConfig(retrieval_token_idx=tuple(ids), gen_token_idx=tuple(ids))
    core = GILLCore.build(cfg, vocab_len=len(tok), img_start=ids[0],
                          pad_token_id=tok.pad_token_id,
                          bos_token_id=tok.bos_token_id, mesh=mesh)
    if layers is not None:
        core = dataclasses.replace(core, opt_cfg=dataclasses.replace(
            core.opt_cfg, num_layers=layers))
    dtype = dtype or torch.bfloat16
    frozen = {"lm": wloader.load_opt(cfg.opt_version, core.opt_cfg, len(tok),
                                     None, 0, device=dev, dtype=dtype),
              "vision": wloader.load_clip_vision(
                  cfg.visual_encoder, core.vis_cfg, None, 1, device=dev,
                  dtype=dtype)}
    adapters = core.init_adapters(Init(torch.Generator(dev).manual_seed(0),
                                       dev, torch.float32))
    tc = TrainConfig(batch_size=I_BATCH, lr=1e-3, lr_warmup_steps=0,
                     steps_per_epoch=100)
    batch = _h_batch(torch, dev, root, core, I_BATCH)
    batch["pixels"] = batch["pixels"].to(dtype)
    return core, frozen, adapters, tc, batch


def _i_step(torch, core, frozen, adapters, tc, batch):
    """One train step; returns (loss, the summed adapter gradients, the
    adapters after the update, launches)."""
    from gill_tpu_torch.train import trainer as trainer_mod

    seen = {}
    orig = trainer_mod.sum_over_data

    def capture(grads, mesh):
        out = orig(grads, mesh)
        seen["grads"] = [g.detach().clone() for g in out]
        return out

    trainer_mod.sum_over_data = capture
    try:
        state = trainer_mod.init_state(tc, adapters)
        step = trainer_mod.make_train_step(core, tc)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        state, m = step(state, frozen, batch)
        loss = float(m["loss"])
        s = time.perf_counter() - t0
    finally:
        trainer_mod.sum_over_data = orig
    return loss, seen["grads"], state.adapters, read_launches(), s


def _i_digest(torch, tree) -> str:
    import hashlib

    from gill_tpu_torch.nn.core import tree_leaves

    h = hashlib.sha1()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _i_index(torch, dev, mesh):
    """The main path's 2.9M x 256 index (build_model's seed), top-3 of four
    queries with seen ids. In one process also the median ms of
    `topk_batch` (its 65,536-row products) and of the one product over
    every row that scored a query before (the same seen-id penalty and
    top-3, as numpy), timed alike."""
    from gill_tpu_torch.retrieval import RetrievalIndex

    n = I_INDEX_ROWS
    g = torch.Generator(dev).manual_seed(7)
    emb = torch.randn(n, 256, device=dev, generator=g)
    idx = RetrievalIndex([str(i) for i in range(n)], emb, 14.285, device=dev,
                         mesh=mesh)
    del emb
    q = torch.randn(4, 256, device=dev,
                    generator=torch.Generator(dev).manual_seed(8))
    seen = [[0, n - 1], [], [n // 2], [17, 17]]
    vals, ids = idx.topk_batch(q, 3, seen)
    info = {"rows": idx.rows}
    if mesh is None:
        def one_product():
            s = q @ idx.matrix.t()
            for i, sn in enumerate(seen):
                if sn:
                    s[i].index_add_(0, torch.as_tensor(sn, device=dev),
                                    torch.full((len(sn),), -1000.0,
                                               device=dev))
            v, i = torch.topk(s, 3, dim=-1)
            return v.cpu().numpy(), i.cpu().numpy()

        for name, fn in (("topk_batch", lambda: idx.topk_batch(q, 3, seen)),
                         ("one_product", one_product)):
            ms = []
            for _ in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                ms.append(1e3 * (time.perf_counter() - t0))
            info[name + "_ms"] = sorted(ms[1:])[len(ms[1:]) // 2]
        info["one_product_ids_equal"] = bool(
            (one_product()[1] == ids).all())
    del idx
    torch.cuda.empty_cache()
    return vals, ids, info


def _i_rank_step(torch, dev, workdir, mesh, ref_name, dtype=None,
                 layers=None):
    """This rank's step at `mesh` on its rows of the global batch, against
    the one-process gradients saved as `ref_name` in `workdir`."""
    from gill_tpu_torch.parallel.partition import shard_params, split_batch

    torch.cuda.reset_peak_memory_stats()
    core, frozen, adapters, tc, batch = _i_train_setup(
        torch, dev, os.path.join(workdir, "data"),
        os.path.join(workdir, "tokenizer"), mesh, dtype, layers)
    if mesh.tp > 1:
        frozen = shard_params(frozen, mesh)
    local = split_batch(batch, mesh)
    loss, grads, after, launches, s = _i_step(torch, core, frozen, adapters,
                                              tc, local)
    ref = torch.load(os.path.join(workdir, ref_name))
    names = _leaf_paths(adapters)
    # the key projections' biases add one constant to every score of a
    # query, which the softmax removes: their gradients are 0 in exact
    # arithmetic and rounding noise on the card, so they are left out of
    # the cosines (their norm against the largest leaf's is reported)
    keep = [i for i, n in enumerate(names) if not n.endswith("/k/b")]
    want = [ref["grads"][i].to(dev) for i in keep]
    agree = _grad_agreement(torch, [grads[i] for i in keep], want,
                            [names[i] for i in keep])
    top = max(float(g.norm()) for g in want)
    agree["k_bias_norm_share"] = max(
        [float(grads[i].norm()) / top for i in range(len(names))
         if i not in keep] or [0.0])
    rep = {"coords": mesh.coords, "loss": loss, "ref_loss": ref["loss"],
           "step_s": s, "grads": agree, "digest": _i_digest(torch, after),
           "launches": launches, "rows": int(local["pixels"].shape[0]),
           "valid_tokens": int(local["ret_len"].sum()),
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del core, frozen, adapters, after, grads, batch, local
    torch.cuda.empty_cache()
    return rep


def i2_rank(workdir: str, dp: int, tp: int):
    """One rank of I2: the bf16 step at mesh (dp, tp); at dp 2 also the fp32
    control and the sharded index."""
    import torch

    from gill_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _i_device(torch)
    mesh = create_mesh(dp, tp)
    rep = _i_rank_step(torch, dev, workdir, mesh, "i2_ref.pt")
    if dp == 2:
        rep["control"] = _i_rank_step(torch, dev, workdir, mesh,
                                      "i2_ref32.pt", torch.float32,
                                      I_CONTROL_LAYERS)
        vals, ids, info = _i_index(torch, dev, mesh)
        rep["index"] = {"vals": vals, "ids": ids, "rows": info["rows"]}
    return rep


def _i_reference(torch, dev, tmp, name, dtype=None, layers=None):
    """The one-process step on the whole global batch; saves its loss and
    gradients as `name` for the ranks. Returns (report, digest, batch
    valid-token counts of the two halves)."""
    torch.cuda.reset_peak_memory_stats()
    core, frozen, adapters, tc, batch = _i_train_setup(
        torch, dev, os.path.join(tmp, "data"),
        os.path.join(tmp, "tokenizer"), None, dtype, layers)
    loss, grads, after, launches, s = _i_step(torch, core, frozen, adapters,
                                              tc, batch)
    torch.save({"loss": loss, "grads": [g.cpu() for g in grads]},
               os.path.join(tmp, name))
    lens = batch["ret_len"]
    half = I_BATCH // 2
    rep = {"loss": loss, "step_s": s, "launches": launches,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    digest = _i_digest(torch, after)
    halves = [int(lens[:half].sum()), int(lens[half:].sum())]
    del core, frozen, adapters, after, grads, batch
    torch.cuda.empty_cache()
    return rep, digest, halves


def _i_step_row(r, out, cos_limit, norm_limit, key, failures):
    rel = abs(out["loss"] - out["ref_loss"]) / abs(out["ref_loss"])
    row = {"rank": r, "coords": out["coords"], "loss": out["loss"],
           "loss_rel": rel, "grad_min_cos": out["grads"]["min_cos"],
           "grad_min_cos_leaf": out["grads"]["min_cos_leaf"],
           "grad_max_norm_rel": out["grads"]["max_norm_rel"],
           "grad_max_norm_rel_leaf": out["grads"]["max_norm_rel_leaf"],
           "k_bias_norm_share": out["grads"]["k_bias_norm_share"],
           "step_s": out["step_s"], "rows": out["rows"],
           "valid_tokens": out["valid_tokens"],
           "k2_launches": out["launches"]["flash_mma"],
           "k1_launches": out["launches"]["flash_attention"],
           "k4_launches": out["launches"]["w8_matmul"],
           "max_memory_gb": out["max_memory_gb"]}
    if rel > I_LOSS_RTOL:
        failures.append(f"I2 {key} rank {r}: loss rel {rel}")
    if row["grad_min_cos"] < cos_limit:
        failures.append(f"I2 {key} rank {r}: gradient cosine "
                        f"{row['grad_min_cos']} at "
                        f"{row['grad_min_cos_leaf']}")
    if row["grad_max_norm_rel"] > norm_limit:
        failures.append(f"I2 {key} rank {r}: gradient norm rel "
                        f"{row['grad_max_norm_rel']} at "
                        f"{out['grads']['max_norm_rel_leaf']}")
    return row


def phase_i2(torch, dev, tmp, failures):
    from gill_tpu_torch.data.dataset import make_stub_dataset
    from gill_tpu_torch.parallel.launch import run_ranks

    rep = {}
    root = os.path.join(tmp, "data")
    make_stub_dataset(root, n=2 * I_BATCH, image_size=224,
                      num_clip_tokens=77, gen_emb_dim=768, split="train")
    make_stub_dataset(root, n=I_BATCH, image_size=224, num_clip_tokens=77,
                      gen_emb_dim=768, split="val")
    write_opt_sized_tokenizer(os.path.join(tmp, "tokenizer"))
    t0 = time.perf_counter()
    rep["one_process"], digest, rep["valid_tokens_halves"] = _i_reference(
        torch, dev, tmp, "i2_ref.pt")
    rep["one_process_fp32_control"], _, _ = _i_reference(
        torch, dev, tmp, "i2_ref32.pt", torch.float32, I_CONTROL_LAYERS)
    ref_vals, ref_ids, rep["one_process_index"] = _i_index(torch, dev, None)
    rep["one_process_s"] = time.perf_counter() - t0

    for dp, tp in ((2, 1), (1, 2)):
        t0 = time.perf_counter()
        ranks = run_ranks(f"{I_MODULE}:i2_rank", dp * tp,
                          {"workdir": tmp, "dp": dp, "tp": tp},
                          workdir=os.path.join(tmp, f"i2_{dp}{tp}"),
                          timeout=I_GROUP_TIMEOUT, device=I_DEVICE,
                          pg_timeout=I_PG_TIMEOUT, pythonpath=[REPO],
                          threads=4)
        key = f"dp{dp}_tp{tp}"
        rows = []
        for r, out in enumerate(ranks):
            row = _i_step_row(r, out, I_GRAD_COS, I_GRAD_NORM_REL, key,
                              failures)
            row["adapters_equal_one_process"] = out["digest"] == digest
            if "control" in out:
                row["fp32_control"] = _i_step_row(
                    r, out["control"], I_GRAD_COS_FP32, I_GRAD_NORM_REL_FP32,
                    key + " fp32", failures)
            if "index" in out:
                ix = out["index"]
                row["index_rows"] = ix["rows"]
                row["index_ids_equal"] = bool((ix["ids"] == ref_ids).all())
                row["index_scores_equal"] = bool(
                    (ix["vals"] == ref_vals).all())
                row["index_max_abs"] = float(abs(ix["vals"] - ref_vals)
                                             .max())
                if not (row["index_ids_equal"] and
                        row["index_scores_equal"]):
                    failures.append(f"I2 {key} rank {r}: index {row}")
            rows.append(row)
            if row["k2_launches"] <= 0 or row["k1_launches"] or \
                    row["k4_launches"]:
                failures.append(f"I2 {key} rank {r}: launches "
                                f"{out['launches']}")
        digests = {out["digest"] for out in ranks}
        if len(digests) != 1 or len({out["control"]["digest"] for out in
                                     ranks if "control" in out}) > 1:
            failures.append(f"I2 {key}: adapters differ across ranks")
        rep[key] = {"ranks": rows, "group_s": time.perf_counter() - t0,
                    "adapters_equal_across_ranks": len(digests) == 1}
    if rep["dp2_tp1"]["ranks"][0]["valid_tokens"] == \
            rep["dp2_tp1"]["ranks"][1]["valid_tokens"]:
        failures.append("I2: the dp ranks hold equal valid-token counts")
    return rep


def _i_torchrun(torch, argv, log_dir, timeout):
    """`python -m torch.distributed.run --standalone --nproc-per-node 2`
    of the port's CLI; each rank's stdout from its own log file."""
    import glob
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "--log-dir", log_dir, "--redirects", "3",
           "-m", "gill_tpu_torch.main", *argv]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="4")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    try:
        tail, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise TimeoutError(f"torch.distributed.run did not end in {timeout} "
                           "s")
    outs = []
    for r in (0, 1):
        files = sorted(glob.glob(os.path.join(log_dir, "**", str(r),
                                              "stdout.log"), recursive=True))
        outs.append(open(files[-1]).read() if files else "")
    return proc.returncode, tail.decode(errors="replace")[-3000:], outs, \
        time.perf_counter() - t0


def _i_stderr(log_dir: str) -> str:
    import glob

    return "".join(f"\n--- {p} ---\n" + open(p).read()[-2000:] for p in
                   sorted(glob.glob(os.path.join(log_dir, "**", "stderr.log"),
                                    recursive=True)))


def _i_losses(text: str) -> list:
    """The `loss <val>` of every train meter line."""
    import re

    return [m.group(1) for line in text.splitlines()
            if line.startswith("Epoch: [")
            for m in [re.search(r"\bloss ([-+.eE0-9naif]+)", line)] if m]


def phase_i3(torch, tmp, failures):
    """The CLI on two ranks through torch.distributed.run at phase H's
    width: two steps, validations, `orbax_2/`, then a one-step resume."""
    import numpy as np

    from gill_tpu_torch.nn.core import tree_leaves
    from gill_tpu_torch.utils import ckpt as ckpt_utils

    rep = {}
    root, runs = os.path.join(tmp, "data"), os.path.join(tmp, "runs")
    base = ["--batch-size", str(I_BATCH), "--val-batch-size", str(I_BATCH),
            "--val-steps-per-epoch", "1", "--seed", "0", "--precision",
            "bf16", "--lr-warmup-steps", "2", "--print-freq", "1",
            "--workers", "4", "--dataset-dir", os.path.join(root, "datasets"),
            "--image-dir", root, "--log-base-dir", runs, "--tokenizer-dir",
            os.path.join(tmp, "tokenizer"), "--dp-size", "2",
            "--ckpt-backend", "orbax", "--device", I_DEVICE, *I_CLI_EXTRA]
    first = base + ["--exp-name", "i3", "--epochs", "1",
                    "--steps-per-epoch", "2"]
    rc, tail, outs, s = _i_torchrun(torch, first, os.path.join(tmp, "l1"),
                                    I_GROUP_TIMEOUT)
    rep["run_s"] = s
    losses = [_i_losses(o) for o in outs]
    rep["losses"] = losses
    if rc != 0:
        failures.append(f"I3: the two-rank run exited {rc}: {tail}"
                        + _i_stderr(os.path.join(tmp, "l1")))
        return rep
    if len(losses[0]) != 2 or losses[0] != losses[1] or not all(
            math.isfinite(float(x)) for x in losses[0]):
        failures.append(f"I3: losses {losses}")
    log_dir = os.path.join(runs, "i3")
    events = [f for f in os.listdir(log_dir)
              if f.startswith("events.out.tfevents.")]
    rep["tb_event_files"] = len(events)
    rep["run_dirs"] = sorted(os.listdir(runs))
    if len(events) != 1 or rep["run_dirs"] != ["i3"]:
        failures.append(f"I3: TB files {events}, run dirs {rep['run_dirs']}")
    saved, meta = ckpt_utils.load_checkpoint_orbax(log_dir)
    rep["meta"] = meta
    # the restore path against torch.distributed.checkpoint's own reader
    from torch.distributed.checkpoint.format_utils import dcp_to_torch_save

    conv = os.path.join(tmp, "orbax_2.pt")
    dcp_to_torch_save(os.path.join(log_dir, "orbax_2"), conv)
    raw = torch.load(conv)
    flat = ckpt_utils._flatten(saved)
    rep["leaves"] = len(flat)
    mism = [k for k in raw if k not in flat or not np.array_equal(
        np.asarray(raw[k]), flat[k])]
    rep["restore_mismatches"] = len(mism) + len(set(flat) - set(raw))
    if meta.get("step") != 2 or rep["restore_mismatches"]:
        failures.append(f"I3: orbax_2 meta {meta}, {mism[:3]}")
    resume = base + ["--exp-name", "i3r", "--epochs", "2",
                     "--steps-per-epoch", "1", "--resume", log_dir]
    rc, tail, outs, s = _i_torchrun(torch, resume, os.path.join(tmp, "l2"),
                                    I_GROUP_TIMEOUT)
    rep["resume_s"] = s
    rep["resume_losses"] = [_i_losses(o) for o in outs]
    resumed = [("Resumed from" in o) for o in outs]
    rep["resumed_on_both"] = all(resumed)
    if rc != 0 or not all(resumed) or \
            rep["resume_losses"][0] != rep["resume_losses"][1] or \
            len(rep["resume_losses"][0]) != 1:
        failures.append(f"I3: resume exited {rc}, {rep['resume_losses']}, "
                        f"{resumed}: {tail}"
                        + _i_stderr(os.path.join(tmp, "l2")))
        return rep
    after, meta2 = ckpt_utils.load_checkpoint_orbax(
        os.path.join(runs, "i3r"))
    rep["resume_meta"] = meta2
    moved = sum(not np.array_equal(a, b) for a, b in zip(
        tree_leaves(after["adapters"]), tree_leaves(saved["adapters"])))
    rep["resume_adapter_leaves_moved"] = moved
    if meta2.get("step") != 3 or not moved:
        failures.append(f"I3: resumed meta {meta2}, moved {moved}")
    return rep


def _phase_i_launches(rep: dict, name: str):
    """A kernel's launches on each rank of phase I's groups: K1 and K6 in
    I1's tp-2 bf16 serving, K2 in I2's dp-2 step; None for the others."""
    key = {"flash_attention": ("i1", "k1_launches"),
           "prefix_decode_attention": ("i1", "k6_launches"),
           "flash_mma": ("i2", "k2_launches")}.get(name)
    if key is None:
        return None
    sub = rep.get(key[0], {})
    ranks = sub.get("tp2") if key[0] == "i1" else \
        sub.get("dp2_tp1", {}).get("ranks")
    return [r[key[1]] for r in ranks] if ranks else None


def phase_i(torch, dev):
    """The distributed layer (slice 14) after every earlier model is freed;
    ranks share cuda:0 over gloo (NCCL for the world of 1). Returns
    (report, failures)."""
    failures = []
    rep = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("i1", lambda: phase_i1(torch, dev, tmp, failures)),
                         ("i2", lambda: phase_i2(torch, dev, tmp, failures)),
                         ("i3", lambda: phase_i3(torch, tmp, failures))):
            t1 = time.perf_counter()
            try:
                rep[name] = fn()
            except Exception as e:  # a failed or hung group fails the phase
                failures.append(f"phase I {name}: {type(e).__name__}: "
                                f"{str(e)[-4000:]}")
                rep[name] = {"error": type(e).__name__}
            rep[name + "_s"] = time.perf_counter() - t1
            torch.cuda.empty_cache()
            log(f"phase I {name}:", json.dumps(rep[name], default=str))
    rep["device"] = smi_line()
    rep["phase_s"] = time.perf_counter() - t0
    return rep, failures


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
    # serving phases A (the W8 engine on bench_serve's trace) and B (the
    # batch GILL API), each tree's own
    from gill_tpu_torch.api import GILL
    w8_model = GILL(model.core, model.params, model.tokenizer, device=dev,
                    sd_pipe=model.sd_pipe, retrieval_index=model.index,
                    decision_params=model.decision_params,
                    lm_weight_precision="w8")
    ra = cs.phase_a(torch, w8_model.params["lm"], model.core.opt_cfg, fails)
    ra = ra[0] if isinstance(ra, tuple) else ra
    torch.cuda.empty_cache()
    rb = cs.phase_b(torch, w8_model, cs.dialogue_prompt(256, model.tokenizer),
                    fails)
    serving = {"A": {k: ra.get(k) for k in (
                   "wall_s", "tokens_per_s", "warmup_s",
                   "device_ms_per_step", "w8_share_of_device_busy",
                   "k6_share_of_device_busy",
                   "device_share_of_unprofiled_step", "stats")},
               "B": {k: v for k, v in rb.items() if k.endswith("_s")}}
ph = rep["phases"]
print("AB " + json.dumps({
    "request_a_s": rep["request_a_s"], "request_b_s": rep["request_b_s"],
    **{k + "_ms": ph[k]["mean_ms"] for k in ("unet_step", "opt_decode_token",
                                              "clip_vision", "vae_decode")},
    "unet_call_ms_min": min(unet_ms), "unet_call_ms_mean": sum(unet_ms) / 10,
    "unet_profiled": prof, "host_cpu_op_us": host_op_us,
    "host_python_ms": host_py_ms, "w8_matmul": w8_ms, "serving": serving,
    "failures": fails,
    "ptxas_if_built_here": {n: [ln.split(":", 1)[-1].strip() for ln in
                                txt.splitlines() if "registers" in ln]
                            for n, txt in _build.BUILD_LOG.items()}}))
"""


# one timing of a tree's own K6 and S1 at this script's shapes and inputs,
# in a fresh process (argv[1]: its root, argv[2]: this script, whose
# tree's scripts/_timing.py times both trees, argv[3]: the calls)
_ABK_CHILD = """
import importlib.util, json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
from gill_tpu_torch.ops import _build, decode_attn, mm_probe
from gill_tpu_torch.scripts import attn_mxu_probe
spec = importlib.util.spec_from_file_location("timing_ab", os.path.join(
    os.path.dirname(sys.argv[2]), "gill_tpu_torch", "scripts", "_timing.py"))
me = importlib.util.module_from_spec(spec)
spec.loader.exec_module(me)
_build.build_all(("decode_attn", "mm_probe"))
dev = torch.device("cuda", 0)
calls = json.loads(sys.argv[3])
k6 = {}
for site, b, s, h, d, lens in calls["k6"]:
    g = torch.Generator(dev).manual_seed(b * s)
    pool = torch.randn(2, b, max(512, s), h, d, device=dev,
                       generator=g).bfloat16()
    q, k1, v1 = (torch.randn(b, 1, h, d, device=dev, generator=g).bfloat16()
                 for _ in range(3))
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    pools = [pool] + [pool.clone() for _ in range(me.cold_copies(
        pool.numel() * 2) - 1)]
    fns = [lambda p=p: decode_attn.prefix_decode_attention(
        q, p[0, :, :s], p[1, :, :s], ln, k1, v1, scale=d ** -0.5)
        for p in pools]
    k6[site] = {"ms": me.cuda_ms(fns[0], 50),
                "ms_cold": me.cuda_ms_cycled(fns, 48)}
    del pools, pool
s1 = {}
for case, m, kk, n, dt in calls["s1"]:
    a, bb = attn_mxu_probe.operands(m, kk, n, dt, dev)
    s1[case.split()[0]] = me.cuda_ms(lambda: mm_probe.mm_probe(a, bb), 20)
print("ABK " + json.dumps({"k6": k6, "s1_ms": s1}))
"""


def ab_kernels(other: str, rounds: int, order: str = "otto") -> int:
    """K6 at every DECODE_SHAPES row (a parked row, a full one, rows on
    this tree's split boundaries, the rest seeded) and S1 at its seven
    cases, each tree's own kernels in turns, each run in a fresh process
    on the same inputs."""
    import numpy as np
    import torch

    from gill_tpu_torch.ops.decode_attn import decode_plan
    from gill_tpu_torch.scripts import attn_mxu_probe

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "available")
    other = os.path.abspath(other)
    log(f"device: {smi_line()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k6 = []
    h, d = 32, 128
    for b, s in DECODE_SHAPES:
        lens = np.random.RandomState(b * s).randint(0, s + 1, b)
        plan = decode_plan(b, s, h, d, sms)
        lens[0], lens[1], lens[2], lens[-1] = \
            0, plan.rows, (plan.splits - 1) * plan.rows, s
        n_rows = int(lens.sum())
        bms, _ = bound(n_rows * h * d * 2 * 2 + 4 * b * h * d * 2 + 4 * b,
                       4.0 * n_rows * h * d, "fp32")
        k6.append((f"b{b}_s{s}", b, s, h, d, lens.tolist()))
        log("ABK", json.dumps({"k6_site": f"b{b}_s{s}", "rows":
                               lens.tolist(), "bound_ms": bms,
                               "plan": plan._asdict()}))
    calls = json.dumps({"k6": k6, "s1": attn_mxu_probe.CASES})
    for i in range(rounds):
        for name, root in [{"o": ("other", other), "t": ("this", REPO)}[c]
                           for c in order]:
            run = subprocess.run([sys.executable, "-c", _ABK_CHILD, root,
                                  os.path.abspath(__file__), calls],
                                 cwd=root, capture_output=True, text=True)
            line = [ln for ln in run.stdout.splitlines()
                    if ln.startswith("ABK ")]
            if run.returncode != 0 or not line:
                log(run.stdout[-2000:], run.stderr[-4000:])
                raise RuntimeError(f"kernels of {root} failed "
                                   f"(rc {run.returncode})")
            log("ABK", json.dumps({"round": i, "tree": name, "root": root,
                                   **json.loads(line[0][4:])}))
    log(smi_line())
    return 0


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
        torch.cuda.empty_cache()
        g_report, g_failures = phase_g(torch, dev, model)
        failures += g_failures
        log("weights phase G:", json.dumps(g_report))
        torch.cuda.empty_cache()
        j_report, j_failures = phase_j(torch, dev, model)
        failures += j_failures
        log("apps phase J:", json.dumps({"phase_s": j_report["phase_s"],
                                         "failures": len(j_failures)}))
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        e_rows, e_report, e_failures = phase_e(torch, dev)
        e_report["wall_s"] = time.perf_counter() - t0
        rows += e_rows
        failures += e_failures
        log("probe phase E:", json.dumps(e_report))
    torch.cuda.empty_cache()
    h_report, h_failures = phase_h(torch, dev)
    failures += h_failures
    log("training phase H:", json.dumps(h_report))
    log("apps phase J7 prune:", json.dumps(h_report["h1"].get("j7_prune")))
    torch.cuda.empty_cache()
    n_report, n_failures = phase_n(torch, dev)
    failures += n_failures
    log("native and tools phase N:", json.dumps(
        {"n1_s": n_report["n1"]["phase_s"], "n2_s": n_report["n2"]["phase_s"],
         "failures": len(n_failures)}))
    torch.cuda.empty_cache()
    i_report, i_failures = phase_i(torch, dev)
    failures += i_failures
    log("distributed phase I:", json.dumps(i_report, default=str))
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
        # each rank's launches in phase I (I1 at tp 2: K1, K6; I2: K2)
        per_rank = _phase_i_launches(i_report, name)
        if per_rank is not None:
            row["phase_i_launches_per_rank"] = per_rank
        # the serving probes (P), phase E's probes (the block probes: K2),
        # and each rank's in phase I4's online tp-2 serving (K1, K6)
        row["serving_probe_launches"] = serve_report["P"]["launches"][name]
        row["phase_e_launches"] = e_report["launches"][name]
        # phase N2 (K4, K6) and each rank's N3 decode step (K6)
        row["phase_n2_launches"] = n_report["n2"]["launches"][name]
        row["phase_n3_launches_per_rank"] = [
            r[name] for r in i_report.get("i1", {}).get("n3", {}).get(
                "launches_per_rank", [])]
        i4 = i_report.get("i1", {}).get("i4", {})
        key = {"flash_attention": "k1_launches_per_rank",
               "prefix_decode_attention": "k6_launches_per_rank"}.get(name)
        if key in i4:
            row["phase_i4_launches_per_rank"] = i4[key]
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
    for flag, fn in (("--ab-main-path", ab_main_path),
                     ("--ab-kernels", ab_kernels)):
        if sys.argv[1:2] == [flag]:
            sys.exit(fn(sys.argv[2], *[f(a) for f, a in zip(
                (int, str), sys.argv[3:5])]))
    sys.exit(main())
