"""One-command real-weight validation of the port (counterpart of
scripts/validate_real_weights.py).

    python -m gill_tpu_torch.scripts.validate_real_weights \
        [--weights-dir DIR] [--tokenizer-dir DIR] [--sd-dir DIR] \
        [--lpips-weights NPZ] [--cc3m-tsv TSV] [--opt-name N] \
        [--draft-name N] [--clip-name N] [--only a,b] [--device cpu] \
        [--out REAL_WEIGHTS_REPORT.json]

Detects which assets are present and runs every check it can against the
port's loaders, writing a JSON report with an explicit SKIPPED reason for
the rest (the same report, check names and exit code as
scripts/validate_real_weights.py):
  tokenizer  the port's BPE vs transformers.GPT2Tokenizer on the real
             vocab.json / merges.txt, and the [IMG] ids appended after it
  opt        the port's OPT forward (logits, last hidden) vs
             transformers.OPTForCausalLM on the local weights (fp32)
  clip       the port's CLIP vision pooler vs transformers.CLIPVisionModel
  sd         the UNet / VAE converters (full key coverage) and a
             fixed-latent forward; a golden against diffusers when it is
             importable
  clip_sim   the CLIP-similarity scorer (evals/compute_clip_similarity.py)
             on real weights: an image against itself ~1, distinct < 0.99
  lpips      the LPIPS scorer (evals/lpips_2dirs.py): identical ~0,
             noised above it
  specdec    speculative decoding's acceptance on CC3M captions with real
             draft and target OPT weights (serve/speculative.py)
The port's models run on --device (default the card); the transformers
and diffusers references on the CPU. Exit status 0 when nothing FAILED
(skips are fine), 1 otherwise.
"""

import argparse
import glob
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from gill_tpu_torch.utils.cli import add_device_arg, resolve_device

# strings with known-tricky BPE behavior (contractions, unicode, spacing)
PARITY_STRINGS = [
    "Hello world", " leading space", "trailing space ",
    "don't stop believin'", "naïve café — résumé",
    "a photo of a cat sitting on a mat.",
    "CamelCase snake_case kebab-case", "123 456.789 -3e8",
    "line\nbreaks\nand\ttabs", "emoji 🙂 and 中文 mixed",
    "[IMG0] not a real special token here", "''\"quotes\"''",
    "  double  spaces  ", "ends with don't",
]


def _skip(reason):
    return {"status": "SKIPPED", "reason": reason}


def _find_dir_with(filenames, roots):
    for root in roots:
        if not root or not os.path.isdir(root):
            continue
        for d in [root] + sorted(glob.glob(os.path.join(root, "*"))):
            if all(os.path.exists(os.path.join(d, f)) for f in filenames):
                return d
    return None


def _pick_opt(weights_dir, preferred=None, exclude=None):
    """Smallest locally-present OPT preset (or `preferred` if present)."""
    from gill_tpu_torch.config import OPT_PRESETS
    from gill_tpu_torch.weights.loader import _model_dir

    names = [n for n in OPT_PRESETS if n.startswith("facebook/")]
    names.sort(key=lambda n: OPT_PRESETS[n]["hidden_size"])
    if preferred:
        names = [preferred] + [n for n in names if n != preferred]
    for n in names:
        if exclude and n == exclude:
            continue
        d = _model_dir(n, weights_dir)
        if d is not None:
            return n, d
    return None, None


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def check_tokenizer(args):
    roots = [args.tokenizer_dir, os.environ.get("GILL_TPU_TOKENIZER_DIR"),
             args.weights_dir, os.environ.get("GILL_TPU_WEIGHTS_DIR")]
    d = _find_dir_with(["vocab.json", "merges.txt"], roots)
    if d is None:
        return _skip("no vocab.json/merges.txt under any of: "
                     + ", ".join(str(r) for r in roots if r))
    try:
        from transformers import GPT2Tokenizer
    except Exception as e:
        return _skip(f"transformers unavailable ({e})")
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer, \
        setup_gill_tokenizer

    hf = GPT2Tokenizer(vocab_file=os.path.join(d, "vocab.json"),
                       merges_file=os.path.join(d, "merges.txt"))
    ours = GPT2BPETokenizer.from_files(
        os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"),
        bos_token="<|endoftext|>", eos_token="<|endoftext|>",
        unk_token="<|endoftext|>", pad_token=None)
    strings = list(PARITY_STRINGS)
    if args.cc3m_tsv and os.path.exists(args.cc3m_tsv):
        with open(args.cc3m_tsv) as f:
            for i, line in enumerate(f):
                if i >= args.n_captions:
                    break
                cap = line.split("\t")[0].strip()
                if cap and cap.lower() != "caption":
                    strings.append(cap)
    mismatches = []
    for s in strings:
        a = ours.encode(s, add_special_tokens=False)
        b = hf.encode(s)
        if a != b:
            mismatches.append({"text": s, "ours": a, "hf": b})
    # the [IMG] ids follow the real vocab (after the <|image|> cls token)
    n0 = len(ours)
    img_ids = setup_gill_tokenizer(ours, 8)
    ok_img = (img_ids == list(range(img_ids[0], img_ids[0] + 8))
              and img_ids[0] >= n0
              and ours.encode("[IMG0]", add_special_tokens=False)
              == [img_ids[0]])
    if mismatches or not ok_img:
        return {"status": "FAIL", "vocab_dir": d,
                "mismatches": mismatches[:10], "img_tokens_ok": ok_img}
    return {"status": "PASS", "vocab_dir": d, "n_strings": len(strings),
            "vocab_size": len(hf), "img_tokens_ok": True}


@torch.no_grad()
def check_opt(args):
    name, d = _pick_opt(args.weights_dir, args.opt_name)
    if d is None:
        return _skip("no local OPT weights (set --weights-dir / "
                     "GILL_TPU_WEIGHTS_DIR with a facebook/opt-* dir)")
    try:
        import transformers
    except Exception as e:
        return _skip(f"transformers unavailable ({e})")
    from gill_tpu_torch.config import OPTConfig
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.weights.loader import load_opt

    dev = resolve_device(args.device)
    cfg = OPTConfig.from_name(name)
    params = load_opt(name, cfg, cfg.vocab_size, args.weights_dir,
                      device=dev, dtype=torch.float32)
    tm = transformers.OPTForCausalLM.from_pretrained(
        d, torch_dtype=torch.float32).eval()
    rng = np.random.RandomState(0)
    ids = rng.randint(4, min(cfg.vocab_size, 50000), size=(2, 16))
    t_out = tm(input_ids=torch.tensor(ids), output_hidden_states=True)
    out = opt_mod.forward(params, cfg, opt_mod.embed_tokens(
        params, torch.from_numpy(ids).to(dev)))
    dl = float(np.abs(_host(out["logits"]) - t_out.logits.numpy()).max())
    dh = float(np.abs(_host(out["last_hidden"])
                      - t_out.hidden_states[-1].numpy()).max())
    tol = 2e-3  # fp32; large models accumulate rounding
    status = "PASS" if (dl < tol and dh < tol) else "FAIL"
    return {"status": status, "model": name, "dir": d,
            "max_abs_logits_delta": dl, "max_abs_hidden_delta": dh,
            "tol": tol}


def _load_clip(args, name):
    from gill_tpu_torch.config import CLIPVisionConfig
    from gill_tpu_torch.weights.loader import load_clip_vision

    cfg = CLIPVisionConfig.from_name(name)
    return load_clip_vision(name, cfg, args.weights_dir,
                            device=resolve_device(args.device),
                            dtype=torch.float32), cfg


@torch.no_grad()
def check_clip(args):
    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.weights.loader import _model_dir

    name = args.clip_name
    d = _model_dir(name, args.weights_dir)
    if d is None:
        return _skip(f"no local CLIP weights for {name}")
    try:
        import transformers
    except Exception as e:
        return _skip(f"torch/transformers unavailable ({e})")
    params, cfg = _load_clip(args, name)
    tm = transformers.CLIPVisionModel.from_pretrained(
        d, torch_dtype=torch.float32).eval()
    rng = np.random.RandomState(1)
    # the port is NHWC (clip_preprocess layout); transformers' CLIP NCHW
    px = rng.randn(2, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    t_pool = tm(pixel_values=torch.tensor(
        px.transpose(0, 3, 1, 2))).pooler_output.numpy()
    pool = _host(clip_mod.vision_forward(
        params, cfg, torch.from_numpy(px).to(resolve_device(args.device))
    )["pooler_output"])
    dp = float(np.abs(pool - t_pool).max())
    tol = 2e-3
    return {"status": "PASS" if dp < tol else "FAIL", "model": name,
            "dir": d, "max_abs_pooler_delta": dp, "tol": tol}


def _find_sd_dir(args):
    roots = [args.sd_dir, args.weights_dir,
             os.environ.get("GILL_TPU_WEIGHTS_DIR")]
    for root in roots:
        if not root or not os.path.isdir(root):
            continue
        for d in [root] + sorted(glob.glob(os.path.join(root, "*"))):
            if (os.path.isdir(os.path.join(d, "unet"))
                    and os.path.isdir(os.path.join(d, "vae"))):
                return d
    return None


@torch.no_grad()
def check_sd(args):
    d = _find_sd_dir(args)
    if d is None:
        return _skip("no SD weights dir with unet/ + vae/ subdirs "
                     "(diffusers layout) under --sd-dir / --weights-dir")
    from gill_tpu_torch.config import (UNetConfig, VAEConfig,
                                       tiny_unet_config, tiny_vae_config)
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.models.sd import vae as vae_mod
    from gill_tpu_torch.weights.convert import (sd_unet_from_torch,
                                                sd_vae_decoder_from_torch)
    from gill_tpu_torch.weights.from_jax import tree_from_jax
    from gill_tpu_torch.weights.loader import load_state_dict_dir

    dev = resolve_device(args.device)
    if args.sd_config == "tiny":          # synthetic-asset unit tests
        ucfg, vcfg, size = tiny_unet_config(), tiny_vae_config(), 8
    else:
        ucfg, vcfg, size = UNetConfig(), VAEConfig(), 64    # 512² images
    # the converters assert full key coverage: a layout drift fails here
    usd = load_state_dict_dir(os.path.join(d, "unet"), device="cpu",
                              dtype=torch.float32)
    uparams = tree_from_jax(sd_unet_from_torch(usd, ucfg), device=dev,
                            dtype=torch.float32)
    vsd = load_state_dict_dir(os.path.join(d, "vae"), device="cpu",
                              dtype=torch.float32)
    vparams = tree_from_jax(sd_vae_decoder_from_torch(vsd, vcfg),
                            device=dev, dtype=torch.float32)

    rng = np.random.RandomState(7)
    lat = rng.randn(1, size, size, ucfg.in_channels).astype(np.float32)
    cond = rng.randn(1, 77, ucfg.cross_attention_dim).astype(np.float32)
    t = np.asarray([801], np.int32)
    eps = _host(unet_mod.apply(uparams, ucfg, torch.from_numpy(lat).to(dev),
                               torch.from_numpy(t).to(dev),
                               torch.from_numpy(cond).to(dev)))
    img = _host(vae_mod.decode(vparams, vcfg, torch.from_numpy(lat).to(dev)))
    out = {"unet_keys": len(usd), "vae_keys": len(vsd), "dir": d,
           "unet_out_mean": float(eps.mean()),
           "unet_out_std": float(eps.std()),
           "finite": bool(np.isfinite(eps).all()
                          and np.isfinite(img).all())}
    if not out["finite"]:
        return {"status": "FAIL", **out,
                "reason": "non-finite UNet/VAE output on real weights"}
    try:
        import diffusers
    except Exception as e:
        return {"status": "PASS", "level": "structural", **out,
                "note": f"diffusers unavailable ({e}): converter key "
                        "coverage + finite fixed-latent forward only — no "
                        "numeric golden"}
    tu = diffusers.UNet2DConditionModel.from_pretrained(
        os.path.join(d, "unet"), torch_dtype=torch.float32).eval()
    t_eps = tu(torch.tensor(lat.transpose(0, 3, 1, 2)), torch.tensor(t),
               torch.tensor(cond)).sample.numpy().transpose(0, 2, 3, 1)
    du = float(np.abs(eps - t_eps).max())
    tol = 5e-3
    return {"status": "PASS" if du < tol else "FAIL", "level": "golden",
            **out, "max_abs_unet_delta": du, "tol": tol}


def check_clip_sim(args):
    from gill_tpu_torch.evals.compute_clip_similarity import cos_sim
    from gill_tpu_torch.weights.loader import _model_dir

    name = args.clip_name
    if _model_dir(name, args.weights_dir) is None:
        return _skip(f"no local CLIP weights for {name} (the eval scorer "
                     "is meaningless on random init)")
    params, cfg = _load_clip(args, name)
    if "visual_projection" not in params:
        return {"status": "FAIL",
                "reason": "converted CLIP params carry no "
                          "visual_projection (CLIP-sim needs the "
                          "projected image features)"}
    rng = np.random.RandomState(3)
    dev = resolve_device(args.device)
    # NHWC, the clip_preprocess layout (utils/image.py)
    a, b = (torch.from_numpy(rng.rand(1, cfg.image_size, cfg.image_size, 3)
                             .astype(np.float32)).to(dev) for _ in range(2))
    same = float(cos_sim(params, cfg, a, a)[0])
    diff = float(cos_sim(params, cfg, a, b)[0])
    ok = same > 0.999 and diff < 0.99 and diff < same
    return {"status": "PASS" if ok else "FAIL", "model": name,
            "self_sim": same, "cross_sim": diff}


@torch.no_grad()
def check_lpips(args):
    path = args.lpips_weights or os.environ.get("GILL_TPU_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return _skip("no LPIPS weights (--lpips-weights / "
                     "GILL_TPU_LPIPS_WEIGHTS; build with "
                     "python -m gill_tpu_torch.scripts."
                     "convert_lpips_weights)")
    from gill_tpu_torch.evals.lpips_2dirs import (load_lpips_weights,
                                                  lpips_distance)

    dev = resolve_device(args.device)
    params = load_lpips_weights(path, dev)
    rng = np.random.RandomState(4)
    # the protocol's range: (1, H, W, 3) in [-1, 1]
    img = (rng.rand(1, 64, 64, 3).astype(np.float32) * 2 - 1)
    noisy = np.clip(img + rng.randn(*img.shape).astype(np.float32) * 0.4,
                    -1, 1)
    img, noisy = (torch.from_numpy(x).to(dev) for x in (img, noisy))
    d_same = float(lpips_distance(params, img, img))
    d_noise = float(lpips_distance(params, img, noisy))
    ok = d_same < 1e-4 and d_noise > max(d_same * 10, 1e-3)
    return {"status": "PASS" if ok else "FAIL", "weights": path,
            "d_identical": d_same, "d_noised": d_noise}


@torch.no_grad()
def check_specdec(args):
    target, tdir = _pick_opt(args.weights_dir, args.opt_name)
    if tdir is None:
        return _skip("no local target OPT weights")
    # an explicit --draft-name may equal the target (self-drafting is a
    # valid ~100%-acceptance sanity run); auto-pick excludes the target
    draft, ddir = _pick_opt(args.weights_dir, args.draft_name,
                            exclude=None if args.draft_name else target)
    if ddir is None:
        return _skip(f"no local DRAFT OPT weights distinct from the "
                     f"target {target}")
    if not args.cc3m_tsv or not os.path.exists(args.cc3m_tsv):
        return _skip("no --cc3m-tsv captions file for acceptance "
                     "measurement")
    roots = [args.tokenizer_dir, os.environ.get("GILL_TPU_TOKENIZER_DIR"),
             tdir, args.weights_dir]
    vocab_dir = _find_dir_with(["vocab.json", "merges.txt"], roots)
    if vocab_dir is None:
        return _skip("no vocab.json/merges.txt to tokenize captions")
    from gill_tpu_torch.config import OPTConfig
    from gill_tpu_torch.serve.speculative import SpeculativeDecoder
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer
    from gill_tpu_torch.weights.loader import load_opt

    dev = resolve_device(args.device)
    tok = GPT2BPETokenizer.from_files(
        os.path.join(vocab_dir, "vocab.json"),
        os.path.join(vocab_dir, "merges.txt"))
    tcfg, dcfg = OPTConfig.from_name(target), OPTConfig.from_name(draft)
    tparams, dparams = (load_opt(n, c, c.vocab_size, args.weights_dir,
                                 device=dev, dtype=torch.float32)
                        for n, c in ((target, tcfg), (draft, dcfg)))
    dec = SpeculativeDecoder(tparams, tcfg, dparams, dcfg, k=args.spec_k,
                             max_seq=256, rounds_per_call=4,
                             kv_dtype=torch.float32)
    caps = []
    with open(args.cc3m_tsv) as f:
        for line in f:
            cap = line.split("\t")[0].strip()
            if cap and cap.lower() != "caption":
                caps.append(cap)
            if len(caps) >= args.n_captions:
                break
    rounds = accepted = 0
    t0 = time.time()
    n_tok = 0
    for cap in caps:
        ids = tok.encode(cap, add_special_tokens=False)[:64]
        out = dec.generate(ids, max_new_tokens=32)
        n_tok += len(out)
        rounds += dec.last_stats["rounds"]
        accepted += dec.last_stats["accepted"]
    dt = time.time() - t0
    rate = accepted / max(rounds * (args.spec_k - 1), 1)
    return {"status": "PASS", "target": target, "draft": draft,
            "captions": len(caps), "acceptance_rate": rate,
            "mean_tokens_per_round": 1 + accepted / max(rounds, 1),
            "tokens_per_sec": n_tok / max(dt, 1e-9)}


CHECKS = {
    "tokenizer": check_tokenizer,
    "opt": check_opt,
    "clip": check_clip,
    "sd": check_sd,
    "clip_sim": check_clip_sim,
    "lpips": check_lpips,
    "specdec": check_specdec,
}


def run(args):
    """Runs the selected checks; writes the report to args.out; returns
    the exit status (1 when a check FAILED)."""
    only = set(args.only.split(",")) if args.only else set(CHECKS)
    unknown = only - set(CHECKS)
    if unknown:
        raise ValueError(f"unknown checks: {unknown} (have {set(CHECKS)})")
    results = {}
    for name, fn in CHECKS.items():
        if name not in only:
            continue
        t0 = time.time()
        try:
            res = fn(args)
        except Exception:
            res = {"status": "FAIL",
                   "error": traceback.format_exc(limit=8)}
        res["seconds"] = round(time.time() - t0, 2)
        results[name] = res
        print(f"[{res['status']:>7}] {name}: "
              + (res.get("reason") or res.get("error", "").splitlines()[-1]
                 if res["status"] != "PASS" else
                 json.dumps({k: v for k, v in res.items()
                             if k not in ("status", "seconds")})[:200]),
              flush=True)
    summary = {s: sum(r["status"] == s for r in results.values())
               for s in ("PASS", "FAIL", "SKIPPED")}
    report = {"argv": args.argv, "results": results, "summary": summary}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"# {summary} -> {args.out}")
    return 1 if summary["FAIL"] else 0


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights-dir",
                   default=os.environ.get("GILL_TPU_WEIGHTS_DIR"))
    p.add_argument("--tokenizer-dir", default=None)
    p.add_argument("--sd-dir", default=None)
    p.add_argument("--lpips-weights", default=None)
    p.add_argument("--cc3m-tsv", default=None)
    p.add_argument("--opt-name", default=None,
                   help="target OPT preset (default: smallest present)")
    p.add_argument("--draft-name", default=None,
                   help="specdec draft OPT preset")
    p.add_argument("--clip-name", default="openai/clip-vit-large-patch14")
    p.add_argument("--spec-k", type=int, default=8)
    p.add_argument("--n-captions", type=int, default=32)
    p.add_argument("--sd-config", default="v15", choices=("v15", "tiny"),
                   help="tiny = synthetic-asset self-test shapes")
    p.add_argument("--only", default=None)
    p.add_argument("--out", default="REAL_WEIGHTS_REPORT.json")
    add_device_arg(p)
    args = p.parse_args(argv)
    args.argv = sys.argv[1:] if argv is None else list(argv)
    return args


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
