"""Ablation timing of the OPT cached-decode step on the card: times the full
KV-cached greedy decode with components knocked out; a component's cost is
full - ablated.

Port of scripts/profile_decode.py: a batch of 16 prompts of 32 embedding
rows (N(0, 0.02) from a seeded generator), prefilled, then 96 greedy
steps, each fed its argmax token, on `init_dummy`'s zero OPT in bf16. The
steps decode the way the serving engines do, each row at its own position
(a (B,) `cache_pos`: the valid-prefix kernel K6 where it applies). The
ablations replace `models.opt._layer` with `layer_without(parts)` for their
runs and restore it in a `finally`, so an exception cannot leave the
module patched:
  attn-core   the attention product (the layer's output takes q);
  cache-upd   the cache write as well;
  whole-attn  the attention block;
  mlp         the MLP block;
  lm-head     the head product (the next token from the last hidden
              state's first column).
A decode is host-bound in eager mode, so each row is host-clock ms of the
whole decode (prefill included), the mean of `reps` after a warm-up. The
flags stand for GILL_BENCH_MODEL / _BATCH / _PROMPT / _GEN. Nothing is
written without --out.

    python -m gill_tpu_torch.scripts.profile_decode [--model NAME]
        [--batch 16] [--prompt 32] [--gen 96] [--device cuda] [--out PATH]
"""

from __future__ import annotations

import contextlib
import sys

import torch

from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.ops.attention import dot_product_attention
from gill_tpu_torch.scripts import _serving as S
from gill_tpu_torch.scripts._timing import clock_note, probe_main, wall_ms

FLAGS = [("model", str, "OPT preset (default facebook/opt-2.7b)"),
         ("batch", int, "decode rows (16)"),
         ("prompt", int, "prompt embedding rows (32)"),
         ("gen", int, "decode steps (96)")]

ABLATIONS = [("attn-core", ("attncore",)),
             ("cache-upd", ("cacheupd", "attncore")),
             ("whole-attn", ("attn",)), ("mlp", ("mlp",))]


def layer_without(skip):
    """`models.opt._layer` (pre-LN, one device) with the parts in `skip`
    left out: "attncore", "cacheupd", "attn", "mlp"."""
    def layer(cfg, lp, h, *, cache_kv=None, cache_pos=None, per_row=None,
              mesh=None):
        b, t, _ = h.shape
        eps = cfg.layer_norm_eps
        if "attn" not in skip:
            x = nn.layer_norm(lp["attn_ln"], h, eps)
            q, k, v = (opt_mod._linear(lp["attn"][n], x).reshape(
                b, t, -1, cfg.head_dim) for n in "qkv")
            if cache_kv is None:
                attn = dot_product_attention(q, k, v, causal=True)
            elif per_row is not None and t == 1:
                # the engines' decode: stale rows + the token's own k/v
                attn = q if "attncore" in skip else dot_product_attention(
                    q, cache_kv[0], cache_kv[1], causal=True,
                    kv_offset=per_row["off"], kv_lengths=per_row["lens"],
                    extra_kv=(k, v))
                if "cacheupd" not in skip:
                    opt_mod._write_at(cache_kv,
                                      opt_mod._cache_rows(cache_kv, k, v),
                                      per_row)
            else:
                # the prefill at position 0
                attn = q if "attncore" in skip else dot_product_attention(
                    q, k, v, causal=True)
                if "cacheupd" not in skip:
                    opt_mod._write_at(cache_kv,
                                      opt_mod._cache_rows(cache_kv, k, v), 0)
            h = h + opt_mod._linear(lp["attn"]["o"], attn.reshape(b, t, -1))
        if "mlp" not in skip:
            x = nn.layer_norm(lp["mlp_ln"], h, eps)
            h = h + opt_mod._linear(lp["fc2"], torch.relu(
                opt_mod._linear(lp["fc1"], x)))
        return h
    return layer


@contextlib.contextmanager
def patched_layer(fn):
    saved = opt_mod._layer
    opt_mod._layer = fn
    try:
        yield
    finally:
        opt_mod._layer = saved


def decoder(params, cfg, prompt, gen: int, skip_lm_head: bool = False):
    """The decode as one call: prefill `prompt` (B, P, E), then `gen`
    greedy steps at per-row positions."""
    b, p, _ = prompt.shape
    dev, head = prompt.device, params["embed_tokens"]["weight"].float()

    # the pool rounded up to 64 rows, as the engines' pools are, so that
    # the valid-prefix kernel (K6) takes the steps where it applies
    rows = -(-(p + gen) // 64) * 64

    def decode():
        cache = opt_mod.init_cache(cfg, b, rows, device=dev,
                                   dtype=prompt.dtype)
        pre = opt_mod.forward(params, cfg, prompt, cache=cache, cache_pos=0,
                              lm_head=head)
        logits = pre["logits"][:, -1]
        pos = torch.full((b,), p, dtype=torch.int32, device=dev)
        for _ in range(gen):
            tok = logits.argmax(-1)
            emb = opt_mod.embed_tokens(params, tok[:, None])
            out = opt_mod.forward(params, cfg, emb, cache=cache,
                                  cache_pos=pos, lm_head=head,
                                  skip_logits=skip_lm_head)
            if skip_lm_head:
                logits = torch.zeros_like(logits)
                logits[:, 0] = out["last_hidden"][:, -1, 0].float()
            else:
                logits = out["logits"][:, -1]
            pos = pos + 1
        return logits
    return decode


@torch.no_grad()
def probe(model=S.MODEL, batch=16, prompt=32, gen=96, reps=1,
          device="cuda", params=None):
    print(clock_note(device), flush=True)
    cfg = S.opt_cfg(model)
    dtype = S.act_dtype(device)
    if params is None:
        params = opt_mod.init_dummy(cfg, dtype, device=device)
    g = torch.Generator(device).manual_seed(1)
    x = (torch.randn(batch, prompt, cfg.word_embed_proj_dim, device=device,
                     generator=g) * 0.02).to(dtype)

    def run(skip_lm_head=False):
        fn = decoder(params, cfg, x, gen, skip_lm_head)
        fn()
        return wall_ms(fn, device, reps)

    base = run()
    rows = [{"ablation": "baseline", "host_ms": base,
             "tok_s": batch * gen / (base / 1e3)}]
    print(f"baseline       {base:8.2f} ms  {batch * gen / (base / 1e3):8.1f} "
          f"tok/s (host clock)", flush=True)
    for name, skip in ABLATIONS:
        with patched_layer(layer_without(skip)):
            t = run()
        rows.append({"ablation": f"w/o {name}", "host_ms": t,
                     "delta_host_ms": base - t})
        print(f"w/o {name:<11}{t:8.2f} ms  (delta {base - t:7.2f})",
              flush=True)
    t = run(skip_lm_head=True)
    rows.append({"ablation": "w/o lm-head", "host_ms": t,
                 "delta_host_ms": base - t})
    print(f"w/o lm-head    {t:8.2f} ms  (delta {base - t:7.2f})", flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, FLAGS, **kw)


if __name__ == "__main__":
    sys.exit(main())
