"""OPT decoder (the frozen LM backbone) over explicit parameter trees.

Counterpart of gill_tpu/models/opt.py: `inputs_embeds` entry point, optional
project_in/project_out, learned positions offset by `position_offset`,
pre- or post-LayerNorm layers, per-layer hidden-state taps, a tied lm head
and a preallocated KV cache `{"k", "v"}` of shape (L, B, S, H, Dh).

Cached calls (`cache` given) take one of three paths, as in gill_tpu:
  * prefill (`cache_pos == 0`): attention over the prompt's own k/v (so the
    flash gate sees the prompt length), then k/v are written at 0..T-1;
  * single-token decode (`T == 1`, `cache_pos > 0`, or a (B,) tensor of
    per-row positions as the serving engines pass): attention over the
    stale cache — rows < cache_pos of each row — plus the token's own k/v,
    jointly; the token's k/v are then written at (b, cache_pos[b]). Rows
    whose position lies outside the cache (a parked slot beyond the
    engines' read window) write nothing, as gill_tpu's mode="drop"
    scatter;
  * a multi-token chunk at `cache_pos > 0`: k/v are written first and the
    chunk attends over the cache prefix with `kv_offset = cache_pos`.
The cache is updated IN PLACE (gill_tpu returns a new cache) and returned;
a window view of a larger pool (the engines' read window) updates the pool.
An int8 cache ({"k", "v"} int8 plus per-token-per-head fp32 scales "ks",
"vs") takes the prefill and single-token decode paths.
Layers run as a Python loop over views of the stacked (L, ...) weights; a
W8 weight's layer view is a view too, so nothing is copied per layer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from gill_tpu_torch.config import OPTConfig
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.ops.attention import dot_product_attention, needs_grad
from gill_tpu_torch.ops.w8_matmul import row_windows

# On the card cuBLAS picks a plain (bf16 / fp32) weight's algorithm by the
# product's row count: at OPT-6.7B's fc2 (K 16384) it sums K in another
# order above 128 rows than at 64 or 128 (the q/k/v/o and fc1 shapes keep
# one order at every count), so a prefill wave's size would change its
# prompts' bits. The decoder runs such products of more than ROW_WINDOW
# rows as windows of exactly ROW_WINDOW rows, as W8 products take K4's
# 256-row windows (ops/w8_matmul.py `w8_matmul_rows`).
ROW_WINDOW = 128


def init(init: nn.Init, cfg: OPTConfig):
    """Random parameters with gill_tpu's init distributions, allocated in
    stacked (L, ...) form directly on `init`'s device and dtype."""
    n, d, f = cfg.num_layers, cfg.hidden_size, cfg.ffn_dim
    lead = (n,)
    params = {
        "embed_tokens": init.embedding(cfg.vocab_size, cfg.word_embed_proj_dim),
        "embed_positions": init.embedding(
            cfg.max_positions + cfg.position_offset, d),
        "layers": {
            "attn": {k: init.linear(d, d, lead=lead) for k in "qkvo"},
            "attn_ln": init.layer_norm(d, lead),
            "fc1": init.linear(d, f, lead=lead),
            "fc2": init.linear(f, d, lead=lead),
            "mlp_ln": init.layer_norm(d, lead),
        },
    }
    if cfg.do_layer_norm_before:
        params["final_ln"] = init.layer_norm(d)
    if cfg.word_embed_proj_dim != cfg.hidden_size:
        params["project_in"] = init.linear(cfg.word_embed_proj_dim, d,
                                           bias=False)
        params["project_out"] = init.linear(d, cfg.word_embed_proj_dim,
                                            bias=False)
    return params


def init_dummy(cfg: OPTConfig, dtype=torch.bfloat16, *, device):
    """Parameters of the right structure and shapes with zero weights and
    unit LayerNorm scales (gill_tpu `init_dummy`), made on `device`: for
    runs where the values do not matter (the serving CLI, the speculative
    decoding probe), without a random generator's transients."""
    n, d, f = cfg.num_layers, cfg.hidden_size, cfg.ffn_dim

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def lin(si, so):
        return {"w": zeros(n, si, so), "b": zeros(n, so)}

    def ln(*lead):
        return {"scale": torch.ones((*lead, d), device=device, dtype=dtype),
                "bias": zeros(*lead, d)}

    params = {
        "embed_tokens": {"weight": zeros(cfg.vocab_size,
                                         cfg.word_embed_proj_dim)},
        "embed_positions": {"weight": zeros(
            cfg.max_positions + cfg.position_offset, d)},
        "layers": {
            "attn": {k: lin(d, d) for k in "qkvo"},
            "attn_ln": ln(n), "fc1": lin(d, f), "fc2": lin(f, d),
            "mlp_ln": ln(n),
        },
    }
    if cfg.do_layer_norm_before:
        params["final_ln"] = ln()
    if cfg.word_embed_proj_dim != cfg.hidden_size:
        params["project_in"] = {"w": zeros(cfg.word_embed_proj_dim, d)}
        params["project_out"] = {"w": zeros(d, cfg.word_embed_proj_dim)}
    return params


def quantize_params_w8(params, kernel=None):
    """W8A16 serving quantization of the decoder-layer linears (gill_tpu
    `quantize_params_w8`): per-output-channel symmetric int8,
    {"w8" (L, in, out) int8, "ws" (L, out) fp32, "b"} per linear.
    Embeddings, norms and project_in/out stay as they are. Quantized one
    layer at a time, so the fp32 transient is one layer deep.

    kernel: the markers gill_tpu keys its kernel choice on — None gives
    "kern" for hidden sizes >= 4096, True "kern", False "xla". The port
    keys only on "xla" (`nn.linear` then keeps the dequant form even on
    CUDA); "kern" is read by nothing here and is set only so the tree
    matches gill_tpu's leaf for leaf (weights/from_jax.py)."""
    def q(leaf):
        w = leaf["w"]
        n_layers, _, n_out = w.shape
        wq = torch.empty(w.shape, device=w.device, dtype=torch.int8)
        ws = torch.empty((n_layers, n_out), device=w.device,
                         dtype=torch.float32)
        for i in range(n_layers):
            wf = w[i].float()
            scale = torch.clamp(wf.abs().amax(dim=0, keepdim=True) / 127.0,
                                min=1e-12)
            wq[i] = torch.clamp(torch.round(wf / scale), -127, 127).to(
                torch.int8)
            ws[i] = scale[0]
        out = {"w8": wq, "ws": ws}
        if "b" in leaf:
            out["b"] = leaf["b"]
        if use_kernel:
            out["kern"] = ()
        elif kernel is False:
            out["xla"] = ()
        return out

    use_kernel = kernel
    if use_kernel is None:
        use_kernel = params["layers"]["attn"]["q"]["w"].shape[-1] >= 4096
    layers = params["layers"]
    new_layers = dict(layers)
    new_layers["attn"] = {k: q(v) for k, v in layers["attn"].items()}
    new_layers["fc1"] = q(layers["fc1"])
    new_layers["fc2"] = q(layers["fc2"])
    out = dict(params)
    out["layers"] = new_layers
    return out


def resize_embeddings(params, new_vocab: int, init: nn.Init,
                      std: float = 0.02):
    """Grows the token-embedding table with N(0, std) rows (reference
    lm.resize_token_embeddings)."""
    w = params["embed_tokens"]["weight"]
    old_vocab, dim = w.shape
    if new_vocab <= old_vocab:
        return params
    new_rows = init.normal((new_vocab - old_vocab, dim), std).to(w.dtype)
    params = dict(params)
    params["embed_tokens"] = {"weight": torch.cat([w, new_rows], dim=0)}
    return params


def embed_tokens(params, ids):
    return params["embed_tokens"]["weight"][ids]


def init_cache(cfg: OPTConfig, batch: int, max_seq: int, *, device,
               dtype=torch.bfloat16, kv_int8: bool = False):
    """Preallocated (L, B, S, H, Dh) cache. kv_int8: int8 values with
    per-token-per-head fp32 scales "ks"/"vs" (L, B, S, H) (gill_tpu
    `init_cache(kv_int8=True)`); `dtype` is then unused."""
    shape = (cfg.num_layers, batch, max_seq, cfg.num_heads, cfg.head_dim)
    if kv_int8:
        return {"k": torch.zeros(shape, device=device, dtype=torch.int8),
                "v": torch.zeros(shape, device=device, dtype=torch.int8),
                "ks": torch.zeros(shape[:-1], device=device,
                                  dtype=torch.float32),
                "vs": torch.zeros(shape[:-1], device=device,
                                  dtype=torch.float32)}
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


def cache_keys(cache) -> tuple:
    return ("k", "v", "ks", "vs") if cache["k"].dtype == torch.int8 \
        else ("k", "v")


def _quantize_kv(x):
    """(B, T, H, D) -> int8 values + per-(B, T, H) fp32 scales."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-12)
    x8 = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return x8.to(torch.int8), scale


def _cache_rows(cache_kv, k, v):
    """The rows to write for this token block: (k, v) in the cache dtype,
    or (k8, v8, ks, vs) for an int8 cache."""
    if len(cache_kv) == 4:
        k8, ks = _quantize_kv(k)
        v8, vs = _quantize_kv(v)
        return k8, v8, ks, vs
    return k.to(cache_kv[0].dtype), v.to(cache_kv[1].dtype)


def _per_row_decode(pos, s: int):
    """What every layer of a per-row decode (a (B,) `cache_pos`) reuses,
    made once a forward rather than once a layer: the attention's offsets
    pos - 1 and int32 valid lengths pos, and the cache write's batch
    indices, positions clamped into the S-row cache and in-cache mask."""
    return {"off": pos - 1, "lens": pos.to(torch.int32),
            "bidx": torch.arange(pos.shape[0], device=pos.device),
            "pc": pos.long().clamp(max=s - 1), "inside": pos < s}


def _write_at(cache_kv, rows, pos):
    """Writes token rows (B, T, ...) at cache position `pos`: an int (all
    rows at pos..pos+T-1), or `_per_row_decode`'s indices for T == 1 — row
    b at pos[b], nothing where pos[b] is outside the cache (read window)."""
    if not isinstance(pos, dict):
        for dst, new in zip(cache_kv, rows):
            dst[:, pos:pos + new.shape[1]] = new
        return
    bidx, pc, inside = pos["bidx"], pos["pc"], pos["inside"]
    for dst, new in zip(cache_kv, rows):
        keep = inside.view(-1, *([1] * (new.ndim - 2)))
        dst[bidx, pc] = torch.where(keep, new[:, 0], dst[bidx, pc])


def use_row_windows(p, x, *, on_cuda: bool) -> bool:
    """Whether `_linear` takes the product in ROW_WINDOW-row windows: a
    plain weight, on the card, more than ROW_WINDOW rows, and no gradient
    to carry. The windows keep a serving prompt's bits independent of its
    wave; they write one output through `out=`, which autograd refuses,
    and under grad they read each weight once a window (a batch-32 train
    step took 1.8x as long on the card), so a training forward takes one
    product."""
    return ("w" in p and on_cuda and x.numel() // x.shape[-1] > ROW_WINDOW
            and not needs_grad(x, p["w"]))


def _linear(p, x):
    """`nn.linear`, with a plain weight's product on the card of more than
    ROW_WINDOW rows taken in ROW_WINDOW-row windows where
    `use_row_windows` says so (see ROW_WINDOW)."""
    if not use_row_windows(p, x, on_cuda=x.is_cuda):
        return nn.linear(p, x)
    m = x.numel() // x.shape[-1]
    w = p["w"].to(x.dtype)
    x2 = x.reshape(m, x.shape[-1])
    y = torch.empty((m, w.shape[1]), device=x.device, dtype=x.dtype)
    for lo, hi in row_windows(m, ROW_WINDOW):
        torch.matmul(x2[lo:hi], w, out=y[lo:hi])
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[1])


def _layer(cfg: OPTConfig, lp, h, *, cache_kv=None, cache_pos=None,
           per_row=None):
    """One decoder layer; `per_row` is `_per_row_decode(cache_pos, S)` when
    cache_pos is a (B,) tensor."""
    b, t, d = h.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    pre_ln = cfg.do_layer_norm_before

    resid = h
    x = nn.layer_norm(lp["attn_ln"], h, cfg.layer_norm_eps) if pre_ln else h
    q = _linear(lp["attn"]["q"], x).reshape(b, t, nh, hd)
    k = _linear(lp["attn"]["k"], x).reshape(b, t, nh, hd)
    v = _linear(lp["attn"]["v"], x).reshape(b, t, nh, hd)

    if cache_kv is None:
        attn = dot_product_attention(q, k, v, causal=True)
    else:
        ck, cv = cache_kv[:2]
        scales = cache_kv[2:] if len(cache_kv) == 4 else None
        if t == 1 and (per_row is not None or cache_pos > 0):
            # stale cache (rows < cache_pos) + the token's own k/v, jointly
            if per_row is not None:
                rk, rv, rs = ck, cv, scales
                off, lens, at = per_row["off"], per_row["lens"], per_row
            else:
                rk, rv = ck[:, :cache_pos], cv[:, :cache_pos]
                rs = None if scales is None else tuple(
                    x[:, :cache_pos] for x in scales)
                off, lens, at = cache_pos - 1, None, cache_pos
            attn = dot_product_attention(q, rk, rv, causal=True,
                                         kv_offset=off, kv_lengths=lens,
                                         extra_kv=(k, v), kv_scales=rs)
            _write_at(cache_kv, _cache_rows(cache_kv, k, v), at)
        elif per_row is None and cache_pos == 0:
            attn = dot_product_attention(q, k, v, causal=True)
            _write_at(cache_kv, _cache_rows(cache_kv, k, v), 0)
        else:
            if scales is not None or per_row is not None:
                raise ValueError("a multi-token chunk at cache_pos > 0 takes "
                                 "an int cache_pos and a bf16/fp32 cache")
            ck[:, cache_pos:cache_pos + t] = k
            cv[:, cache_pos:cache_pos + t] = v
            attn = dot_product_attention(q, ck, cv, causal=True,
                                         kv_offset=cache_pos)

    h = resid + _linear(lp["attn"]["o"], attn.reshape(b, t, d))
    if not pre_ln:
        h = nn.layer_norm(lp["attn_ln"], h, cfg.layer_norm_eps)
    resid = h
    x = nn.layer_norm(lp["mlp_ln"], h, cfg.layer_norm_eps) if pre_ln else h
    h = resid + _linear(lp["fc2"], torch.relu(_linear(lp["fc1"], x)))
    if not pre_ln:
        h = nn.layer_norm(lp["mlp_ln"], h, cfg.layer_norm_eps)
    return h


def forward(params, cfg: OPTConfig, inputs_embeds, *,
            collect_hidden: bool = False, cache=None, cache_pos=None,
            lm_head=None, skip_logits: bool = False, remat: bool = False):
    """Decoder forward from input embeddings (B, T, word_embed_proj_dim).

    remat: with no cache and grad enabled, each layer runs under
    `torch.utils.checkpoint` (non-reentrant): its activations are
    recomputed in the backward instead of kept (gill_tpu's per-layer
    `jax.checkpoint`, the training memory saver).

    Returns "last_hidden" (B, T, E); "logits" (B, T, V) in fp32 unless
    skip_logits; "hidden_states" (L+1, B, T, D) when collect_hidden (index
    0 = embedding stream, i = layer i's output); "cache" when given."""
    t = inputs_embeds.shape[1]
    dev = inputs_embeds.device
    h = inputs_embeds
    if "project_in" in params:
        h = nn.linear(params["project_in"], h)
    positions = torch.arange(t, device=dev)[None, :]
    if torch.is_tensor(cache_pos):
        positions = positions + cache_pos.long()[:, None]
    elif cache_pos:
        positions = positions + cache_pos
    # a bucket's pad rows may lie past the position table (a tiny model
    # served at a longer max_seq): clamped into it, as gill_tpu's gather
    # clamps; their outputs are never read
    table = params["embed_positions"]["weight"]
    pos_emb = table[(positions + cfg.position_offset).clamp(
        max=table.shape[0] - 1)]
    h = h + pos_emb.to(h.dtype)
    hs = [h] if collect_hidden else None

    layers = params["layers"]
    ckeys = None if cache is None else cache_keys(cache)
    per_row = (_per_row_decode(cache_pos, cache["k"].shape[2])
               if cache is not None and torch.is_tensor(cache_pos) else None)
    remat = remat and cache is None and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        kv = None if cache is None else tuple(cache[c][i] for c in ckeys)
        lp = nn.layer_view(layers, i)
        if remat:
            h = checkpoint(_layer, cfg, lp, h, use_reentrant=False)
        else:
            h = _layer(cfg, lp, h, cache_kv=kv, cache_pos=cache_pos,
                       per_row=per_row)
        if collect_hidden:
            hs.append(h)

    if cfg.do_layer_norm_before:
        h = nn.layer_norm(params["final_ln"], h, cfg.layer_norm_eps)
    if "project_out" in params:
        h = nn.linear(params["project_out"], h)

    out = {"last_hidden": h}
    if not skip_logits:
        head = params["embed_tokens"]["weight"] if lm_head is None else lm_head
        # fp32 products of the input-dtype values, fp32 accumulation (the
        # JAX dot_general with preferred_element_type=float32)
        out["logits"] = torch.matmul(h.float(), head.float().t())
    if collect_hidden:
        out["hidden_states"] = torch.stack(hs)
    if cache is not None:
        out["cache"] = cache
    return out


def loss_fn(logits, labels, ignore_index: int = -100):
    """Shifted next-token cross-entropy, targets equal to `ignore_index`
    masked, mean over the valid ones (HF CausalLMOutput.loss, reference
    main.py:508; gill_tpu opt.loss_fn)."""
    logits = logits[:, :-1, :]
    targets = labels[:, 1:].long()
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)
