"""GILL core, inference half: frozen OPT + frozen CLIP ViT glued by small
adapters, and the KV-cached decode loop with the [IMG] logic.

Counterpart of gill_tpu/models/gill.py (`GILLCore`). The 8 [IMG] token rows
are a separate (num_tokens, E) adapter that overrides the frozen embedding
table at lookup and lm-head time. Params layout:
{"lm": opt params, "vision": clip params, "adapters": {...}}.

`generate` matches gill_tpu's tokens and hidden states, not its XLA
mechanism: the prompt is prefilled at its true length (gill_tpu pads it
to a multiple of 64 so one compiled program serves a bucket; the padded
rows are never read), the cache holds exactly prompt + decode steps, and
the loop is a Python loop that stops once every row is done.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from gill_tpu_torch.config import (CLIPVisionConfig, GILLConfig, MapperConfig,
                                   OPTConfig)
from gill_tpu_torch.models import clip as clip_mod
from gill_tpu_torch.models import mapper as mapper_mod
from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.ops.sampling import sample


@dataclasses.dataclass
class GILLCore:
    """Static model description; the methods are functions of
    (params, inputs)."""

    cfg: GILLConfig
    opt_cfg: OPTConfig
    vis_cfg: CLIPVisionConfig
    vocab_len: int               # len(tokenizer) incl. <|image|> + [IMG0..n)
    img_start: int               # id of [IMG0] (contiguous run of num_tokens)
    pad_token_id: int = 1
    bos_token_id: int = 2

    @classmethod
    def build(cls, cfg: GILLConfig, vocab_len: int, img_start: int,
              pad_token_id: int = 1, bos_token_id: int = 2) -> "GILLCore":
        return cls(cfg=cfg, opt_cfg=cfg.opt, vis_cfg=cfg.vision,
                   vocab_len=vocab_len, img_start=img_start,
                   pad_token_id=pad_token_id, bos_token_id=bos_token_id)

    # -- mapper configs ------------------------------------------------------

    @property
    def lm_dim(self) -> int:
        return self.opt_cfg.word_embed_proj_dim

    def tap_specs(self) -> Tuple[Tuple[str, int, int], ...]:
        """One (param-suffix, layer-entry, in_dim) per cfg.text_emb_layers
        entry: -1 / num_layers tap the final post-norm stream
        (word_embed_proj_dim), other entries that layer's hidden state."""
        n_layers = self.opt_cfg.num_layers
        specs = []
        for i, e in enumerate(self.cfg.text_emb_layers):
            if not (-n_layers - 1 <= e <= n_layers):
                raise ValueError(
                    f"text_emb_layers entry {e} out of range for a "
                    f"{n_layers}-layer LM")
            final = e == -1 or e == n_layers
            in_dim = self.lm_dim if final else self.opt_cfg.hidden_size
            specs.append(("" if i == 0 else f"_{i}", e, in_dim))
        return tuple(specs)

    def ret_mapper_cfg_for(self, in_dim: int) -> MapperConfig:
        return MapperConfig(in_dim=in_dim, out_dim=self.cfg.ret_emb_dim,
                            num_input_tokens=self.cfg.num_tokens,
                            num_output_tokens=1,
                            mode=self.cfg.ret_text_fc_mode)

    def gen_mapper_cfg_for(self, in_dim: int) -> MapperConfig:
        return MapperConfig(in_dim=in_dim, out_dim=self.cfg.gen_emb_dim,
                            num_input_tokens=self.cfg.num_tokens,
                            num_output_tokens=self.cfg.num_clip_tokens,
                            mode=self.cfg.text_fc_mode)

    @property
    def ret_mapper_cfg(self) -> MapperConfig:
        return self.ret_mapper_cfg_for(self.tap_specs()[0][2])

    @property
    def gen_mapper_cfg(self) -> MapperConfig:
        return self.gen_mapper_cfg_for(self.tap_specs()[0][2])

    # -- init ----------------------------------------------------------------

    def init_adapters(self, init: nn.Init) -> dict:
        vh = self.vis_cfg.hidden_size
        ad = {
            "img_embeddings": init.normal((self.cfg.num_tokens, self.lm_dim),
                                          0.02),
            "visual_embeddings": init.linear(
                vh, self.lm_dim * self.cfg.n_visual_tokens),
            "visual_fc": init.linear(vh, self.cfg.ret_emb_dim),
            "logit_scale": init.full((), math.log(1 / 0.07)),
        }
        for suffix, _, in_dim in self.tap_specs():
            ad[f"ret_fc{suffix}"] = mapper_mod.init(
                init, self.ret_mapper_cfg_for(in_dim))
            ad[f"gen_fc{suffix}"] = mapper_mod.init(
                init, self.gen_mapper_cfg_for(in_dim))
        return ad

    # -- embeddings ----------------------------------------------------------

    def embed_tokens(self, params, ids):
        """Token embedding with the trainable [IMG] rows swapped in."""
        base = params["lm"]["embed_tokens"]["weight"][ids]
        rel = ids - self.img_start
        in_img = (rel >= 0) & (rel < self.cfg.num_tokens)
        img = params["adapters"]["img_embeddings"].to(base.dtype)[
            rel.clamp(0, self.cfg.num_tokens - 1)]
        return torch.where(in_img[..., None], img, base)

    def lm_head_table(self, params):
        """Tied lm head = the frozen table with the [IMG] rows swapped in."""
        table = params["lm"]["embed_tokens"]["weight"].clone()
        nt = self.cfg.num_tokens
        table[self.img_start:self.img_start + nt] = \
            params["adapters"]["img_embeddings"].to(table.dtype)
        return table

    # -- vision --------------------------------------------------------------

    def get_visual_embs(self, params, pixel_values, mode: str = "captioning"):
        """pixel_values: (B, H, W, 3) NHWC (reference gill/models.py:129-152)."""
        if mode == "generation":
            return torch.zeros((pixel_values.shape[0], 1, 768),
                               device=pixel_values.device,
                               dtype=pixel_values.dtype)
        pooled = clip_mod.vision_forward(
            params["vision"], self.vis_cfg, pixel_values)["pooler_output"]
        if mode == "captioning":
            v = nn.linear(params["adapters"]["visual_embeddings"], pooled)
            return v.reshape(v.shape[0], self.cfg.n_visual_tokens, self.lm_dim)
        if mode == "retrieval":
            v = nn.linear(params["adapters"]["visual_fc"], pooled)
            return v.reshape(v.shape[0], 1, self.cfg.ret_emb_dim)
        raise ValueError(mode)

    # -- decoding ------------------------------------------------------------

    def generate(self, params, input_embs, *, num_words: int = 32,
                 min_word_tokens: int = 0, temperature: float = 0.0,
                 top_p: float = 1.0, ret_scale_factor: float = 1.0,
                 gen_scale_factor: float = 1.0, max_img_runs: int = 1,
                 generator: Optional[torch.Generator] = None,
                 kv_int8: bool = False):
        """KV-cached decoding with the reference's [IMG] logic
        (gill/models.py:443-532): [IMG1..n) banned; no [IMG0] before
        min_word_tokens sampling iterations; |logit| * ret * gen boost on
        [IMG0] when the product exceeds 1; emitting [IMG0] force-commits
        [IMG1..n) without consuming sampling iterations. Runs at most
        num_words + (num_tokens - 1) * max_img_runs steps; steps past the
        last sampling iteration emit pad and are marked invalid.

        kv_int8: an int8 KV cache with per-token-per-head scales
        (models/opt.py init_cache).

        Returns tokens (B, S) int32, hidden (B, S, E) — the tapped LM
        stream (cfg.text_emb_layers[0]) at each emitted token — and
        valid (B, S) bool."""
        cfg = self.cfg
        b, t_in, _ = input_embs.shape
        dev = input_embs.device
        nt = cfg.num_tokens
        steps = num_words + (nt - 1) * max_img_runs
        e0 = cfg.text_emb_layers[0]
        final_tap = e0 in (-1, self.opt_cfg.num_layers)

        lm_head = self.lm_head_table(params).to(input_embs.dtype)
        cache = opt_mod.init_cache(self.opt_cfg, b, t_in + steps, device=dev,
                                   dtype=input_embs.dtype, kv_int8=kv_int8)
        pre = opt_mod.forward(params["lm"], self.opt_cfg, input_embs,
                              cache=cache, cache_pos=0, skip_logits=True)
        logits = pre["last_hidden"][:, t_in - 1].float() @ lm_head.float().t()

        img0 = self.img_start
        scale = ((ret_scale_factor if ret_scale_factor > 1 else 1.0)
                 * (gen_scale_factor if gen_scale_factor > 1 else 1.0))
        iter_count = torch.zeros(b, dtype=torch.int64, device=dev)
        force_k = torch.zeros(b, dtype=torch.int64, device=dev)
        tokens, hidden, valid = [], [], []
        for step in range(steps):
            logits = logits.clone()
            logits[:, img0 + 1:img0 + nt] = -torch.inf
            img_col = logits[:, img0]
            if scale > 1.0:
                img_col = img_col.abs() * scale
            logits[:, img0] = torch.where(iter_count < min_word_tokens,
                                          torch.full_like(img_col, -torch.inf),
                                          img_col)
            sampled = sample(logits, temperature, top_p, generator)
            token = torch.where(force_k > 0, img0 + (nt - force_k), sampled)
            done = (force_k == 0) & (iter_count >= num_words)
            if bool(done.all()):
                break
            token = torch.where(done, torch.full_like(token, self.pad_token_id),
                                token)
            trigger = (force_k == 0) & (token == img0) & ~done
            new_force = torch.where(force_k > 0, force_k - 1,
                                    torch.where(trigger, nt - 1, 0))
            iter_count = torch.where(force_k > 0, iter_count, iter_count + 1)
            force_k = new_force

            emb = self.embed_tokens(params, token[:, None]).to(input_embs.dtype)
            out = opt_mod.forward(params["lm"], self.opt_cfg, emb, cache=cache,
                                  cache_pos=t_in + step, lm_head=lm_head,
                                  collect_hidden=not final_tap)
            tap = out["last_hidden"] if final_tap else out["hidden_states"][e0]
            tokens.append(token)
            hidden.append(tap[:, 0])
            valid.append(~done)
            logits = out["logits"][:, -1]

        n_run = len(tokens)
        e_dim = self.lm_dim if final_tap else self.opt_cfg.hidden_size
        tok = torch.full((b, steps), self.pad_token_id, dtype=torch.int32,
                         device=dev)
        hid = torch.zeros((b, steps, e_dim), dtype=input_embs.dtype, device=dev)
        val = torch.zeros((b, steps), dtype=torch.bool, device=dev)
        if n_run:
            tok[:, :n_run] = torch.stack(tokens, 1).to(torch.int32)
            hid[:, :n_run] = torch.stack(hidden, 1)
            val[:, :n_run] = torch.stack(valid, 1)
        return {"tokens": tok, "hidden": hid, "valid": val}
