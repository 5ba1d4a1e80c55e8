"""GILL core: frozen OPT + frozen CLIP ViT glued by small trainable
adapters, the three-mode training forward (captioning / retrieval /
generation) and the KV-cached decode loop with the [IMG] logic.

Counterpart of gill_tpu/models/gill.py (`GILLCore`). The 8 [IMG] token rows
are a separate (num_tokens, E) adapter that overrides the frozen embedding
table at lookup and lm-head time, so only the adapters tree needs a
gradient. Params layout:
{"lm": opt params, "vision": clip params, "adapters": {...}}.

`forward` keeps gill_tpu's vectorised label masks (`mask_labels`), its
static pair packing for concat_captions (`pack_pairs`) and its [IMG]-window
gather. In a training forward the LM's inputs need a gradient, so the
dispatcher and the linear layers take their plain paths there (no kernel
has a backward); the frozen CLIP tower needs none and runs its kernels.

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

IGNORE = -100


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

    def init_params(self, init: nn.Init) -> dict:
        """Random frozen trees (the LM's table grown to vocab_len) and
        adapters, all from `init`'s generator."""
        lm = opt_mod.resize_embeddings(opt_mod.init(init, self.opt_cfg),
                                       self.vocab_len, init)
        return {"lm": lm, "vision": clip_mod.init_vision(init, self.vis_cfg),
                "adapters": self.init_adapters(init)}

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

    def renorm_img_embeddings(self, params):
        """Rescales each [IMG] row to the mean norm of the frozen rows
        (reference main.py:602-607); returns params with the new adapter
        leaf (the other leaves shared)."""
        table = params["lm"]["embed_tokens"]["weight"]
        frozen = table[: self.vocab_len - self.cfg.num_tokens]
        target = torch.linalg.vector_norm(frozen.float(), dim=1).mean()
        old = params["adapters"]["img_embeddings"]
        img = old.float()
        norms = torch.linalg.vector_norm(img, dim=1, keepdim=True)
        img = img * (target / norms.clamp_min(1e-8))
        return {**params, "adapters": {**params["adapters"],
                                       "img_embeddings": img.to(old.dtype)}}

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

    # -- label masking (vectorised) ---------------------------------------------

    def _is_img(self, tokens, include_first: bool):
        rel = tokens - self.img_start
        return (rel >= (0 if include_first else 1)) & \
            (rel < self.cfg.num_tokens)

    def mask_labels(self, tokens, mode: str):
        """tokens (B, T) -> labels with IGNORE from the first trigger on.

        captioning: trigger = pad or any [IMG]   (reference models.py:218-227)
        ret/gen:    trigger = pad or [IMG1..n)   (models.py:289-297, 357-361)
        """
        trig = (tokens == self.pad_token_id) | \
            self._is_img(tokens, mode == "captioning")
        masked = torch.cumsum(trig.int(), dim=1) > 0
        return torch.where(masked, torch.full_like(tokens, IGNORE), tokens)

    def first_pad_idx(self, tokens, mode: str = "retrieval"):
        """Packing split point per row (reference `pad_idx`): the first pad
        for ret/gen; the first pad or any [IMG] for captioning (the [IMG]
        run is left out of the packed content there). T if no trigger."""
        t = tokens.shape[1]
        trig = tokens == self.pad_token_id
        if mode == "captioning":
            trig = trig | self._is_img(tokens, True)
        first = torch.argmax(trig.int(), dim=1)
        return torch.where(trig.any(dim=1), first, torch.full_like(first, t))

    # -- static pair packing (concat_captions) -----------------------------------

    def pack_pairs(self, embs, labels, valid_len, bos_pos: int, last_idx):
        """Packs example pairs (2i, 2i+1) into rows of length 2T-1, dropping
        the second example's BOS (reference models.py:230-271/302-355 as a
        static gather).

        embs (B, T, D); labels (B, T); valid_len (B,) = first-pad index;
        bos_pos: the position of BOS in each row (n_visual_tokens (+ the
        prefix) for captioning, the prefix length for ret/gen); last_idx
        (B,) the position of the last [IMG].

        Returns packed (B/2, 2T-1, D), labels (B/2, 2T-1) and
        last_idx_pair (B/2, 2)."""
        b, t, d = embs.shape
        if b % 2:
            raise ValueError(f"pack_pairs needs an even batch, got {b}")
        dev = embs.device
        a_e, b_e = embs[0::2], embs[1::2]
        a_l, b_l = labels[0::2], labels[1::2]
        len_a = valid_len[0::2]
        # drop the second BOS: positions >= bos_pos shift left by one
        pos = torch.arange(t - 1, device=dev)
        b_gather = torch.where(pos >= bos_pos, pos + 1, pos)
        b_e2, b_l2 = b_e[:, b_gather], b_l[:, b_gather]

        p = torch.arange(2 * t - 1, device=dev)[None, :]      # (1, 2T-1)
        from_a = p < len_a[:, None]
        a_idx = p.clamp(0, t - 1).expand(b // 2, -1)
        b_idx = (p - len_a[:, None]).clamp(0, t - 2)

        def rows(x, idx):
            return torch.gather(x, 1, idx[..., None].expand(-1, -1, d))

        packed_e = torch.where(from_a[..., None], rows(a_e, a_idx),
                               rows(b_e2, b_idx))
        packed_l = torch.where(from_a, torch.gather(a_l, 1, a_idx),
                               torch.gather(b_l2, 1, b_idx))
        last_pair = torch.stack([last_idx[0::2],
                                 len_a + last_idx[1::2] - 1], dim=1)
        return packed_e, packed_l, last_pair

    # -- training forward ----------------------------------------------------------

    def forward(self, params, pixel_values, tokens, caption_len, *,
                mode: str = "captioning", concat_captions: bool = False,
                prefix_ids: Optional[torch.Tensor] = None,
                remat: bool = False):
        """One mode of the multi-task step (reference GILLModel.forward,
        gill/models.py:164-441; gill_tpu `GILLCore.forward`).

        pixel_values: (B, H, W, 3); tokens: (B, T) [caption + [IMG0..n) +
        pads]; caption_len: (B,) attention-mask sums; prefix_ids: prompt
        token ids (e.g. "A picture of") or None; remat: recompute each LM
        layer in the backward (models/opt.py forward).

        Returns a dict: logits, full_labels, visual_embs, visual_embs_norm,
        input_embs_norm, ce_loss and, for retrieval / generation,
        last_embedding, last_output_logit and llm_hidden."""
        cfg = self.cfg
        tokens = tokens.long()
        b = tokens.shape[0]
        dev = tokens.device
        visual_embs = self.get_visual_embs(params, pixel_values, mode)
        visual_norm = visual_embs.float().pow(2).sum(-1).sqrt().mean()

        text_embs = self.embed_tokens(params, tokens)
        input_norm = text_embs.float().pow(2).sum(-1).sqrt().mean()
        last_idx = caption_len.long() - 1   # token before the EOS pad

        prefix_embs = None
        n_prefix = 0
        if prefix_ids is not None:
            prefix_ids = prefix_ids.long()
            n_prefix = prefix_ids.shape[0]
            prefix_embs = self.embed_tokens(params, prefix_ids)[None].expand(
                b, n_prefix, self.lm_dim)

        def ignore(n):
            return torch.full((b, n), IGNORE, dtype=torch.long, device=dev)

        if mode == "captioning":
            parts = [visual_embs.to(text_embs.dtype)]
            if prefix_embs is not None:
                parts.append(prefix_embs)
            cond_len = sum(x.shape[1] for x in parts)
            embs = torch.cat(parts + [text_embs], dim=1)
            labels = torch.cat([ignore(cond_len),
                                self.mask_labels(tokens, mode)], dim=1)
            last_idx = last_idx + cond_len
            bos_pos = cond_len
            valid_len = self.first_pad_idx(tokens, mode) + cond_len
        else:
            labels = self.mask_labels(tokens, mode)
            embs = text_embs
            if prefix_embs is not None:
                embs = torch.cat([prefix_embs, text_embs], dim=1)
                labels = torch.cat([ignore(n_prefix), labels], dim=1)
                last_idx = last_idx + n_prefix
            bos_pos = n_prefix
            valid_len = self.first_pad_idx(tokens, mode) + n_prefix

        if concat_captions:
            embs, labels, last_pair = self.pack_pairs(
                embs, labels, valid_len, bos_pos, last_idx)
        else:
            last_pair = last_idx[:, None]                      # (B, 1)

        specs = self.tap_specs()
        n_layers = self.opt_cfg.num_layers
        need_hidden = any(e not in (-1, n_layers) for _, e, _ in specs)
        out = opt_mod.forward(params["lm"], self.opt_cfg, embs, remat=remat,
                              lm_head=self.lm_head_table(params),
                              collect_hidden=need_hidden)
        logits, hidden = out["logits"], out["last_hidden"]
        result = {"logits": logits, "full_labels": labels,
                  "visual_embs": visual_embs, "visual_embs_norm": visual_norm,
                  "input_embs_norm": input_norm,
                  "ce_loss": opt_mod.loss_fn(logits, labels)}
        if mode == "captioning":
            return result

        nt = cfg.num_tokens
        # the num_tokens-wide [IMG] window ending at each last-idx
        # (models.py:383-387), for every packed sub-example
        win = last_pair[..., None] - (nt - 1) + torch.arange(nt, device=dev)
        bp = win.shape[0] * win.shape[1]
        flat = win.reshape(win.shape[0], -1)                   # (B, P*nt)

        def gat(x):
            idx = flat[..., None].expand(-1, -1, x.shape[-1])
            return torch.gather(x, 1, idx).reshape(bp, nt, x.shape[-1])

        win_embs = gat(embs)
        # map each tapped layer's window states and SUM the mapper outputs
        # (reference gill/models.py:383-387, 417-422)
        kind = "ret" if mode == "retrieval" else "gen"
        mapped = None
        for suffix, e, in_dim in specs:
            tap = hidden if e in (-1, n_layers) else out["hidden_states"][e]
            win_hidden = gat(tap)
            mcfg = (self.ret_mapper_cfg_for(in_dim) if kind == "ret"
                    else self.gen_mapper_cfg_for(in_dim))
            m = mapper_mod.apply(params["adapters"][f"{kind}_fc{suffix}"],
                                 mcfg, win_hidden, win_embs)
            mapped = m if mapped is None else mapped + m
            if suffix == "":
                result["llm_hidden"] = win_hidden

        logit_pos = (last_pair - 1).clamp_min(0)
        result["last_output_logit"] = torch.gather(
            logits, 1, logit_pos[..., None].expand(-1, -1, logits.shape[-1])
        ).reshape(bp, -1)
        if mode == "retrieval":
            ve = visual_embs[:, 0].float()
            ve = ve / torch.linalg.vector_norm(ve, dim=1, keepdim=True)
            le = mapped[:, 0].float()
            le = le / torch.linalg.vector_norm(le, dim=1, keepdim=True)
            scale = params["adapters"]["logit_scale"].exp().float()
            result["visual_embs"] = scale * ve      # (B, R), pre-scaled
            result["last_embedding"] = le           # (B*P, R), normalised
        else:
            result["last_embedding"] = mapped       # (B*P, 77, 768)
        return result

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
