"""Public inference API: the GILL wrapper and load_gill.

Counterpart of gill_tpu/api.py (reference gill/models.py:535-902).
`generate_for_images_and_texts` keeps the signature and the interleaved
output structure:
  [str, {'gen': [(img, score)], 'ret': [(img, 'ret', score)],
         'decision': [label, probs]}, ...]
Decoding, the [IMG]-window hidden states, retrieval top-k, the decision
MLP, GILLMapper and the SD denoise stay on the model's device; token ids,
top-k results and the final images cross to the host.

`generate_for_images_and_texts_batch` serves many prompts at once over
the continuous-batching GILL engine (serve/gill_engine.py), with the same
per-prompt outputs. `lm_weight_precision="w8"` serves int8 LM weights
(models/opt.py quantize_params_w8, the W8 kernel on CUDA);
`kv_cache_precision="int8"` gives the sequential decode an int8 KV cache.
`load_gill(sd_precision="int8")` serves the W8A8 SD UNet, and
`enable_sd_batching` routes SD generations through the cross-request batch
queue (serve/sd_queue.py).

The async methods (`generate_async` -> `finalize_async`, and
`register_prefix_async` / `extend_prefix_async` / `drop_prefix_async` for
chat sessions) serve interleaved prompts through the thread-owned online
GILL engine (serve/online.py `GillOnlineEngine`): concurrent callers share
its slot pool and stream their tokens.

`load_gill(weights_dir=)` reads the frozen backbones from local HF /
diffusers directories (weights/loader.py's search rules, with
GILL_TPU_WEIGHTS_DIR), the SD tokenizer and safety checker from the
diffusers layout, and the reference's `pretrained_ckpt.pth.tar` adapters;
`get_log_likelihood_scores` scores an interleaved sequence. `GILL.__call__`
dispatches the training forward (`GILLCore.forward`) or, with
generate=True, the decode.
"""

from __future__ import annotations

import math
import os
import threading
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from gill_tpu_torch.config import GILLConfig, SDPipelineConfig, tiny_sd_config
from gill_tpu_torch.models import decision as decision_mod
from gill_tpu_torch.models import mapper as mapper_mod
from gill_tpu_torch.models.gill import GILLCore
from gill_tpu_torch.nn.core import Init, tree_map
from gill_tpu_torch.utils import image as image_utils
from gill_tpu_torch.utils.image import truncate_caption

IGNORE = -100


def _run_lookup(tokens, img_runs, img0):
    """hidden_lookup for engine-served generations: the engine's tap ring
    holds run k in row k, so the run starting at token index i is ring row
    `count of [IMG0] in tokens[:i]` (gill_tpu api `_run_lookup`)."""
    def lookup(i):
        k = int(np.sum(np.asarray(tokens)[:i] == img0))
        return img_runs[min(k, img_runs.shape[0] - 1)][None]   # (1, nt, E)
    return lookup


class GILL:
    def __init__(self, core: GILLCore, params: dict, tokenizer, *, device,
                 sd_pipe=None, retrieval_index=None, decision_params=None,
                 num_gen_images: int = 1, lm_weight_precision: str = "bf16",
                 kv_cache_precision: str = "bf16"):
        """lm_weight_precision: "bf16" (the parity default) or "w8" —
        per-output-channel int8 LM weights (models/opt.py
        quantize_params_w8). kv_cache_precision: "bf16" or "int8" — an int8
        KV cache with per-token-per-head scales for the sequential decode
        (the serving engines keep their own pool)."""
        if lm_weight_precision == "w8":
            from gill_tpu_torch.models import opt as opt_mod

            params = dict(params)
            params["lm"] = opt_mod.quantize_params_w8(params["lm"])
        elif lm_weight_precision != "bf16":
            raise ValueError(f"lm_weight_precision {lm_weight_precision!r}")
        if kv_cache_precision not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_precision {kv_cache_precision!r}")
        self.kv_int8 = kv_cache_precision == "int8"
        self._serve_engines = {}
        self._online_engines = {}
        self._online_lock = threading.Lock()
        self.core = core
        self.params = params
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.sd_pipe = sd_pipe
        self.sd_batcher = None
        self.index = retrieval_index
        self.decision_params = decision_params
        self.num_gen_images = num_gen_images
        self.idx2dec = decision_mod.IDX2DEC

    def __call__(self, images, tgt_tokens=None, caption_len=None,
                 generate: bool = False, num_words: int = 32,
                 temperature: float = 1.0, top_p: float = 1.0,
                 ret_scale_factor: float = 1.0, gen_scale_factor: float = 1.0,
                 min_word_tokens: int = 0, mode: str = "captioning",
                 concat_captions: bool = False, input_prefix=None,
                 generator: Optional[torch.Generator] = None):
        """Train-forward vs generate dispatch (reference GILL.__call__,
        gill/models.py:563-580). `images` is pixel values (B, H, W, 3) for
        the forward, or prompt embeddings (B, T, E) when generate=True."""
        if generate:
            return self.core.generate(
                self.params, images, num_words=num_words,
                temperature=temperature, top_p=top_p,
                min_word_tokens=min_word_tokens,
                ret_scale_factor=ret_scale_factor,
                gen_scale_factor=gen_scale_factor, generator=generator,
                kv_int8=self.kv_int8)
        prefix_ids = None
        if input_prefix:
            prefix_ids = torch.tensor(
                self.tokenizer.encode(input_prefix, add_special_tokens=False),
                dtype=torch.long, device=self.device)
        return self.core.forward(self.params, images, tgt_tokens, caption_len,
                                 mode=mode, concat_captions=concat_captions,
                                 prefix_ids=prefix_ids)

    # -- prompt assembly -------------------------------------------------------

    def _encode_prompts(self, prompts: List, always_add_bos: bool = False,
                        add_bos: bool = True):
        """Interleaved [PIL.Image | str] -> (embs (1, T, E) fp32, ids (1, T)
        with IGNORE at image positions). BOS is added once unless
        always_add_bos (reference models.py:600-626). add_bos=False: these
        prompts CONTINUE a sequence (the suffix after a registered serving
        prefix, which holds the BOS already)."""
        embs, ids = [], []
        for p in prompts:
            if isinstance(p, Image.Image):
                px = image_utils.clip_preprocess(p, self.core.cfg.image_size)
                px = torch.from_numpy(px)[None].to(self.device)
                v = self.core.get_visual_embs(self.params, px, "captioning")
                embs.append(v)
                ids.append(np.full((1, v.shape[1]), IGNORE, np.int32))
            elif isinstance(p, str):
                tids = self.tokenizer.encode(p, add_special_tokens=add_bos)
                if not always_add_bos:
                    add_bos = False
                tids = np.asarray([tids], np.int32)
                t = torch.from_numpy(tids).long().to(self.device)
                embs.append(self.core.embed_tokens(self.params, t))
                ids.append(tids)
            else:
                raise ValueError(
                    f"Input prompts should be PIL.Image.Image or str, got "
                    f"{type(p)}")
        return (torch.cat([e.float() for e in embs], dim=1),
                np.concatenate(ids, axis=1))

    # -- main API ---------------------------------------------------------------

    def generate_for_images_and_texts(
            self, prompts: List, num_words: int = 0, min_word_tokens: int = 0,
            ret_scale_factor: float = 1.0, gen_scale_factor: float = 1.0,
            top_p: float = 1.0, temperature: float = 0.0,
            max_num_rets: int = 1, generator: Optional[torch.Generator] = None,
            always_add_bos: bool = False, guidance_scale: float = 7.5,
            num_inference_steps: int = 50):
        """See reference gill/models.py:582-762 for the contract.
        `generator` (on the model's device) drives sampling and the SD
        latents; None = a generator seeded with 0."""
        input_embs, _ = self._encode_prompts(prompts, always_add_bos)
        if num_words <= 0:
            raise NotImplementedError(
                "Generation not implemented for num_words=0.")
        if len(self.core.cfg.text_emb_layers) != 1:
            raise ValueError(f"inference taps one LM layer, got "
                             f"{self.core.cfg.text_emb_layers}")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        out = self.core.generate(
            self.params, input_embs, num_words=num_words,
            min_word_tokens=min_word_tokens, temperature=temperature,
            top_p=top_p, ret_scale_factor=ret_scale_factor,
            gen_scale_factor=gen_scale_factor, max_img_runs=max_num_rets,
            generator=generator, kv_int8=self.kv_int8)
        valid = out["valid"][0].cpu().numpy()
        tokens = out["tokens"][0].cpu().numpy()[valid]
        hidden = out["hidden"][0]                             # (S, E)
        nt = self.core.cfg.num_tokens
        return self._postprocess_generation(
            tokens, lambda i: hidden[None, i: i + nt, :], max_num_rets,
            generator, guidance_scale, num_inference_steps)

    def generate_for_images_and_texts_batch(
            self, prompts_batch: List[List], num_words: int = 32,
            min_word_tokens: int = 0, ret_scale_factor: float = 1.0,
            gen_scale_factor: float = 1.0, top_p: float = 1.0,
            temperature: float = 0.0, max_num_rets: int = 1,
            generator: Optional[torch.Generator] = None,
            always_add_bos: bool = False, guidance_scale: float = 7.5,
            num_inference_steps: int = 50, slots: int = 8, chunk: int = 16,
            max_seq: Optional[int] = None):
        """Serves MANY interleaved prompts concurrently over the
        continuous-batching GILL engine (serve/gill_engine.py); returns
        generate_for_images_and_texts' per-prompt outputs in input order
        (gill_tpu api `generate_for_images_and_texts_batch`).
        max_num_rets sizes the engine's tap ring. temperature > 0 samples
        with per-request streams seeded from `generator`, independent of
        slot packing, so they differ from the sequential path's draws. On
        CUDA the engine keeps a bf16 KV pool and bf16 request embeddings;
        on the CPU fp32, as gill_tpu does off a TPU."""
        from gill_tpu_torch.serve.gill_engine import (GillDecodeEngine,
                                                      GillServeRequest)

        if num_words <= 0:
            raise NotImplementedError(
                "Generation not implemented for num_words=0.")
        if len(self.core.cfg.text_emb_layers) != 1:
            raise ValueError(f"inference taps one LM layer, got "
                             f"{self.core.cfg.text_emb_layers}")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        scale = max(ret_scale_factor, 1.0) * max(gen_scale_factor, 1.0)
        emb_dt = self._serve_dtype()
        base_seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                      device=generator.device))
        reqs = []
        for uid, prompts in enumerate(prompts_batch):
            embs, _ = self._encode_prompts(prompts, always_add_bos)
            reqs.append(GillServeRequest(
                uid=uid, embs=embs[0].to(emb_dt), num_words=num_words,
                min_word_tokens=min_word_tokens, img_scale=scale,
                temperature=temperature, top_p=top_p,
                seed=(base_seed + uid) % (2**31 - 1),
                max_img_runs=max_num_rets))
        if not reqs:
            return []
        nt = self.core.cfg.num_tokens
        if max_seq is None:
            longest = max(r.embs.shape[0] for r in reqs)
            max_seq = -(-(longest + num_words + nt * max_num_rets) // 64) * 64
        sampling = temperature > 0
        # one engine per (slots, chunk, sampling): a longer batch or a
        # deeper tap ring REPLACES it with a larger one
        key = (slots, chunk, sampling)
        eng = self._serve_engines.get(key)
        if eng is None or eng.max_seq < max_seq \
                or eng.max_runs < max_num_rets:
            if self.kv_int8:
                import warnings

                warnings.warn("kv_cache_precision='int8' applies to the "
                              "sequential decode path; the serving engines "
                              "use a bf16 KV pool", stacklevel=2)
            runs = max_num_rets
            if eng is not None:
                max_seq = max(max_seq, eng.max_seq)
                runs = max(runs, eng.max_runs)
                del self._serve_engines[key], eng    # free the old pool first
            eng = GillDecodeEngine(
                self.core, self.params, slots=slots, max_seq=max_seq,
                chunk=chunk, kv_dtype=emb_dt, sampling=sampling,
                max_img_runs=runs)
            self._serve_engines[key] = eng
        served = eng.run(reqs)

        outputs = []
        img0 = self.core.img_start
        for uid in range(len(prompts_batch)):
            res = served[uid]
            tokens = np.asarray(res["tokens"], np.int32)
            img_runs = torch.from_numpy(res["img_runs"]).to(self.device)
            outputs.append(self._postprocess_generation(
                tokens, _run_lookup(tokens, img_runs, img0), max_num_rets,
                generator, guidance_scale, num_inference_steps))
        return outputs

    def _postprocess_generation(self, tokens, hidden_lookup, max_num_rets,
                                generator, guidance_scale,
                                num_inference_steps):
        """Newline truncation, [IMG]-run detection and the per-run
        retrieval / decision / SD-generation branches (reference
        models.py:635-762). tokens: 1-D int32 array of the valid generated
        ids; hidden_lookup(i) -> (1, num_tokens, E) hidden states of the run
        starting at token index i."""
        nl_id = self.tokenizer.encode("\n", add_special_tokens=False)[0]
        nl = np.nonzero(tokens == nl_id)[0]
        if len(nl) and nl[0] > 0:
            tokens = tokens[: nl[0]]

        nt = self.core.cfg.num_tokens
        img0 = self.core.img_start
        ret_starts = [int(i) for i in np.nonzero(tokens == img0)[0]
                      ][:max_num_rets]
        # only complete contiguous [IMG0..n) runs (models.py:661)
        ret_starts = [
            i for i in ret_starts
            if i + nt <= len(tokens)
            and tokens[i:i + nt].tolist() == list(range(img0, img0 + nt))]

        return_outputs: List = []
        if not ret_starts:
            caption = self.tokenizer.decode(tokens, skip_special_tokens=True)
            return_outputs.append(truncate_caption(caption))
            return return_outputs

        gen_prefix = "".join(f"[IMG{i}]" for i in range(nt))
        gen_prefix_ids = torch.tensor(
            [self.tokenizer.encode(gen_prefix, add_special_tokens=False)],
            device=self.device)
        gen_prefix_embs = self.core.embed_tokens(self.params, gen_prefix_ids)

        seen_image_idx: List[int] = []
        last_ret_idx = 0
        for ret_idx in ret_starts:
            raw_emb = hidden_lookup(ret_idx)                  # (1, nt, E)
            image_outputs = {"gen": [], "ret": [], "decision": None}

            ret_emb = None
            if self.index is not None:
                ret_emb = mapper_mod.apply(
                    self.params["adapters"]["ret_fc"], self.core.ret_mapper_cfg,
                    raw_emb, None)[:, 0, :]
                ret_emb = ret_emb / torch.linalg.vector_norm(
                    ret_emb, dim=-1, keepdim=True)
                scores, top_idx = self.index.topk(ret_emb[0], k=3,
                                                  seen_idx=seen_image_idx)
                # stop after max_num_rets retrieved images (the reference's
                # evident intent, see gill_tpu/api.py)
                for s, i in zip(scores, top_idx):
                    try:
                        seen_image_idx.append(int(i))
                        img = image_utils.get_image_from_url(
                            self.index.paths[int(i)])
                        image_outputs["ret"].append((img, "ret", float(s)))
                        if len(image_outputs["ret"]) >= max_num_rets:
                            break
                    except Exception:  # bad URL/image: try the next one
                        pass
                if self.decision_params is not None:
                    label, probs = decision_mod.decide(
                        self.decision_params, raw_emb[:, 0, :])
                    image_outputs["decision"] = [label] + probs
            else:
                image_outputs["decision"] = ["gen", [0, 1]]

            # generation embedding via GILLMapper (models.py:706-719)
            gen_emb = mapper_mod.apply(
                self.params["adapters"]["gen_fc"], self.core.gen_mapper_cfg,
                raw_emb, gen_prefix_embs.to(raw_emb.dtype))
            nct = self.core.cfg.num_clip_tokens
            if gen_emb.shape[1] > nct:
                gen_emb = gen_emb[:, :nct]
            elif gen_emb.shape[1] < nct:
                pad = gen_emb.new_zeros((gen_emb.shape[0],
                                         nct - gen_emb.shape[1],
                                         gen_emb.shape[2]))
                gen_emb = torch.cat([gen_emb, pad], dim=1)

            if self.sd_pipe is not None:
                gen_emb_rep = gen_emb.expand(
                    (self.num_gen_images,) + tuple(gen_emb.shape[1:]))
                gen_max_bs = 8    # reference per-request cap, models.py:724
                images = []
                if self.sd_batcher is not None:
                    # cross-request batching: the shared queue coalesces
                    # concurrent callers' latents into one CFG denoise
                    futs = [self.sd_batcher.submit(
                        gen_emb_rep[i:i + gen_max_bs],
                        guidance_scale=guidance_scale,
                        num_inference_steps=num_inference_steps,
                        generator=generator)
                        for i in range(0, self.num_gen_images, gen_max_bs)]
                    for f in futs:
                        images.extend(self._to_pil(f.result()))
                else:
                    for i in range(0, self.num_gen_images, gen_max_bs):
                        arr = self.sd_pipe(
                            prompt_embeds=gen_emb_rep[i:i + gen_max_bs],
                            guidance_scale=guidance_scale,
                            num_inference_steps=num_inference_steps,
                            generator=generator)
                        images.extend(self._to_pil(arr))
                if self.index is not None and ret_emb is not None:
                    # re-rank generated images by CLIP-space retrieval score
                    # (models.py:739-751)
                    px = np.stack([image_utils.clip_preprocess(
                        im.resize((224, 224)).convert("RGB"),
                        self.core.cfg.image_size) for im in images])
                    vis = self.core.get_visual_embs(
                        self.params, torch.from_numpy(px).to(self.device),
                        "retrieval")[:, 0]
                    vis = vis / torch.linalg.vector_norm(vis, dim=-1,
                                                         keepdim=True)
                    rank_scores = (vis.float() @ ret_emb[0].float()
                                   ).cpu().numpy()
                    order = np.argsort(-rank_scores)
                    if self.num_gen_images > 1:
                        image_outputs["gen"] = [
                            (images[int(j)], float(rank_scores[int(j)]))
                            for j in order]
                    else:
                        image_outputs["gen"] = [(images[0],
                                                 float(rank_scores[0]))]
                else:
                    image_outputs["gen"] = [(images[0], 0)]
            else:
                image_outputs["gen"] = [gen_emb.cpu().numpy()]

            caption = self.tokenizer.decode(tokens[last_ret_idx:ret_idx],
                                            skip_special_tokens=True)
            last_ret_idx = ret_idx + 1
            return_outputs.append(truncate_caption(caption) + f" {gen_prefix}")
            return_outputs.append(image_outputs)
        return return_outputs

    def enable_sd_batching(self, max_batch: int = 8, warmup: bool = False,
                           **warmup_kw):
        """Routes this model's SD generations through a shared cross-request
        batch queue (serve/sd_queue.py): concurrent callers' denoises
        coalesce into one <= max_batch-latent CFG batch instead of
        serializing on the device. Each request's initial latents still
        come from its own generator. Returns the queue."""
        if self.sd_batcher is None:
            from gill_tpu_torch.serve.sd_queue import SDBatchQueue

            if self.sd_pipe is None:
                raise ValueError("no SD pipeline attached")
            self.sd_batcher = SDBatchQueue(self.sd_pipe, max_batch=max_batch)
            if warmup:
                self.sd_batcher.warmup(**warmup_kw)
        return self.sd_batcher

    # -- online (streaming) serving -------------------------------------------

    def _serve_dtype(self):
        """The serving engines' KV pool and request embedding dtype: bf16
        on CUDA, fp32 on the CPU (gill_tpu: bf16 on a TPU, else fp32)."""
        return torch.bfloat16 if self.device.type == "cuda" else torch.float32

    def get_online_engine(self, slots: int = 4, chunk: int = 8,
                          max_seq: int = 512, sampling: bool = False,
                          max_img_runs: int = 1):
        """The thread-owned online GILL serving engine for this
        configuration (serve/online.py GillOnlineEngine over
        serve/gill_engine.py), built on first use. Its KV pool is bf16 on
        CUDA (kv_cache_precision="int8" applies to the sequential decode
        only)."""
        from gill_tpu_torch.serve.gill_engine import GillDecodeEngine
        from gill_tpu_torch.serve.online import GillOnlineEngine

        key = (slots, chunk, max_seq, sampling, max_img_runs)
        with self._online_lock:          # concurrent callers build one
            online = self._online_engines.get(key)
            if online is None:
                if self.kv_int8:
                    import warnings

                    warnings.warn("kv_cache_precision='int8' applies to the "
                                  "sequential decode path; the serving "
                                  "engines use a bf16 KV pool", stacklevel=2)
                eng = GillDecodeEngine(self.core, self.params, slots=slots,
                                       max_seq=max_seq, chunk=chunk,
                                       kv_dtype=self._serve_dtype(),
                                       sampling=sampling,
                                       max_img_runs=max_img_runs)
                online = GillOnlineEngine(eng)
                self._online_engines[key] = online
        return online

    def generate_async(self, prompts: List, num_words: int = 32,
                       min_word_tokens: int = 0,
                       ret_scale_factor: float = 1.0,
                       gen_scale_factor: float = 1.0,
                       temperature: float = 0.0, top_p: float = 1.0,
                       seed: int = 0, max_num_rets: int = 1,
                       always_add_bos: bool = False, *, slots: int = 4,
                       chunk: int = 8, max_seq: int = 512,
                       prefix_id: Optional[int] = None):
        """Submits one interleaved prompt to the online serving engine;
        returns a GillRequestHandle whose .tokens stream in (the valid
        prefix) and whose .result() blocks until completion. Concurrent
        callers share the slot pool. Finish with finalize_async() for
        generate_for_images_and_texts' output structure.

        prefix_id (from register_prefix_async): prompts then carry only
        the NEW turn; the prefix's KV rows are reused and no BOS is added
        again."""
        embs, _ = self._encode_prompts(prompts, always_add_bos,
                                       add_bos=prefix_id is None)
        online = self.get_online_engine(slots=slots, chunk=chunk,
                                        max_seq=max_seq,
                                        sampling=temperature > 0,
                                        max_img_runs=max_num_rets)
        scale = max(ret_scale_factor, 1.0) * max(gen_scale_factor, 1.0)
        return online.submit(embs[0].to(self._serve_dtype()), num_words,
                             min_word_tokens=min_word_tokens,
                             img_scale=scale, temperature=temperature,
                             top_p=top_p, seed=seed,
                             max_img_runs=max_num_rets, prefix_id=prefix_id)

    def register_prefix_async(self, prompts: List, *, slots: int = 4,
                              chunk: int = 8, max_seq: int = 512,
                              sampling: bool = False,
                              max_num_rets: int = 1) -> int:
        """Registers a shared conversation prefix (system prompt + history,
        text and images) with the online GILL engine: its KV rows are
        prefilled once, and generate_async calls passing the returned
        prefix_id send only their new prompts. Prefix ids belong to ONE
        engine configuration: pass the same slots / chunk / max_seq /
        sampling / max_num_rets with the follow-ups."""
        embs, _ = self._encode_prompts(prompts)
        online = self.get_online_engine(slots=slots, chunk=chunk,
                                        max_seq=max_seq, sampling=sampling,
                                        max_img_runs=max_num_rets)
        return online.register_prefix(embs[0].to(self._serve_dtype()))

    def extend_prefix_async(self, prefix_id: int, prompts: List, *,
                            slots: int = 4, chunk: int = 8,
                            max_seq: int = 512, sampling: bool = False,
                            max_num_rets: int = 1) -> int:
        """Grows a registered conversation prefix by one turn's prompts
        (e.g. the user turn and the model's reply as a string), prefilling
        only the NEW rows. Returns the new prefix id (the parent stays
        registered; drop_prefix_async frees it)."""
        embs, _ = self._encode_prompts(prompts, add_bos=False)
        online = self.get_online_engine(slots=slots, chunk=chunk,
                                        max_seq=max_seq, sampling=sampling,
                                        max_img_runs=max_num_rets)
        return online.extend_prefix(prefix_id,
                                    embs[0].to(self._serve_dtype()))

    def drop_prefix_async(self, prefix_id: int, *, slots: int = 4,
                          chunk: int = 8, max_seq: int = 512,
                          sampling: bool = False,
                          max_num_rets: int = 1) -> None:
        """Frees a registered prefix's cached KV on the online engine."""
        online = self.get_online_engine(slots=slots, chunk=chunk,
                                        max_seq=max_seq, sampling=sampling,
                                        max_img_runs=max_num_rets)
        online.drop_prefix(prefix_id)

    def finalize_async(self, handle, generator: Optional[torch.Generator]
                       = None, guidance_scale: float = 7.5,
                       num_inference_steps: int = 50,
                       max_num_rets: int = 1):
        """Waits for an async request and runs the retrieval / decision /
        SD post-processing: generate_for_images_and_texts' output
        structure. `generator` (on the model's device) drives the SD
        latents; None = a generator seeded with 0. max_num_rets beyond
        the submit-time tap ring reuses the last captured run."""
        tokens = np.asarray(handle.result(), np.int32)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        img_runs = torch.from_numpy(handle.img_runs).to(self.device)
        return self._postprocess_generation(
            tokens, _run_lookup(tokens, img_runs, self.core.img_start),
            max_num_rets, generator, guidance_scale, num_inference_steps)

    @staticmethod
    def _to_pil(arr) -> List[Image.Image]:
        arr = arr.cpu().numpy()
        return [Image.fromarray((a * 255).round().astype(np.uint8))
                for a in arr]

    def get_log_likelihood_scores(self, prompts: List) -> float:
        """-CE of the interleaved sequence under the LM, image positions
        label-masked (reference models.py:764-807): one causal forward of
        the whole sequence with the tied head (the [IMG] rows swapped in)."""
        from gill_tpu_torch.models import opt as opt_mod

        embs, ids = self._encode_prompts(prompts)
        out = opt_mod.forward(self.params["lm"], self.core.opt_cfg, embs,
                              lm_head=self.core.lm_head_table(self.params))
        loss = opt_mod.loss_fn(out["logits"],
                               torch.from_numpy(ids).to(self.device))
        return -float(loss)


def _to_device(tree, device, dtype=None):
    """numpy / tensor leaves -> tensors on `device` (floating leaves cast to
    `dtype` when given)."""
    def one(x):
        t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        if dtype is not None and torch.is_floating_point(t):
            t = t.to(dtype)
        return t.to(device).contiguous()
    return tree_map(one, tree)


def load_gill(model_dir: str, *, device="cuda", load_ret_embs: bool = True,
              decision_model_fn: Optional[str] = "decision_model.pth.tar",
              weights_dir: Optional[str] = None, load_sd: bool = True,
              num_gen_images: int = 1, dtype=torch.bfloat16, seed: int = 0,
              lm_weight_precision: str = "bf16",
              kv_cache_precision: str = "bf16",
              sd_precision: str = "bf16", mesh=None) -> GILL:
    """Builds an inference GILL from a reference-format checkpoint
    directory: model_args.json, the tokenizer, the adapters
    (`pretrained_ckpt.pth.tar`, else the npz `ckpt/state.npz`, else random),
    the pickled cc3m*.npy retrieval blobs and the decision model (reference
    load_gill, gill/models.py:810-902; gill_tpu/api.py load_gill).

    The frozen backbones come from `weights_dir` or GILL_TPU_WEIGHTS_DIR
    (weights/loader.py: OPT and CLIP from `<root>/<org>--<name>/` or
    `<root>/<name>/`, SD v1.5 from `<root>/stable-diffusion-v1-5/` in the
    diffusers layout with its `tokenizer/` and `safety_checker/`), in
    `dtype` on `device`. What is not found takes random weights with
    gill_tpu's init distributions from a torch.Generator on `device`
    seeded with `seed`, with a warning; the [IMG] rows added to the
    embedding table come from that generator too. The adapters stay fp32.
    GILL_TPU_TINY_SD=1 selects the tiny SD config (the CPU smoke-test
    escape hatch of gill_tpu). The model runs on the card unless `device`
    names another (the CPU tests pass "cpu"); lm_weight_precision /
    kv_cache_precision as in GILL. sd_precision: "bf16" or "int8", the
    opt-in W8A8 SD UNet (unet.quantize_params), of loaded or random
    weights.

    mesh: a `parallel.Mesh`, handed to the retrieval index (as gill_tpu's
    load_gill does), which then keeps this data rank's rows and merges
    the ranks' top-k. The SPMD contract: every rank of the mesh calls
    load_gill and then every API method with the same inputs, in the same
    order (the index's top-k is a collective)."""
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.retrieval import RetrievalIndex, load_embeddings
    from gill_tpu_torch.tokenizer import (GPT2BPETokenizer, load_tokenizer,
                                          setup_gill_tokenizer)
    from gill_tpu_torch.utils import ckpt as ckpt_utils
    from gill_tpu_torch.weights import loader as wloader

    if sd_precision not in ("bf16", "int8"):
        raise ValueError(f"sd_precision {sd_precision!r}")
    device = torch.device(device)
    cfg = GILLConfig.from_json(os.path.join(model_dir, "model_args.json"))
    try:
        tokenizer = load_tokenizer(cfg.opt_version)
    except FileNotFoundError:
        print("WARNING: tokenizer assets missing; tiny byte-level tokenizer.")
        tokenizer = GPT2BPETokenizer.tiny()
    img_ids = setup_gill_tokenizer(tokenizer, cfg.num_tokens)
    core = GILLCore.build(cfg, vocab_len=len(tokenizer), img_start=img_ids[0],
                          pad_token_id=tokenizer.pad_token_id,
                          bos_token_id=tokenizer.bos_token_id)

    gen = torch.Generator(device).manual_seed(seed)
    lm = wloader.load_opt(cfg.opt_version, core.opt_cfg, len(tokenizer),
                          weights_dir, device=device, dtype=dtype,
                          generator=gen)
    vision = wloader.load_clip_vision(cfg.visual_encoder, core.vis_cfg,
                                      weights_dir, device=device, dtype=dtype,
                                      generator=gen)

    ckpt_path = os.path.join(model_dir, "pretrained_ckpt.pth.tar")
    npz = os.path.join(model_dir, "ckpt")
    if os.path.exists(ckpt_path):
        adapters = _to_device(
            ckpt_utils.load_reference_gill_checkpoint(ckpt_path, core),
            device, torch.float32)
    elif os.path.exists(os.path.join(npz, "state.npz")):
        tree, _ = ckpt_utils.load_checkpoint(npz)
        adapters = _to_device(tree["adapters"], device, torch.float32)
    else:
        print("WARNING: no trained adapters found; random init.")
        adapters = core.init_adapters(Init(gen, device, torch.float32))
    params = {"lm": lm, "vision": vision, "adapters": adapters}

    index = None
    if load_ret_embs:
        paths, mat = load_embeddings(model_dir)
        if paths is not None:
            scale = math.exp(float(adapters["logit_scale"]))
            index = RetrievalIndex(paths, mat, scale, device=device,
                                   mesh=mesh)
        else:
            print(f"cc3m*.npy not found in {model_dir}; running without "
                  f"retrieval.")

    decision_params = None
    if decision_model_fn:
        path = os.path.join(model_dir, decision_model_fn)
        if os.path.exists(path):
            decision_params = _to_device(
                ckpt_utils.load_decision_model(path), device, torch.float32)

    sd_pipe = None
    if load_sd:
        if os.environ.get("GILL_TPU_TINY_SD") == "1":
            sd_cfg = tiny_sd_config()
            sd_cfg.unet.cross_attention_dim = cfg.gen_emb_dim
            sd_cfg.text.max_positions = cfg.num_clip_tokens
        else:
            sd_cfg = SDPipelineConfig()
        sd_params, sd_tok, checker = wloader.load_sd(
            "stable-diffusion-v1-5", sd_cfg, weights_dir, device=device,
            dtype=dtype, generator=gen)
        sd_pipe = StableDiffusionPipeline(
            sd_cfg, sd_params, tokenizer=sd_tok, safety_checker=checker,
            quantize=(sd_precision == "int8"))

    return GILL(core, params, tokenizer, device=device, sd_pipe=sd_pipe,
                retrieval_index=index, decision_params=decision_params,
                num_gen_images=num_gen_images,
                lm_weight_precision=lm_weight_precision,
                kv_cache_precision=kv_cache_precision)

