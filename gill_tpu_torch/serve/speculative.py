"""Speculative decoding for low-latency single-stream serving (counterpart
of gill_tpu/serve/speculative.py).

The target model's decode step streams its whole weight set from device
memory per token, so at batch 1 the card is mostly idle between weight
reads. A small DRAFT model proposes k tokens cheaply; the target scores
all of them in ONE multi-token cached forward and commits the longest
prefix it agrees with, plus its own correction token. Greedy outputs are
the target's own greedy outputs (for any draft), up to ties between the
verify window's and a one-token step's arithmetic: the draft changes the
speed, not the content.

A round:
  * draft: k one-token decode steps of the draft at positions pos ..
    pos + k - 1 (token ids and positions stay on the device; a (1,)
    position takes models/opt.py's per-row decode, the valid-prefix
    kernel on the card);
  * verify: one target forward over the (k + 1)-token window [last, d_1 ..
    d_k] at cache offset pos (models/opt.py's multi-token cached path:
    query i attends keys <= pos + i);
  * acceptance: the prefix of drafts equal to the target's argmax, capped
    at k - 1 (the draft wrote KV rows for [last, d_1 .. d_{k-1}] only), so
    a round commits between 1 and k tokens;
  * rollback is free: rejected tokens' KV rows sit where the next round's
    windows write them again.
The accepted count comes to the host once a round, so the next round's
offset is a Python int (the cached multi-token path takes an int offset).
Rounds run in batches of `rounds_per_call`, as gill_tpu's do, so
`last_stats` counts the same rounds. gill_tpu's mechanisms that serve XLA
(jit, the `lax.scan` over rounds and draft steps, `unroll_layers`, the
draft's deferred KV write) are not needed in eager PyTorch;
`unroll_layers` is accepted and ignored.

Greedy plain-text serving only; the GILL [IMG] decode stays in
models/gill.py and the serving engines.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gill_tpu_torch.config import OPTConfig
from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.serve.engine import to_device


class SpeculativeDecoder:
    """Greedy two-model speculative decoding, batch 1.

    tparams/tcfg: the serving (target) model; dparams/dcfg: the draft,
    on the target's device. Both share a vocabulary (e.g. two OPT sizes).
    k: draft tokens a round (a round commits 1 to k tokens). kv_dtype: both
    caches' dtype (bf16 or fp32)."""

    def __init__(self, tparams, tcfg: OPTConfig, dparams, dcfg: OPTConfig,
                 *, k: int = 8, max_seq: int = 512,
                 prefill_buckets=(64, 128, 256, 512),
                 rounds_per_call: int = 8, eos_id: Optional[int] = None,
                 pad_id: int = 1, unroll_layers: bool = True,
                 kv_dtype=torch.bfloat16):
        del unroll_layers            # the port always loops over layer views
        if tcfg.vocab_size != dcfg.vocab_size:
            raise ValueError("speculative decoding needs a shared vocabulary:"
                             f" {tcfg.vocab_size} vs {dcfg.vocab_size}")
        if kv_dtype == torch.int8:
            raise ValueError("the speculative decoder keeps a bf16 or fp32 "
                             "KV cache (the multi-token cached path has no "
                             "int8 form)")
        if k < 1:
            raise ValueError(f"k {k} < 1")
        self.tparams, self.tcfg = tparams, tcfg
        self.dparams, self.dcfg = dparams, dcfg
        self.device = tparams["embed_tokens"]["weight"].device
        # the tied heads in fp32, made once (see serve/engine.py)
        self._thead = tparams["embed_tokens"]["weight"].float()
        self._dhead = dparams["embed_tokens"]["weight"].float()
        self.k = k
        self.max_seq = max_seq
        buckets = sorted(set(b for b in prefill_buckets if b <= max_seq))
        if not buckets or buckets[-1] < max_seq:
            # every admissible prompt must find a bucket
            buckets.append(max_seq)
        self.buckets = tuple(buckets)
        self.rounds = rounds_per_call
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.kv_dtype = kv_dtype
        # last generate()'s acceptance: {"rounds", "accepted", "k"}; the
        # acceptance rate is accepted / (rounds * (k - 1)) of the REFUTABLE
        # draft positions (a round commits >= 1 token whatever the draft)
        self.last_stats = None

    # -- device work ---------------------------------------------------------

    def _prefill(self, prompt: List[int]):
        """Both caches with the prompt's rows (padded to its bucket) and the
        target's first greedy token (a host int)."""
        plen = len(prompt)
        pb = next(b for b in self.buckets if b >= plen)
        toks = np.full((1, pb), self.pad_id, np.int64)
        toks[0, :plen] = prompt
        ids = to_device(toks, self.device)
        caches, hidden = [], []
        for params, cfg in ((self.tparams, self.tcfg),
                            (self.dparams, self.dcfg)):
            cache = opt_mod.init_cache(cfg, 1, self.max_seq,
                                       device=self.device,
                                       dtype=self.kv_dtype)
            out = opt_mod.forward(params, cfg,
                                  opt_mod.embed_tokens(params, ids),
                                  cache=cache, cache_pos=0, skip_logits=True)
            caches.append(cache)
            hidden.append(out["last_hidden"][0, plen - 1])
        first = int((hidden[0].float() @ self._thead.t()).argmax())
        return caches[0], caches[1], first

    def _round(self, tcache, dcache, pos: int, last: torch.Tensor):
        """One draft + verify round at offset `pos` after the committed token
        `last` ((1,) on the device). Returns (the next pos, the next last,
        the committed tokens (n + 1,) on the device)."""
        k = self.k
        tok, drafts = last.view(1, 1), []
        # the draft's positions as a (1,) tensor: the per-row decode path,
        # which reads the whole cache up to its valid length, so on the
        # card the valid-prefix kernel takes every draft step
        dpos = torch.full((1,), pos, dtype=torch.int32, device=self.device)
        for j in range(k):
            out = opt_mod.forward(self.dparams, self.dcfg,
                                  opt_mod.embed_tokens(self.dparams, tok),
                                  cache=dcache, cache_pos=dpos + j,
                                  lm_head=self._dhead)
            tok = out["logits"][0, -1].argmax().view(1, 1)
            drafts.append(tok.view(1))
        drafts = torch.cat(drafts)                                # (k,)
        window = torch.cat([last.view(1), drafts])                # (k + 1,)
        out = opt_mod.forward(self.tparams, self.tcfg,
                              opt_mod.embed_tokens(self.tparams,
                                                   window[None]),
                              cache=tcache, cache_pos=pos,
                              lm_head=self._thead)
        agree = out["logits"][0].argmax(-1)                       # (k + 1,)
        # the agreeing prefix, capped at k - 1: the draft has no KV row for
        # d_k, so committing it would leave a hole (one host sync a round)
        n = min(int((drafts == agree[:-1]).long().cumprod(0).sum()), k - 1)
        return pos + n + 1, agree[n:n + 1], torch.cat([drafts[:n],
                                                       agree[n:n + 1]])

    # -- host loop -----------------------------------------------------------

    @torch.no_grad()
    def generate(self, prompt: List[int], max_new_tokens: int) -> List[int]:
        """Greedy generation with the target's tokens (the draft affects
        only the wall clock)."""
        plen = len(prompt)
        # worst case: one rounds-batch past the last needed token (up to
        # rounds * k commits) plus the final verify window (k + 1 rows)
        need = plen + max_new_tokens + self.rounds * self.k + self.k + 1
        if need > self.max_seq:
            raise ValueError(
                f"prompt {plen} + {max_new_tokens} new (+ round slack "
                f"{self.rounds * self.k + self.k + 1}) exceeds max_seq "
                f"{self.max_seq}")
        tcache, dcache, first = self._prefill([int(t) for t in prompt])
        out = [first]
        if self.eos_id is not None and out[-1] == self.eos_id:
            return out
        pos = plen
        last = torch.tensor([first], dtype=torch.long, device=self.device)
        stats = {"rounds": 0, "accepted": 0, "k": self.k}
        self.last_stats = stats
        while len(out) < max_new_tokens:
            blocks, counts = [], []
            for _ in range(self.rounds):
                pos, last, committed = self._round(tcache, dcache, pos, last)
                blocks.append(committed)
                counts.append(int(committed.shape[0]))
            stats["rounds"] += self.rounds
            stats["accepted"] += sum(counts) - self.rounds
            stop = False
            for t in torch.cat(blocks).tolist():
                out.append(int(t))
                if (len(out) >= max_new_tokens
                        or (self.eos_id is not None
                            and out[-1] == self.eos_id)):
                    stop = True
                    break
            if stop:
                break
        return out[:max_new_tokens]
