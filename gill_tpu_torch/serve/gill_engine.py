"""Continuous-batching serving of the full GILL decode (counterpart of
gill_tpu/serve/gill_engine.py).

serve/engine.py serves a plain LM; this engine serves GILLCore's decode
semantics (reference GILLModel.generate, gill/models.py:443-532) over the
same slot pool:

  * prompts are interleaved image + text EMBEDDING sequences (api.GILL
    `_encode_prompts`), so prefill plants (R, P, E) embeddings;
  * every step applies the reference's logit surgery per slot with
    per-request parameters: [IMG1..n) banned, no [IMG0] before
    `min_word_tokens` sampling iterations, |logit| * scale on [IMG0], and
    an emitted [IMG0] force-commits [IMG1..n);
  * the hidden state of each fed [IMG] token (at text_emb_layers[0]) is
    captured on the device into a per-slot ring of `max_img_runs` x
    `num_tokens` rows: a fed [IMG0] advances the slot's run counter, so run
    k lands in ring row k;
  * scheduling is the pipelined closed-budget scheduler: a request runs
    num_words + (num_tokens - 1) * max_img_runs steps with no EOS, so
    refills are planned on the host and chunks follow each other without
    waiting for the host;
  * register_prefix() caches an embedding prefix's KV rows, so later turns
    prefill only their suffix;
  * sampling=True: per-slot temperature / top-p, each draw the inverse CDF
    at a uniform from a torch.Generator seeded from (request seed,
    position) (ops/sampling.py `uniform_for`), so a request's stream does
    not depend on its slot or chunk. gill_tpu folds the position into a
    threefry key, whose bits this does not reproduce.
The KV pool is bf16 or fp32 (gill_tpu refuses int8 here too). `mesh`:
tensor-parallel serving as serve/engine.py's (this rank's shard of the
LM's matrices, the pool sharded by heads; the [IMG]-merged embedding
table, the tap ring and the scheduler state replicated), with the same
SPMD contract: every rank of the model group builds the engine from the
same parameters and submits the same requests in the same order; sampled
draws come from (request seed, position), the same on every rank.
`unroll_layers` is not ported.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.ops.sampling import sample_per_row, uniform_for
from gill_tpu_torch.parallel.partition import local_heads, shard_params
from gill_tpu_torch.serve.engine import (HostCopy, _bucket, head_rows,
                                         kv_read_ladder, pool_window_hi,
                                         to_device)


@dataclass
class GillServeRequest:
    uid: int
    embs: object                   # (P, E) prompt embeddings (tensor or
                                   # array); with prefix_id: the SUFFIX rows
    num_words: int
    min_word_tokens: int = 0
    img_scale: float = 1.0         # ret_scale * gen_scale boost on [IMG0]
    max_img_runs: int = 1
    temperature: float = 0.0       # 0 = greedy; > 0 needs sampling=True
    top_p: float = 1.0
    seed: int = 0                  # per-request sampling stream
    prefix_id: Optional[int] = None  # from GillDecodeEngine.register_prefix


@dataclass
class _GSlot:
    uid: int
    budget: int                    # fed decode steps still to cover
    start: int = 0                 # prompt length: the first fed position
    seed: int = 0
    generated: List[int] = field(default_factory=list)
    valid: List[bool] = field(default_factory=list)
    fresh: bool = True
    planned: int = 0               # FED steps covered by dispatched chunks
    fed: int = 0                   # FED steps covered by COLLECTED blocks
    prefix_ok: bool = True         # valid prefix still unbroken (latches;
                                   # online streaming, serve/online.py)
    done: bool = False


def _rows(embs) -> int:
    return int(embs.shape[0])


class GillDecodeEngine:
    """Slot-pooled continuous batching over a GILLCore parameter tree.

    core: models.gill.GILLCore; params: {"lm", "vision", "adapters"}. The
    engine runs on the LM params' device with a `kv_dtype` pool. mesh: a
    `parallel.Mesh` to serve tensor-parallel over its "model" group
    (`params` full; the engine keeps this rank's shard). device: with
    `mesh`, where this rank's shard goes (default the LM params' device),
    so a tree on the host puts only the shard on the card."""

    def __init__(self, core, params, *, slots: int = 8, max_seq: int = 512,
                 chunk: int = 16, prefill_buckets=(64, 128, 256),
                 kv_dtype=torch.bfloat16, sampling: bool = False,
                 max_img_runs: int = 1, kv_read_buckets="auto", mesh=None,
                 device=None):
        if kv_dtype == torch.int8:
            raise ValueError("the GILL serving engine keeps a bf16 or fp32 "
                             "KV pool (gill_tpu refuses int8 here too)")
        if max_img_runs < 1:
            raise ValueError(f"max_img_runs {max_img_runs} < 1")
        self.sampling = sampling
        self.core = core
        self.cfg = core.opt_cfg
        self.nt = core.cfg.num_tokens
        self.max_runs = max_img_runs
        self.img0 = core.img_start
        self.pad_id = core.pad_token_id
        e0 = core.cfg.text_emb_layers[0]
        self.final_tap = e0 in (-1, core.opt_cfg.num_layers)
        self.tap_layer = e0
        self.slots = slots
        self.max_seq = max_seq
        self.chunk = chunk
        buckets = sorted(set(b for b in prefill_buckets if b <= max_seq))
        if not buckets or buckets[-1] < max_seq:
            # every admissible prompt (plen <= max_seq) must find a bucket
            buckets.append(max_seq)
        self.buckets = tuple(buckets)
        self.kv_buckets = kv_read_ladder(kv_read_buckets, max_seq)
        # LM params with the [IMG] rows merged into the embedding table, so
        # the embedding lookup AND the tied head see the learned rows
        lm = dict(params["lm"])
        lm["embed_tokens"] = {"weight": core.lm_head_table(params)}
        self.mesh = mesh
        if mesh is not None:
            lm = shard_params(lm, mesh, device)
        self.params = lm
        self.heads = local_heads(lm, self.cfg.head_dim)
        self.device = lm["embed_tokens"]["weight"].device
        self._head = lm["embed_tokens"]["weight"].float()   # see engine.py
        self.emb_dim = int(self._head.shape[1])
        self.cache = opt_mod.init_cache(self.cfg, slots, max_seq,
                                        device=self.device, dtype=kv_dtype,
                                        heads=self.heads)
        self._dstate = None
        self._dtap = None
        self._state: List[Optional[_GSlot]] = [None] * slots
        self._shadow = np.zeros((slots,), np.int64)
        self._cap = np.zeros((slots,), np.int64)
        self._prefixes: Dict[int, dict] = {}
        self._next_prefix_id = 0
        self.stats = {"prefills": 0, "prefill_reqs": 0, "chunks": 0,
                      "decode_steps": 0, "tokens_out": 0,
                      "prefix_hits": 0, "prefix_tokens_saved": 0,
                      "kv_rows_read": 0}   # sum of per-chunk read windows

    # -- state ---------------------------------------------------------------

    def _fresh_state(self):
        b, dev = self.slots, self.device

        def z(dtype, fill=0):
            return torch.full((b,), fill, dtype=dtype, device=dev)
        state = {"pos": z(torch.int32), "tok": z(torch.int32, self.pad_id),
                 "iter": z(torch.int32), "force": z(torch.int32),
                 "valid": z(torch.bool), "nw": z(torch.int32, 1),
                 "mw": z(torch.int32), "scale": z(torch.float32, 1.0),
                 "temp": z(torch.float32), "topp": z(torch.float32, 1.0)}
        tap = {"tap": torch.zeros((b, self.max_runs, self.nt, self.emb_dim),
                                  dtype=torch.float32, device=dev),
               # fed-[IMG0] count - 1 = the ring row the current run writes
               "run": z(torch.int32, -1)}
        return state, tap

    def _rbucket(self, n: int) -> int:
        # powers of TWO: GILL waves carry (R, P, E) embedding payloads, so
        # request-row padding costs real copies
        r = 1
        while r < n:
            r = min(r * 2, self.slots)
        return r

    @torch.no_grad()
    def warmup(self):
        """Runs every (prompt bucket, wave size) prefill with every row
        dropped (slot id `slots`: nothing is written) and one chunk per read
        window, so kernels are built and the allocator is warm before
        serving; every run resets the pool. Under a mesh every rank calls
        it (the forward's reduces)."""
        if self._dstate is None:
            self._dstate, self._dtap = self._fresh_state()
        rbs = sorted({self._rbucket(n) for n in range(1, self.slots + 1)})
        for pb in self.buckets:
            for nreq in rbs:
                self._prefill(torch.zeros((nreq, pb, self.emb_dim),
                                          device=self.device,
                                          dtype=self.cache["k"].dtype),
                              np.ones((nreq,), np.int32),
                              np.full((nreq,), self.slots, np.int32),
                              [None] * nreq, None)
        for kv_hi in self.kv_buckets:
            self._chunk(kv_hi, self._uniforms() if self.sampling else None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- logit surgery (reference models.py:476-489), per slot ---------------

    def _surgery(self, logits, iter_c, mw, scale):
        img0, nt = self.img0, self.nt
        logits = logits.clone()
        logits[:, img0 + 1:img0 + nt] = -torch.inf
        img_col = logits[:, img0]
        boosted = torch.where(scale > 1.0, img_col.abs() * scale, img_col)
        logits[:, img0] = torch.where(iter_c < mw,
                                      torch.full_like(boosted, -torch.inf),
                                      boosted)
        return logits

    def _pick(self, logits, st, uniforms):
        logits = self._surgery(logits, st["iter"], st["mw"], st["scale"])
        if not self.sampling:
            return logits.argmax(-1).to(torch.int32)
        return sample_per_row(logits, st["temp"], st["topp"],
                              uniforms).to(torch.int32)

    # -- device work ---------------------------------------------------------

    def _prefill(self, embs, lens, slot_ids, reqs, pfx):
        """Batched prefill of R embedding prompts (R, P, E) (SUFFIX rows
        after a registered prefix `pfx`) into `slot_ids` (== slots: a pad
        row, dropped): picks each request's first token and sets its slot's
        decode state and tap ring."""
        dev, cfg = self.device, self.cfg
        r, p, _ = embs.shape
        n_pfx = 0 if pfx is None else pfx["n"]
        small = opt_mod.init_cache(cfg, r, n_pfx + p, device=dev,
                                   dtype=self.cache["k"].dtype,
                                   heads=self.heads)
        if pfx is not None:
            for key in ("k", "v"):
                small[key][:, :, :n_pfx] = pfx[key]
        out = opt_mod.forward(self.params, cfg, embs, cache=small,
                              cache_pos=n_pfx, skip_logits=True,
                              mesh=self.mesh)
        lens_d = to_device(lens, dev).long()
        h_last = out["last_hidden"][torch.arange(r, device=dev), lens_d - 1]
        logits0 = head_rows(h_last, self._head, self.slots)

        def col(name, default, dtype):
            return to_device(np.asarray(
                [default if q is None else getattr(q, name) for q in reqs],
                dtype), dev)
        st = {"iter": torch.zeros((r,), dtype=torch.int32, device=dev),
              "mw": col("min_word_tokens", 0, np.int32),
              "scale": col("img_scale", 1.0, np.float32),
              "temp": col("temperature", 0.0, np.float32),
              "topp": col("top_p", 1.0, np.float32)}
        uniforms = None
        if self.sampling:
            # key counter = the first fed position (the prompt length)
            uniforms = to_device(np.asarray(
                [0.0 if q is None else uniform_for(q.seed, n_pfx + int(n))
                 for q, n in zip(reqs, lens)], np.float32), dev)
        first = self._pick(logits0, st, uniforms)
        force0 = torch.where(first == self.img0, self.nt - 1, 0).to(
            torch.int32)

        live = np.nonzero(slot_ids < self.slots)[0]
        if not live.size:
            return
        rows = to_device(live, dev)
        sid = to_device(slot_ids[live].astype(np.int64), dev)
        for key in self.cache:
            self.cache[key][:, sid, :n_pfx + p] = small[key][:, rows]
        ds = self._dstate
        ds["pos"][sid] = (lens_d[rows] + n_pfx).to(torch.int32)
        ds["tok"][sid] = first[rows]
        ds["iter"][sid] = 1
        ds["force"][sid] = force0[rows]
        ds["valid"][sid] = True
        ds["nw"][sid] = col("num_words", 1, np.int32)[rows]
        for name in ("mw", "scale", "temp", "topp"):
            ds[name][sid] = st[name][rows]
        # a refilled slot starts an empty tap ring
        tap = self._dtap["tap"].clone()
        tap[sid] = 0.0
        run = self._dtap["run"].clone()
        run[sid] = -1
        self._dtap = {"tap": tap, "run": run}

    def _chunk(self, kv_hi: int, uniforms):
        """`chunk` decode steps over the read window [0, kv_hi). uniforms:
        (chunk, slots) draws when sampling. Returns the (chunk + 1, slots)
        token and valid blocks (row 0 = entry state) and the tap ring after
        the chunk."""
        cfg, nt, img0 = self.cfg, self.nt, self.img0
        st = dict(self._dstate)
        tap, run = self._dtap["tap"], self._dtap["run"]
        rows_b = torch.arange(self.slots, device=self.device)
        win = {k: v[:, :, :kv_hi] for k, v in self.cache.items()}
        toks, valids = [st["tok"]], [st["valid"]]
        for j in range(self.chunk):
            pos, tok, valid = st["pos"], st["tok"], st["valid"]
            emb = self.params["embed_tokens"]["weight"][tok[:, None].long()]
            out = opt_mod.forward(self.params, cfg, emb, cache=win,
                                  cache_pos=pos, lm_head=self._head,
                                  collect_hidden=not self.final_tap,
                                  mesh=self.mesh)
            hidden = (out["last_hidden"] if self.final_tap
                      else out["hidden_states"][self.tap_layer])[:, 0]
            # tap capture for the fed token: a fed [IMG0] starts run k + 1
            idx = tok - img0
            run = run + ((idx == 0) & valid).to(run.dtype)
            ci = idx.clamp(0, nt - 1).long()
            ri = run.clamp(0, self.max_runs - 1).long()
            hit = (idx >= 0) & (idx < nt) & valid & (run >= 0) \
                & (run < self.max_runs)
            cur = tap[rows_b, ri, ci]
            tap = tap.index_put((rows_b, ri, ci), torch.where(
                hit[:, None], hidden.to(tap.dtype), cur))

            sampled = self._pick(out["logits"][:, -1], st,
                                 None if uniforms is None else uniforms[j])
            force = st["force"]
            nxt = torch.where(force > 0, img0 + (nt - force), sampled)
            done = (force == 0) & (st["iter"] >= st["nw"])
            nxt = torch.where(done, torch.full_like(nxt, self.pad_id),
                              nxt).to(torch.int32)
            trigger = (force == 0) & (nxt == img0) & ~done
            st["force"] = torch.where(
                force > 0, force - 1,
                torch.where(trigger, nt - 1, 0)).to(torch.int32)
            st["iter"] = torch.where(force > 0, st["iter"], st["iter"] + 1)
            # budget freeze: a spent slot stops advancing
            st["pos"] = torch.clamp(pos + valid.to(torch.int32),
                                    max=self.max_seq - 1)
            st["tok"], st["valid"] = nxt, ~done
            toks.append(nxt)
            valids.append(~done)
        self._dstate = st
        self._dtap = {"tap": tap, "run": run}
        return torch.stack(toks), torch.stack(valids), tap

    def _uniforms(self):
        """(chunk, slots) draws for the next chunk: slot s at step j feeds
        position start + planned + j and draws with counter one past it."""
        u = np.zeros((self.chunk, self.slots), np.float32)
        for s, st in enumerate(self._state):
            if st is None:
                continue
            for j in range(self.chunk):
                u[j, s] = uniform_for(st.seed, st.start + st.planned + j + 1)
        return to_device(u, self.device)

    # -- embedding-level prefix caching --------------------------------------

    def _check_embs(self, embs, what):
        if embs.ndim != 2 or int(embs.shape[1]) != self.emb_dim:
            raise ValueError(f"{what} embs must be (P, {self.emb_dim}), got "
                             f"{tuple(embs.shape)}")

    def _dev_embs(self, embs):
        return torch.as_tensor(embs).to(self.device, self.cache["k"].dtype)

    def _prefix_kv(self, embs, parent=None):
        n = 0 if parent is None else parent["n"]
        small = opt_mod.init_cache(self.cfg, 1, n + _rows(embs),
                                   device=self.device,
                                   dtype=self.cache["k"].dtype,
                                   heads=self.heads)
        if parent is not None:
            for key in ("k", "v"):
                small[key][:, :, :n] = parent[key]
        opt_mod.forward(self.params, self.cfg, self._dev_embs(embs)[None],
                        cache=small, cache_pos=n, skip_logits=True,
                        mesh=self.mesh)
        return {"n": n + _rows(embs), "k": small["k"], "v": small["v"]}

    @torch.no_grad()
    def register_prefix(self, embs) -> int:
        """Prefills a shared (P, E) embedding prefix ONCE and keeps its KV
        rows; requests pass the returned id as GillServeRequest.prefix_id
        with embs holding only their suffix rows."""
        self._check_embs(embs, "prefix")
        if not 1 <= _rows(embs) < self.max_seq:
            raise ValueError(f"prefix length {_rows(embs)} must be in "
                             f"[1, max_seq={self.max_seq})")
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = self._prefix_kv(embs)
        return pid

    @torch.no_grad()
    def extend_prefix(self, prefix_id: int, embs) -> int:
        """Extends a registered prefix by `embs` rows, prefilling ONLY the
        new rows at the parent's offset; returns a NEW prefix id (the parent
        stays registered)."""
        parent = self._prefixes.get(prefix_id)
        if parent is None:
            raise ValueError(f"unknown prefix_id {prefix_id}")
        self._check_embs(embs, "extension")
        n = parent["n"]
        if not (1 <= _rows(embs) and n + _rows(embs) < self.max_seq):
            raise ValueError(
                f"extension length {_rows(embs)} must be >= 1 and keep the "
                f"prefix under max_seq ({n} + {_rows(embs)} vs "
                f"{self.max_seq})")
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = self._prefix_kv(embs, parent)
        return pid

    def drop_prefix(self, prefix_id: int) -> None:
        if self._prefixes.pop(prefix_id, None) is None:
            raise ValueError(f"unknown prefix_id {prefix_id}")

    # -- scheduler -----------------------------------------------------------

    def _validate(self, req: GillServeRequest) -> int:
        """Admission check, run before anything is scheduled. Returns the
        request's step budget."""
        plen = _rows(req.embs)
        if req.prefix_id is not None:
            pfx = self._prefixes.get(req.prefix_id)
            if pfx is None:
                raise ValueError(f"request {req.uid}: unknown prefix_id "
                                 f"{req.prefix_id}")
            if plen < 1:
                raise ValueError(
                    f"request {req.uid}: prefixed requests must carry >= 1 "
                    "suffix embedding row")
            plen += pfx["n"]
        budget = req.num_words + (self.nt - 1) * req.max_img_runs
        if plen + budget + 1 > self.max_seq:
            raise ValueError(
                f"request {req.uid}: {plen}+{budget}+1 exceeds max_seq "
                f"{self.max_seq}")
        if req.temperature > 0 and not self.sampling:
            raise ValueError(
                f"request {req.uid}: temperature > 0 needs an engine built "
                "with sampling=True")
        if req.max_img_runs > self.max_runs:
            raise ValueError(
                f"request {req.uid}: max_img_runs {req.max_img_runs} exceeds "
                f"the engine's tap ring depth {self.max_runs}")
        return budget

    def _refill(self, queue: List[GillServeRequest]):
        wave = []
        for s in range(self.slots):
            if self._state[s] is not None or not queue:
                continue
            req = queue.pop(0)
            wave.append((s, req, self._validate(req)))
        if not wave:
            return
        groups: Dict[Optional[int], list] = {}
        for ent in wave:
            groups.setdefault(ent[1].prefix_id, []).append(ent)
        for pid, grp in groups.items():
            self._prefill_group(pid, grp)
        for s, req, budget in wave:
            plen = _rows(req.embs)
            if req.prefix_id is not None:
                plen += self._prefixes[req.prefix_id]["n"]
            self._state[s] = _GSlot(uid=req.uid, budget=budget, start=plen,
                                    seed=req.seed)
            # pos starts at the prompt length and freezes once the closed
            # budget is spent
            self._shadow[s] = plen
            self._cap[s] = min(plen + budget + 1, self.max_seq - 1)

    def _prefill_group(self, pid: Optional[int], wave):
        pfx = None if pid is None else self._prefixes[pid]
        pb = max(_bucket(_rows(req.embs), self.buckets) for _, req, _ in wave)
        if pfx is not None and pfx["n"] + pb > self.max_seq:
            raise ValueError(
                f"prefix {pid} ({pfx['n']}) + suffix bucket {pb} exceeds "
                f"max_seq {self.max_seq}; use a smaller suffix bucket")
        nreq = self._rbucket(len(wave))
        # the wave buffer is built on the device in the pool's dtype
        embs = torch.zeros((nreq, pb, self.emb_dim), device=self.device,
                           dtype=self.cache["k"].dtype)
        lens = np.ones((nreq,), np.int32)
        slot_ids = np.full((nreq,), self.slots, np.int32)
        reqs = [None] * nreq
        for i, (s, req, _) in enumerate(wave):
            embs[i, :_rows(req.embs)] = self._dev_embs(req.embs)
            lens[i] = _rows(req.embs)
            slot_ids[i] = s
            reqs[i] = req
        self._prefill(embs, lens, slot_ids, reqs, pfx)
        if pfx is not None:
            self.stats["prefix_hits"] += len(wave)
            self.stats["prefix_tokens_saved"] += pfx["n"] * len(wave)
        self.stats["prefills"] += 1
        self.stats["prefill_reqs"] += len(wave)

    def _run_chunk(self):
        """One chunk at the smallest read window covering every slot's
        position bound (engine.py `_run_chunk`)."""
        kv_hi, self._shadow = pool_window_hi(self._shadow, self._cap,
                                             self.chunk, self.max_seq,
                                             self.kv_buckets)
        uniforms = self._uniforms() if self.sampling else None
        toks, valids, tap = self._chunk(kv_hi, uniforms)
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += self.chunk
        self.stats["kv_rows_read"] += kv_hi
        return HostCopy(toks), HostCopy(valids), tap

    def _reset_pool(self):
        self._dstate, self._dtap = self._fresh_state()
        self._state = [None] * self.slots
        self._shadow = np.zeros((self.slots,), np.int64)
        self._cap = np.zeros((self.slots,), np.int64)

    def _collect_block(self, block, results):
        toks, valids, tap, snap = block
        arr, var = toks.numpy(), valids.numpy()
        tap_host = None
        for s, (st, was_fresh) in snap.items():
            if st.done:
                continue
            st.fed += arr.shape[0] - 1
            for r in range(0 if was_fresh else 1, arr.shape[0]):
                # exactly `budget` tokens, like GILLCore.generate
                if len(st.generated) >= st.budget:
                    break
                st.generated.append(int(arr[r, s]))
                st.valid.append(bool(var[r, s]))
            # finish only once this block's FED coverage reaches the
            # budget: output m's tap row is captured at fed step m + 1
            if len(st.generated) >= st.budget and st.fed >= st.budget:
                if tap_host is None:
                    tap_host = tap.numpy()
                v = np.asarray(st.valid, bool)
                n_valid = int(v.cumprod().sum())   # valid is a monotone prefix
                toks_v = np.asarray(st.generated, np.int32)[:n_valid]
                st.done = True
                results[st.uid] = {"tokens": toks_v.tolist(),
                                   "img_hidden": tap_host[s, 0].copy(),
                                   "img_runs": tap_host[s].copy()}
                self.stats["tokens_out"] += len(toks_v)

    @torch.no_grad()
    def run(self, requests: List[GillServeRequest], *, depth: int = 2
            ) -> Dict[int, dict]:
        """Serves all requests (pipelined: GILL decode is closed-budget).
        Returns uid -> {"tokens": the valid generated ids, "img_hidden":
        (num_tokens, E) — the first [IMG] run's hidden states, "img_runs":
        (max_img_runs, num_tokens, E) — the tap ring, run k in row k}."""
        for req in requests:
            self._validate(req)
        queue = list(requests)
        results: Dict[int, dict] = {}
        pending = deque()
        self._reset_pool()
        while True:
            for s in range(self.slots):
                st = self._state[s]
                if st is not None and st.planned >= st.budget:
                    self._state[s] = None
                    self._shadow[s] = 0
                    self._cap[s] = 0
            self._refill(queue)
            active = [s for s in range(self.slots)
                      if self._state[s] is not None]
            if not active and not pending:
                break
            if active:
                toks, valids, tap = self._run_chunk()
                snap = {}
                for s in active:
                    st = self._state[s]
                    snap[s] = (st, st.fresh)
                    st.planned += self.chunk   # fed steps (no entry bonus)
                    st.fresh = False
                # the tap ring comes to the host only after a chunk in which
                # some request's budget is covered (it finishes there)
                finishing = any(snap[s][0].planned >= snap[s][0].budget
                                for s in active)
                pending.append((toks, valids,
                                HostCopy(tap) if finishing else None, snap))
            while len(pending) > depth or (not active and pending):
                self._collect_block(pending.popleft(), results)
        return results
