"""Continuous-batching LM serving engine (counterpart of
gill_tpu/serve/engine.py).

A fixed pool of batch SLOTS shares one preallocated KV cache; each slot
runs its own request at its own sequence depth, and finished slots are
refilled from the queue without draining the batch. Greedy decode; EOS and
per-request max_new_tokens end a request. What it keeps from gill_tpu:

  * batched prefill WAVES: every refill of one scheduler visit prefills in
    one forward — prompts pad to the wave's largest bucket, the request
    count to the `_rbucket` ladder; pad rows carry slot id == `slots` and
    are dropped; the first token comes from the last valid position,
    through a head product of `slots` rows (`head_rows`). On the card a
    row's bits do not depend on the wave: K4's plan is the same at every
    row count above 16 (longer products in 256-row windows), causal
    prompts take the flash kernel at every bucket, and K6 plans for the
    pool, not the read window (ops/w8_matmul.py, ops/attention.py,
    ops/decode_attn.py);
  * decode in CHUNKS of `chunk` steps over device-resident per-slot state
    (pos / tok / active / limit): within a chunk the host neither reads
    nor waits; it reads the chunk's token block once (row 0 = the entry
    tokens, which carry a refilled slot's prefill token);
  * per-slot positions through the (B,)-`cache_pos` decode of models/opt.py
    (attention masks per row; on CUDA the valid-prefix kernel reads only
    each row's valid rows; the token's k/v land at (layer, slot, pos));
  * EOS latches only on emitted tokens; the budget freeze keeps `pos` at
    `limit`, so a finished slot stops advancing until refilled;
  * KV read-window buckets chosen from a host-side bound on every slot's
    position (`_run_chunk`): the chunk decodes over the view
    `cache[:, :, :kv_hi]` of the pool. gill_tpu slices and merges a window
    copy (`_kv_window`, XLA mechanism); a view needs neither;
  * prefix caching (register / extend / drop), int8 KV, `warmup`, `run`,
    `run_pipelined`, `run_waves` and `stats`;
  * `mesh` (tensor-parallel serving): the engine keeps this rank's shard
    of the LM's matrices (`parallel.shard_params`) and the pool sharded by
    heads; the layers reduce over "model" (models/opt.py). The SPMD
    contract: every rank of the model group builds the engine from the
    same parameters and calls it with the same requests, in the same
    order. Every host decision (wave sizes, read windows, refills, EOS
    latches) then comes from replicated state: the token blocks are
    argmaxes of logits every rank holds bit for bit after the reduce. W8
    weights and an int8 pool raise under a mesh, as in gill_tpu.
Not ported: `unroll_layers` (the port always loops over layer views). Host -> device copies go through pinned
memory without blocking, and token blocks come back through pinned buffers
read once their chunk's event has passed, so the pipelined scheduler never
waits on chunks it dispatched later.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from gill_tpu_torch.config import OPTConfig
from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.parallel.partition import (KV8_REFUSAL, local_heads,
                                               shard_params)


@dataclass
class ServeRequest:
    uid: int
    prompt: List[int]              # token ids of the FULL prompt (any
                                   # registered prefix included)
    max_new_tokens: int
    prefix_id: Optional[int] = None  # from DecodeEngine.register_prefix:
                                     # the prompt must start with that
                                     # prefix; prefill computes the suffix


@dataclass
class _SlotState:
    uid: int
    pos: int                       # next cache row to write
    generated: List[int] = field(default_factory=list)
    max_new: int = 0
    fresh: bool = True             # first token still on device (chunk row 0)
    planned: int = 0               # tokens covered by DISPATCHED chunks
                                   # (pipelined scheduler only)
    done: bool = False             # result delivered (pipelined scheduler)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def kv_read_ladder(kv_read_buckets, max_seq: int) -> tuple:
    """Read-window buckets: "auto" = a power-of-two ladder from 256 below
    max_seq; None / () = the single full read; max_seq always included."""
    if kv_read_buckets == "auto":
        kv_read_buckets, b = [], 256
        while b < max_seq:
            kv_read_buckets.append(b)
            b *= 2
    return tuple(sorted({b for b in (kv_read_buckets or ()) if b < max_seq}
                        | {max_seq}))


def head_rows(h, head, rows: int) -> torch.Tensor:
    """fp32 logits of a prefill wave's last hidden rows h (r, E) against
    the tied fp32 head (V, E), computed as one `rows`-row product (zero
    rows appended; the engines pass their slot count): the library GEMM's
    algorithm, and with it a row's rounding, follows its row count, so a
    request's first token would otherwise depend on its wave's size."""
    r = h.shape[0]
    if r < rows:
        h = torch.cat([h, h.new_zeros((rows - r, h.shape[1]))])
    return (h.float() @ head.t())[:r]


def to_device(arr, device) -> torch.Tensor:
    """A host array on `device`; on CUDA through pinned memory without
    blocking, so queued device work is not waited for."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class HostCopy:
    """A device tensor's copy to the host, started now and read later:
    `numpy()` waits for this copy only, not for work queued after it."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def pool_window_hi(shadow, cap, chunk: int, max_seq: int, buckets):
    """(kv_hi, new shadow): the smallest read window covering every slot's
    position bound after one more chunk (gill_tpu `_run_chunk`)."""
    if len(buckets) == 1:
        return max_seq, shadow
    end = np.minimum(np.minimum(shadow + chunk, cap), max_seq - 1)
    hi = int(end.max()) if end.size else max_seq
    return next(b for b in buckets if b >= hi), end


class DecodeEngine:
    """Slot-based continuous batching over one OPT parameter tree.

    params/cfg: as models/opt.py makes them (optionally quantize_params_w8
    for W8A16 serving); the engine runs on the params' device. slots: the
    decode batch width. max_seq: KV rows per slot (prompt + generation must
    fit). chunk: decode steps per host round trip. kv_dtype: the pool's
    dtype; torch.int8 selects the int8 cache with per-token scales. mesh:
    a `parallel.Mesh` to serve tensor-parallel over its "model" group
    (`params` the full tree; the engine keeps this rank's shard). device:
    with `mesh`, where this rank's shard goes (default the params'
    device), so a tree on the host puts only the shard on the card."""

    def __init__(self, params, cfg: OPTConfig, *, slots: int = 16,
                 max_seq: int = 512, chunk: int = 32,
                 prefill_buckets=(64, 128, 256, 512),
                 eos_id: Optional[int] = None, pad_id: int = 1,
                 kv_dtype=torch.bfloat16, kv_read_buckets="auto",
                 mesh=None, device=None):
        self.mesh = mesh
        if mesh is not None:
            if kv_dtype == torch.int8:
                raise ValueError(KV8_REFUSAL)
            params = shard_params(params, mesh, device)
        self.params = params
        self.cfg = cfg
        self.device = params["embed_tokens"]["weight"].device
        self.slots = slots
        self.max_seq = max_seq
        self.chunk = chunk
        self.buckets = tuple(b for b in sorted(set(prefill_buckets))
                             if b <= max_seq)
        self.kv_buckets = kv_read_ladder(kv_read_buckets, max_seq)
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._kv8 = kv_dtype == torch.int8
        self.heads = local_heads(params, cfg.head_dim)
        self.cache = opt_mod.init_cache(cfg, slots, max_seq,
                                        device=self.device, dtype=kv_dtype,
                                        kv_int8=self._kv8, heads=self.heads)
        # the tied head in fp32, made once: logits are fp32 products of the
        # activation-dtype values with fp32 sums (gill_tpu's dot_general
        # with preferred_element_type=float32) without widening the table
        # on every step
        self._head = params["embed_tokens"]["weight"].float()
        self._dstate = None            # device {"pos","tok","active","limit"}
        self._state: List[Optional[_SlotState]] = [None] * slots
        # host-side upper bounds on each slot's device pos (see _run_chunk)
        self._shadow = np.zeros((slots,), np.int64)
        self._cap = np.zeros((slots,), np.int64)
        self._prefixes: Dict[int, dict] = {}
        self._next_prefix_id = 0
        self._finished: List = []
        self.stats = {"prefills": 0, "prefill_reqs": 0, "chunks": 0,
                      "decode_steps": 0, "tokens_out": 0,
                      "prefix_hits": 0, "prefix_tokens_saved": 0,
                      "kv_rows_read": 0}   # sum of per-chunk read windows

    def _rbucket(self, n: int) -> int:
        # powers of 4 capped at the slot count (gill_tpu: few compiled
        # variants; here it keeps the wave shapes the same)
        r = 1
        while r < n:
            r = min(r * 4, self.slots)
        return r

    def _fresh_state(self):
        dev, b = self.device, self.slots
        return {"pos": torch.zeros((b,), dtype=torch.int32, device=dev),
                "tok": torch.full((b,), self.pad_id, dtype=torch.int32,
                                  device=dev),
                "active": torch.zeros((b,), dtype=torch.bool, device=dev),
                # pos value at which the slot's token budget is exhausted:
                # the device freezes it there
                "limit": torch.zeros((b,), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def warmup(self):
        """Runs every (prompt bucket, wave size) prefill with all rows
        dropped and one chunk per read window, so kernels are built and the
        allocator is warm before serving; the pool is reset by every run."""
        if self._dstate is None:
            self._dstate = self._fresh_state()
        rbs = sorted({self._rbucket(n) for n in range(1, self.slots + 1)})
        for pb in self.buckets:
            for nreq in rbs:
                self._prefill(np.full((nreq, pb), self.pad_id, np.int32),
                              np.ones((nreq,), np.int32),
                              np.full((nreq,), self.slots, np.int32),
                              np.ones((nreq,), np.int32))
        for kv_hi in self.kv_buckets:
            self._chunk(kv_hi)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- device work ---------------------------------------------------------

    def _small_cache(self, rows: int, length: int):
        return opt_mod.init_cache(self.cfg, rows, length, device=self.device,
                                  dtype=self.cache["k"].dtype,
                                  kv_int8=self._kv8, heads=self.heads)

    def _prefill(self, toks, lens, slot_ids, limits, pfx=None):
        """Batched prefill of R prompts (R, P) into the slots `slot_ids`
        (== slots: a pad row, dropped). With a registered prefix `pfx`, toks
        are the SUFFIXES, prefilled at the prefix's offset over its cached
        rows. Sets the slots' decode state; returns nothing to the host."""
        dev, cfg = self.device, self.cfg
        r, p = toks.shape
        n_pfx = 0 if pfx is None else len(pfx["tokens"])
        emb = opt_mod.embed_tokens(self.params, to_device(toks, dev).long())
        small = self._small_cache(r, n_pfx + p)
        if pfx is not None:
            for key in ("k", "v"):
                small[key][:, :, :n_pfx] = pfx[key]
        out = opt_mod.forward(self.params, cfg, emb, cache=small,
                              cache_pos=n_pfx, skip_logits=True,
                              mesh=self.mesh)
        lens_d = to_device(lens, dev).long()
        h_last = out["last_hidden"][torch.arange(r, device=dev), lens_d - 1]
        first = head_rows(h_last, self._head, self.slots).argmax(-1).to(
            torch.int32)
        live = np.nonzero(slot_ids < self.slots)[0]
        if live.size:
            rows = to_device(live, dev)
            sid = to_device(slot_ids[live].astype(np.int64), dev)
            for key in self.cache:
                self.cache[key][:, sid, :n_pfx + p] = small[key][:, rows]
            st = self._dstate
            st["pos"][sid] = (lens_d[rows] + n_pfx).to(torch.int32)
            st["tok"][sid] = first[rows]
            st["active"][sid] = True
            st["limit"][sid] = to_device(limits[live], dev)

    def _chunk(self, kv_hi: int) -> torch.Tensor:
        """`chunk` greedy decode steps over the read window [0, kv_hi) of
        the pool. Returns the (chunk + 1, slots) token block, row 0 = the
        entry tokens."""
        cfg, st = self.cfg, self._dstate
        pos, tok, active, limit = st["pos"], st["tok"], st["active"], \
            st["limit"]
        win = {k: v[:, :, :kv_hi] for k, v in self.cache.items()}
        rows = [tok]
        for _ in range(self.chunk):
            # budget freeze: a slot whose budget is spent stops advancing
            act = active & (pos < limit)
            emb = opt_mod.embed_tokens(self.params, tok[:, None].long())
            out = opt_mod.forward(self.params, cfg, emb, cache=win,
                                  cache_pos=pos, lm_head=self._head,
                                  mesh=self.mesh)
            nxt = out["logits"][:, -1].argmax(-1).to(torch.int32)
            nxt = torch.where(act, nxt, torch.full_like(nxt, self.pad_id))
            if self.eos_id is not None:
                # EOS latches only on genuinely emitted tokens
                active = active & ((nxt != self.eos_id) | ~act)
            # inactive slots neither advance nor emit; their parked cache
            # row is overwritten harmlessly until refill
            pos = torch.clamp(pos + act.to(torch.int32), max=self.max_seq - 1)
            tok = nxt
            rows.append(nxt)
        self._dstate = {"pos": pos, "tok": tok, "active": active,
                        "limit": limit}
        return torch.stack(rows)

    def _run_chunk(self) -> HostCopy:
        """Dispatches one chunk at the smallest read window covering every
        slot's position bound. The bound is tracked host-side: a slot's pos
        starts at its prompt length, advances at most `chunk` a chunk and
        freezes at its budget limit, so the window shrinks back after deep
        requests retire, with no device round trip."""
        kv_hi, self._shadow = pool_window_hi(self._shadow, self._cap,
                                             self.chunk, self.max_seq,
                                             self.kv_buckets)
        toks = self._chunk(kv_hi)
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += self.chunk
        self.stats["kv_rows_read"] += kv_hi
        return HostCopy(toks)

    def _reset_pool(self):
        self._dstate = self._fresh_state()
        self._state = [None] * self.slots
        self._shadow = np.zeros((self.slots,), np.int64)
        self._cap = np.zeros((self.slots,), np.int64)

    # -- prefix caching ------------------------------------------------------

    def _prefix_kv(self, tokens: List[int], parent=None):
        """KV rows (L, 1, n, H, Dh) of `tokens` after `parent`'s rows
        (exact length: no bucket padding, since the suffix prefill treats
        every row below the offset as valid)."""
        n = 0 if parent is None else len(parent["tokens"])
        emb = opt_mod.embed_tokens(
            self.params, to_device(np.asarray([tokens], np.int64),
                                   self.device))
        small = self._small_cache(1, n + len(tokens))
        if parent is not None:
            for key in ("k", "v"):
                small[key][:, :, :n] = parent[key]
        opt_mod.forward(self.params, self.cfg, emb, cache=small, cache_pos=n,
                        skip_logits=True, mesh=self.mesh)
        return small

    @torch.no_grad()
    def register_prefix(self, tokens: List[int]) -> int:
        """Prefills a shared prompt prefix ONCE and keeps its KV rows;
        requests whose prompt starts with these tokens pass the returned id
        as ServeRequest.prefix_id and prefill only their suffix."""
        tokens = [int(t) for t in tokens]
        if self._kv8:
            raise ValueError(
                "prefix caching needs a bf16 KV cache (the suffix prefill "
                "at an offset has no int8 path); build the engine with "
                "kv_dtype=torch.bfloat16")
        if not 1 <= len(tokens) < self.max_seq:
            raise ValueError(f"prefix length {len(tokens)} must be in "
                             f"[1, max_seq={self.max_seq})")
        kv = self._prefix_kv(tokens)
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = {"tokens": tokens, "k": kv["k"], "v": kv["v"]}
        return pid

    @torch.no_grad()
    def extend_prefix(self, prefix_id: int, tokens: List[int]) -> int:
        """Extends a registered prefix by `tokens`, prefilling ONLY the new
        tokens at the parent's offset. Returns a NEW prefix id for [parent
        tokens | tokens]; the parent stays registered."""
        parent = self._prefixes.get(prefix_id)
        if parent is None:
            raise ValueError(f"unknown prefix_id {prefix_id}")
        tokens = [int(t) for t in tokens]
        n = len(parent["tokens"])
        if not tokens or n + len(tokens) >= self.max_seq:
            raise ValueError(
                f"extension length {len(tokens)} must be >= 1 and keep the "
                f"prefix under max_seq ({n} + {len(tokens)} vs "
                f"{self.max_seq})")
        kv = self._prefix_kv(tokens, parent)
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = {"tokens": parent["tokens"] + tokens,
                               "k": kv["k"], "v": kv["v"]}
        return pid

    def drop_prefix(self, prefix_id: int) -> None:
        """Frees a registered prefix's KV rows; later requests naming the id
        fail admission with "unknown prefix_id"."""
        if self._prefixes.pop(prefix_id, None) is None:
            raise ValueError(f"unknown prefix_id {prefix_id}")

    # -- scheduler -----------------------------------------------------------

    def _refill(self, queue: List[ServeRequest]):
        # No device -> host read here: a refilled slot's first token reaches
        # the host as row 0 of the next chunk's block (`fresh`).
        wave = []                      # (slot, request) pairs
        for s in range(self.slots):
            if self._state[s] is not None or not queue:
                continue
            req = queue.pop(0)
            plen = len(req.prompt)
            if plen + req.max_new_tokens > self.max_seq:
                raise ValueError(
                    f"request {req.uid}: {plen}+{req.max_new_tokens} exceeds "
                    f"max_seq {self.max_seq}")
            if req.prefix_id is not None:
                pfx = self._prefixes.get(req.prefix_id)
                if pfx is None:
                    raise ValueError(f"request {req.uid}: unknown prefix_id "
                                     f"{req.prefix_id}")
                n = len(pfx["tokens"])
                if plen <= n or req.prompt[:n] != pfx["tokens"]:
                    raise ValueError(
                        f"request {req.uid}: prompt must extend prefix "
                        f"{req.prefix_id} ({n} tokens) by >= 1 token")
            wave.append((s, req))
        if not wave:
            return
        # one batched prefill per prefix group (no prefix = one group)
        groups: Dict[Optional[int], list] = {}
        for s, req in wave:
            groups.setdefault(req.prefix_id, []).append((s, req))
        for pid, grp in groups.items():
            self._prefill_wave(grp, None if pid is None
                               else self._prefixes[pid])
            if pid is not None:
                self.stats["prefix_hits"] += len(grp)
                self.stats["prefix_tokens_saved"] += \
                    len(self._prefixes[pid]["tokens"]) * len(grp)
        for s, req in wave:
            self._state[s] = _SlotState(uid=req.uid, pos=len(req.prompt),
                                        max_new=req.max_new_tokens)
            # the device pos starts at the prompt length and freezes at the
            # budget limit
            self._shadow[s] = len(req.prompt)
            self._cap[s] = min(len(req.prompt) + req.max_new_tokens - 1,
                               self.max_seq - 1)

    def _prefill_wave(self, grp, pfx):
        n_pfx = 0 if pfx is None else len(pfx["tokens"])
        seqs = [req.prompt[n_pfx:] for _, req in grp]
        pb = max(_bucket(len(sq), self.buckets) for sq in seqs)
        if n_pfx + pb > self.max_seq:
            raise ValueError(
                f"prefix ({n_pfx}) + suffix bucket {pb} exceeds max_seq "
                f"{self.max_seq}; use a smaller suffix bucket")
        nreq = self._rbucket(len(grp))
        toks = np.full((nreq, pb), self.pad_id, np.int32)
        lens = np.ones((nreq,), np.int32)
        slot_ids = np.full((nreq,), self.slots, np.int32)   # pad -> dropped
        limits = np.ones((nreq,), np.int32)
        for i, ((s, req), sq) in enumerate(zip(grp, seqs)):
            toks[i, :len(sq)] = sq
            lens[i] = len(sq)
            slot_ids[i] = s
            limits[i] = min(len(req.prompt) + req.max_new_tokens - 1,
                            self.max_seq - 1)
        self._prefill(toks, lens, slot_ids, limits, pfx)
        self.stats["prefills"] += 1
        self.stats["prefill_reqs"] += len(grp)

    def _take(self, st: _SlotState, rows) -> bool:
        """Appends a block's token rows to a slot's request; True once the
        request is finished (budget spent or EOS emitted)."""
        for t in rows:
            if len(st.generated) >= st.max_new:
                break
            t = int(t)
            st.generated.append(t)
            if self.eos_id is not None and t == self.eos_id:
                break
        return (len(st.generated) >= st.max_new
                or (self.eos_id is not None and bool(st.generated)
                    and st.generated[-1] == self.eos_id))

    def _collect(self, toks: np.ndarray):
        """Folds one chunk's tokens into per-slot results and closes
        finished slots. Row 0 holds the chunk-ENTRY tokens, consumed only by
        `fresh` slots (their prefill token)."""
        for s in range(self.slots):
            st = self._state[s]
            if st is None:
                continue
            rows = toks[:, s] if st.fresh else toks[1:, s]
            st.fresh = False
            if self._take(st, rows):
                self._finished.append((st.uid, st.generated))
                self._state[s] = None
                # a retired slot no longer bounds the read window
                self._shadow[s] = 0
                self._cap[s] = 0

    def _drain(self, results):
        for uid, gen in self._finished:
            results[uid] = gen
            self.stats["tokens_out"] += len(gen)
        self._finished = []

    @torch.no_grad()
    def run(self, requests: List[ServeRequest]) -> Dict[int, List[int]]:
        """Serves all requests; returns uid -> generated token ids (greedy;
        the first comes from the prefill, an EOS is included)."""
        queue = list(requests)
        self._finished = []
        results: Dict[int, List[int]] = {}
        self._reset_pool()
        while queue or any(st is not None for st in self._state):
            self._refill(queue)
            if not any(st is not None for st in self._state):
                continue
            self._collect(self._run_chunk().numpy())
        self._drain(results)
        return results

    def _collect_block(self, block, results: Dict[int, List[int]]):
        """Folds one PIPELINED chunk's tokens into the requests that held
        each slot when the chunk was dispatched (the snapshot keeps the
        _SlotState objects, so a slot refilled since is not confused)."""
        toks, snap = block
        arr = toks.numpy()
        for s, (st, was_fresh) in snap.items():
            if st.done:
                continue
            if self._take(st, arr[:, s] if was_fresh else arr[1:, s]):
                st.done = True
                results[st.uid] = st.generated
                self.stats["tokens_out"] += len(st.generated)

    @torch.no_grad()
    def run_pipelined(self, requests: List[ServeRequest], *,
                      depth: int = 2) -> Dict[int, List[int]]:
        """The asynchronous chunk pipeline: a slot is reusable once chunks
        covering its token budget have been DISPATCHED (or its EOS was
        collected), so refills are planned host-side and token blocks are
        read up to `depth` chunks late, never stalling the device."""
        queue = list(requests)
        results: Dict[int, List[int]] = {}
        pending = deque()
        self._reset_pool()
        while True:
            for s in range(self.slots):
                st = self._state[s]
                if st is not None and (st.done or st.planned >= st.max_new):
                    self._state[s] = None
                    self._shadow[s] = 0
                    self._cap[s] = 0
            self._refill(queue)
            active = [s for s in range(self.slots)
                      if self._state[s] is not None]
            if not active and not pending:
                break
            if active:
                toks = self._run_chunk()
                snap = {}
                for s in active:
                    st = self._state[s]
                    snap[s] = (st, st.fresh)
                    # a fresh slot also yields its prefill token (row 0)
                    st.planned += self.chunk + (1 if st.fresh else 0)
                    st.fresh = False
                pending.append((toks, snap))
            while len(pending) > depth or (not active and pending):
                self._collect_block(pending.popleft(), results)
        return results

    @torch.no_grad()
    def run_waves(self, requests: List[ServeRequest]) -> Dict[int, List[int]]:
        """Wave scheduling (the baseline without continuous refill): fill
        all slots, decode until EVERY slot finishes, take the next wave."""
        results: Dict[int, List[int]] = {}
        queue = list(requests)
        self._reset_pool()
        while queue:
            wave, queue = queue[:self.slots], queue[self.slots:]
            self._finished = []
            self._refill(wave)
            while any(st is not None for st in self._state):
                self._collect(self._run_chunk().numpy())
            self._drain(results)
        return results
