"""Online serving: asynchronous request intake and token streaming over the
continuous-batching engines (counterpart of gill_tpu/serve/online.py).

One scheduler thread owns the engine and multiplexes every request in
flight over its slot pool:

  * `submit()` does not block and is thread-safe; it returns a
    RequestHandle whose tokens appear chunk by chunk (streaming) and which
    signals completion through an Event;
  * the scheduler loop is the engine's synchronous scheduler (refill ->
    chunk -> collect) fed from outside: between chunks it drains whatever
    arrived, so new requests join the running batch at the next chunk
    boundary (no batch drain);
  * when idle, the loop parks on the queue: no polling, no device work;
  * `cancel()` is honoured at the next chunk boundary: a queued request
    completes with no tokens, one in flight frees its slot and completes
    with the tokens streamed so far;
  * a crash of the scheduler is contained: every handle in flight or
    queued fails with the error (result() / stream() raise instead of
    blocking forever), and later submits are refused.

Only the scheduler thread touches the engine and the device: prefix
registration, extension and drop are tickets it processes, and handles are
the only shared state (token lists under a per-handle condition). The
thread enters the engine's device (`torch.cuda.device`) and runs under
`torch.no_grad()`: a new thread's current device is cuda:0 and its grad
mode on, whatever the caller's. The engines' state tensors are written in
place, on the thread's current stream of the engine's device.

An engine built with a `mesh` (tensor-parallel, data-replicated or both)
runs one process a rank, and every rank of the world builds its online
engine at the same point of its program. Rank 0 is the LEADER: it takes
`submit`, `cancel`, `register_prefix`, `extend_prefix` and `drop_prefix`,
and its scheduler decides each chunk boundary as it would alone. Before it
acts on a boundary it broadcasts the boundary's TICK (the requests and
prefix tickets drained there, in arrival order, the uids cancelled and
the stop flag; `parallel.collectives.broadcast_tick`, embedding payloads
as tensors) over a group of the whole world with the world's timeout.
Every other rank is a FOLLOWER: its scheduler thread receives each tick
and runs the same tickets, cancel sweep, refill, chunk and collect, in the
same order, so its slot state stays rank 0's (greedy tokens are argmaxes
every rank holds after the reduces; sampled tokens come from (seed,
position) draws). Only the leader streams to handles. After each boundary
every rank reports its health (`all_status`): a rank whose boundary
raised fails every rank's scheduler, and so the leader's handles, at once;
a rank that stops inside a collective fails the others when the
collective times out. An idle leader sends an empty tick every quarter of
the group's timeout, so its followers' waits never reach it. A follower's
public calls raise; its caller blocks in `wait_closed()`, which returns
once the leader's `close()` has stopped every rank. While an online
engine is open, every collective of its rank comes from its scheduler
thread (the forward's reduces and the ticks): no other thread of the
process may issue one. An engine without a mesh takes no collective and
starts no thread beyond its scheduler.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from gill_tpu_torch.parallel.collectives import all_status, broadcast_tick
from gill_tpu_torch.parallel.mesh import group_timeout, new_group
from gill_tpu_torch.serve.engine import ServeRequest


class RequestHandle:
    """Streamed result of one submitted request."""

    def __init__(self, uid: int, prompt: List[int], max_new: int):
        self.uid = uid
        self.prompt = prompt
        self.max_new = max_new
        self.prefix_id: Optional[int] = None
        self.tokens: List[int] = []
        self.done = threading.Event()
        self.cond = threading.Condition()
        self.error: Optional[str] = None
        self.cancelled = False

    def cancel(self) -> None:
        """Requests cancellation (e.g. the client disconnected). Safe from
        any thread and idempotent. The scheduler honours it at the next
        chunk boundary (`_ThreadedEngine._cancel_sweep`): a queued request
        finishes at once with no tokens; one in flight stops decoding (its
        slot is parked on the device and freed for waiting requests) and
        completes with the tokens streamed so far. result() then returns
        that partial list (see .cancelled); stream() ends. Cancelling a
        finished request changes nothing but the flag."""
        self.cancelled = True

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.uid} still running")
        if self.error:
            raise RuntimeError(self.error)
        return self.tokens

    def stream(self):
        """Yields tokens as they arrive; ends when the request completes."""
        sent = 0
        while True:
            with self.cond:
                while len(self.tokens) == sent and not self.done.is_set():
                    self.cond.wait()
                new = self.tokens[sent:]
            yield from new
            sent += len(new)
            if self.done.is_set() and sent == len(self.tokens):
                if self.error:
                    raise RuntimeError(self.error)
                return


class _PrefixReg:
    """A prefix ticket, processed by the scheduler thread. payload: token
    ids for the plain-LM engine, a (P, E) embedding array or tensor for the
    GILL engine. parent: an existing prefix id to EXTEND. drop: the id to
    free (payload None)."""

    def __init__(self, payload, parent: Optional[int] = None,
                 drop: Optional[int] = None):
        self.payload = payload
        self.parent = parent
        self.drop = drop
        self.pid: Optional[int] = None
        self.error: Optional[str] = None
        self.done = threading.Event()

    def run(self, eng) -> None:
        """Applies the ticket to the engine; a bad ticket fails its caller,
        not the scheduler."""
        try:
            if self.drop is not None:
                eng.drop_prefix(self.drop)
            elif self.parent is None:
                self.pid = eng.register_prefix(self.payload)
            else:
                self.pid = eng.extend_prefix(self.parent, self.payload)
        except (ValueError, TypeError, RuntimeError) as e:
            self.error = f"{type(e).__name__}: {e}"
        self.done.set()


class GillRequestHandle(RequestHandle):
    """RequestHandle plus the [IMG] runs' hidden states, set at completion
    (the GILLMapper / retrieval-head input): img_hidden is the first run
    (nt, E), img_runs the engine's whole (max_img_runs, nt, E) tap ring,
    both fp32 numpy arrays. A cancelled request completes with both None:
    a partial decode carries no usable taps."""

    def __init__(self, uid, request):
        super().__init__(uid, [], request.num_words)
        self.request = request
        self.img_hidden = None
        self.img_runs = None


def _opt_int(x) -> Optional[int]:
    return None if x is None else int(x)


class _Tick(NamedTuple):
    """One chunk boundary's decisions: the requests and prefix tickets
    drained there (arrival order), the uids cancelled, and whether to
    stop."""
    items: list
    cancel: frozenset
    stop: bool


class _TickChannel:
    """The leader -> followers channel of a meshed online engine: a group
    of every rank of the world (the world's timeout), the tick broadcast
    and the health exchange. Embedding payloads travel on the card where
    the group's CUDA backend is NCCL, else on the host."""

    def __init__(self, device):
        self.rank = dist.get_rank()
        self.group = new_group(list(range(dist.get_world_size())))
        # the idle leader's empty tick, well inside a follower's wait
        self.heartbeat = group_timeout(self.group) / 4
        nccl = "nccl" in str(dist.get_backend(self.group))
        self.device = (device if device.type == "cuda" and nccl
                       else torch.device("cpu"))

    @staticmethod
    def open(engine) -> "Optional[_TickChannel]":
        """A channel for an engine with a mesh in a world of > 1 rank, else
        None (the engine serves alone)."""
        if getattr(engine, "mesh", None) is None or not dist.is_initialized() \
                or dist.get_world_size() == 1:
            return None
        return _TickChannel(engine.device)

    def exchange(self, tick: Optional[_Tick], encode, decode) -> _Tick:
        """The leader's tick on every rank (the leader's own objects on
        the leader, `decode`d copies elsewhere)."""
        if self.rank == 0:
            tensors = []
            msg = {"items": [encode(x, tensors) for x in tick.items],
                   "cancel": sorted(tick.cancel), "stop": tick.stop}
            broadcast_tick(msg, tensors, self.group, self.device)
            return tick
        msg, tensors = broadcast_tick(None, [], self.group, self.device)
        return _Tick([decode(x, tensors) for x in msg["items"]],
                     frozenset(msg["cancel"]), msg["stop"])

    def check(self, err: Optional[BaseException]) -> None:
        """Every rank's health after a boundary: raises `err` (this rank's
        own failure) or, where another rank failed, an error naming it."""
        msgs = all_status("" if err is None
                          else f"{type(err).__name__}: {err}", self.group)
        if err is not None:
            raise err
        bad = [f"rank {r}: {m}" for r, m in enumerate(msgs) if m]
        if bad:
            raise RuntimeError("; ".join(bad))


class _ThreadedEngine:
    """The scheduler thread shared by both front ends: locked submit and
    close (no registration after shutdown), queue draining, prefix
    tickets, cancellation and crash containment; over a meshed engine, the
    leader / follower protocol of the module docstring."""

    _thread_name = "serve-scheduler"

    def __init__(self, engine):
        self.eng = engine
        self.crash: Optional[str] = None   # the scheduler's error, if any
        self._q: "queue.Queue" = queue.Queue()
        self._uid = itertools.count()
        self._handles = {}
        self._stop = False
        self._lock = threading.Lock()
        self._sync = _TickChannel.open(engine)
        self.leader = self._sync is None or self._sync.rank == 0
        self._thread = threading.Thread(target=self._guarded_loop,
                                        daemon=True, name=self._thread_name)
        self._thread.start()

    def _check_leader(self):
        if not self.leader:
            raise RuntimeError(
                f"rank {self._sync.rank} follows rank 0's scheduler: submit, "
                f"cancel, prefix calls and close() go to rank 0; wait here "
                f"with wait_closed()")

    def _register(self, handle):
        with self._lock:
            if self._stop:
                raise RuntimeError("engine closed")
            self._handles[handle.uid] = handle
            self._q.put(handle)
        return handle

    def _submit_reg(self, reg: _PrefixReg) -> Optional[int]:
        """Queues a prefix ticket and blocks until the scheduler thread
        (the only owner of the engine and the device) has processed it."""
        self._check_leader()
        with self._lock:
            if self._stop:
                raise RuntimeError("engine closed")
            self._q.put(reg)
        while not reg.done.wait(0.2):
            if not self._thread.is_alive():
                raise RuntimeError("engine closed")
        if reg.error:
            raise RuntimeError(reg.error)
        return reg.pid

    def extend_prefix(self, prefix_id: int, payload) -> int:
        """Extends a registered prefix (the engine's extend_prefix) through
        the scheduler thread; returns the NEW prefix id."""
        return self._submit_reg(_PrefixReg(payload, parent=prefix_id))

    def drop_prefix(self, prefix_id: int) -> None:
        """Frees a registered prefix's cached KV through the scheduler
        thread; queued requests still naming the id then fail with
        "unknown prefix_id" when they are admitted to a slot."""
        self._submit_reg(_PrefixReg(None, drop=prefix_id))

    def close(self):
        """Stops the scheduler (on the leader of a meshed engine: every
        rank's) and joins it."""
        self._check_leader()
        with self._lock:
            if self._stop:
                return
            self._stop = True
            self._q.put(None)
        self._thread.join()

    def wait_closed(self, timeout: Optional[float] = None) -> bool:
        """Blocks until the scheduler thread has ended (a follower's: once
        the leader's close() has stopped it) or `timeout` seconds passed
        (False). Raises RuntimeError with the scheduler's error if it
        crashed."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            return False
        if self.crash:
            raise RuntimeError(self.crash)
        return True

    def _device(self):
        dev = self.eng.device
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _guarded_loop(self):
        err = "engine closed"
        try:
            with self._device(), torch.no_grad():
                self._loop()
        except Exception as e:  # noqa: BLE001 — a scheduler crash must
            # fail the handles, not strand their callers forever
            err = f"serving scheduler crashed: {type(e).__name__}: {e}"
            self.crash = err
        finally:
            with self._lock:
                self._stop = True
            self._fail_leftovers(err)

    def _fail_leftovers(self, msg: str):
        with self._lock:
            leftovers = list(self._handles.values())
            self._handles.clear()
        while True:                # tickets still queued fail their callers
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, _PrefixReg):
                item.error = msg
                item.done.set()
        for h in leftovers:
            self._finish(h, error=msg)

    @staticmethod
    def _finish(h: RequestHandle, error: Optional[str] = None):
        with h.cond:
            if not h.done.is_set():
                h.error = error
                h.done.set()
                h.cond.notify_all()

    def _run_tickets(self, waiting: list) -> list:
        """Processes the prefix tickets among `waiting`, in arrival order;
        returns the requests."""
        reqs = []
        for w in waiting:
            if isinstance(w, _PrefixReg):
                w.run(self.eng)
            else:
                reqs.append(w)
        return reqs

    def _reject_orphans(self, waiting: list) -> None:
        """Fails queued requests whose prefix was dropped after admission,
        before a refill would raise for them."""
        keep = []
        for h in waiting:
            pid = h.prefix_id
            if pid is not None and pid not in self.eng._prefixes:
                self._handles.pop(h.uid, None)
                self._finish(h, error=f"unknown prefix_id {pid}")
            else:
                keep.append(h)
        waiting[:] = keep

    def _cancelled(self, items: list) -> frozenset:
        """The uids whose RequestHandle.cancel() the boundary honours: the
        requests drained so far and those in flight (the flags read once,
        here, so every rank sweeps the same set)."""
        out = {h.uid for h in items
               if isinstance(h, RequestHandle) and h.cancelled}
        for st in self.eng._state:
            h = None if st is None else self._handles.get(st.uid)
            if h is not None and h.cancelled:
                out.add(st.uid)
        return frozenset(out)

    def _cancel_sweep(self, waiting: list, doomed: frozenset):
        """Honours RequestHandle.cancel() at the chunk boundary (scheduler
        thread only), for the uids in `doomed`. Queued requests complete at
        once with no tokens; requests in flight free their slot (on the
        host now, on the device through `_deactivate_slots`, so the slot
        stops decoding and no longer bounds the read window) and complete
        with the tokens streamed so far."""
        eng = self.eng
        keep = []
        for w in waiting:
            if w.uid in doomed:
                eng.stats["cancelled"] = eng.stats.get("cancelled", 0) + 1
                self._finish_cancelled(w)
            else:
                keep.append(w)
        waiting[:] = keep
        dead = []
        for s, st in enumerate(eng._state):
            if st is None or st.uid not in doomed:
                continue
            h = self._handles.get(st.uid)
            if h is not None:
                dead.append(s)
                eng._state[s] = None
                eng._shadow[s] = 0
                eng._cap[s] = 0
                eng.stats["tokens_out"] += len(h.tokens)
                eng.stats["cancelled"] = eng.stats.get("cancelled", 0) + 1
                self._finish_cancelled(h)
        if dead:
            self._deactivate_slots(
                torch.tensor(dead, dtype=torch.long, device=eng.device))

    def _finish_cancelled(self, h: RequestHandle):
        self._handles.pop(h.uid, None)
        self._finish(h)

    def _deactivate_slots(self, idx: torch.Tensor) -> None:
        raise NotImplementedError

    def _drain_queue(self, block: bool) -> list:
        """What arrived, in order (the close sentinel left out); with
        `block`, waits for the first item, on a meshed leader at most a
        heartbeat."""
        timeout = None if self._sync is None else self._sync.heartbeat
        out = []
        try:
            item = self._q.get(block=block, timeout=timeout if block
                               else None)
        except queue.Empty:
            return out
        while True:
            if item is not None:
                out.append(item)
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return out

    def _next_tick(self, waiting: list) -> _Tick:
        """The leader drains its queue (parking on it while idle) and
        decides; a follower receives the leader's decision."""
        tick = None
        if self.leader:
            idle = not waiting and all(st is None for st in self.eng._state)
            new = self._drain_queue(block=idle)
            tick = _Tick(new, self._cancelled(waiting + new), self._stop)
        if self._sync is not None:
            tick = self._sync.exchange(tick, self._encode, self._decode)
        return tick

    def _loop(self):
        eng = self.eng
        eng._reset_pool()
        waiting: list = []
        while True:
            tick = self._next_tick(waiting)
            if tick.stop:
                break
            waiting.extend(tick.items)
            if self._sync is None:
                self._boundary(waiting, tick.cancel)
                continue
            try:
                self._boundary(waiting, tick.cancel)
            except Exception as e:  # noqa: BLE001 — reported to every
                # rank, then raised by `check`
                self._sync.check(e)
            else:
                self._sync.check(None)

    def _boundary(self, waiting: list, doomed: frozenset):
        """One chunk boundary: tickets, cancels, orphans, refill, then a
        chunk while any slot is busy."""
        eng = self.eng
        waiting[:] = self._run_tickets(waiting)
        self._cancel_sweep(waiting, doomed)
        self._reject_orphans(waiting)
        if waiting:
            reqs = [self._request(h) for h in waiting]
            eng._refill(reqs)
            del waiting[:len(waiting) - len(reqs)]
        if any(st is not None for st in eng._state):
            self._step()

    # -- the tick's wire form (meshed engines) --------------------------------

    def _encode(self, item, tensors: list) -> dict:
        if isinstance(item, _PrefixReg):
            return {"pfx": None if item.payload is None
                    else self._payload_out(item.payload, tensors),
                    "parent": item.parent, "drop": item.drop}
        return {"req": self._request_out(item, tensors)}

    def _decode(self, msg: dict, tensors: list):
        if "pfx" in msg:
            return _PrefixReg(None if msg["pfx"] is None
                              else self._payload_in(msg["pfx"], tensors),
                              parent=msg["parent"], drop=msg["drop"])
        h = self._request_in(msg["req"], tensors)
        self._handles[h.uid] = h
        return h

    def _payload_out(self, payload, tensors: list):
        raise NotImplementedError

    def _payload_in(self, msg, tensors: list):
        raise NotImplementedError

    def _request_out(self, h, tensors: list) -> dict:
        raise NotImplementedError

    def _request_in(self, msg: dict, tensors: list):
        raise NotImplementedError

    def _request(self, h):
        raise NotImplementedError

    def _step(self):
        raise NotImplementedError


class OnlineEngine(_ThreadedEngine):
    """Online front end over the plain-LM DecodeEngine."""

    _thread_name = "lm-serve-scheduler"

    def submit(self, prompt: List[int], max_new_tokens: int, *,
               prefix_id: Optional[int] = None) -> RequestHandle:
        self._check_leader()
        if len(prompt) + max_new_tokens > self.eng.max_seq:
            raise ValueError(
                f"{len(prompt)}+{max_new_tokens} exceeds max_seq "
                f"{self.eng.max_seq}")
        if prefix_id is not None:
            # admission: a bad prefix reference fails THIS caller, not the
            # scheduler at refill time
            pfx = self.eng._prefixes.get(prefix_id)
            if pfx is None:
                raise ValueError(f"unknown prefix_id {prefix_id}")
            n = len(pfx["tokens"])
            if len(prompt) <= n or list(prompt[:n]) != pfx["tokens"]:
                raise ValueError(
                    f"prompt must extend prefix {prefix_id} ({n} tokens) "
                    f"by >= 1 token")
        h = RequestHandle(next(self._uid), [int(t) for t in prompt],
                          max_new_tokens)
        h.prefix_id = prefix_id
        return self._register(h)

    def register_prefix(self, tokens: List[int]) -> int:
        """Registers a shared prompt prefix (DecodeEngine.register_prefix)
        through the scheduler thread. Blocks until its KV is cached;
        returns the id for submit()."""
        self._check_leader()
        if not 1 <= len(tokens) < self.eng.max_seq:
            raise ValueError(f"prefix length {len(tokens)} must be in "
                             f"[1, max_seq={self.eng.max_seq})")
        return self._submit_reg(_PrefixReg([int(t) for t in tokens]))

    def _loop(self):
        self.eng._finished = []
        super()._loop()

    def _deactivate_slots(self, idx: torch.Tensor) -> None:
        """Stops the device decoding cancelled slots: the chunk's EOS and
        budget latch is the `active` flag (engine.py `_chunk`), so clearing
        it in place parks the slot: it emits pads and its pos freezes
        until a refill's prefill sets it again."""
        self.eng._dstate["active"][idx] = False

    def _request(self, h: RequestHandle) -> ServeRequest:
        return ServeRequest(uid=h.uid, prompt=h.prompt,
                            max_new_tokens=h.max_new, prefix_id=h.prefix_id)

    def _payload_out(self, payload, tensors):
        return payload                 # token ids

    def _payload_in(self, msg, tensors):
        return msg

    def _request_out(self, h: RequestHandle, tensors) -> dict:
        return {"uid": h.uid, "prompt": h.prompt, "max_new": int(h.max_new),
                "prefix_id": _opt_int(h.prefix_id)}

    def _request_in(self, msg: dict, tensors) -> RequestHandle:
        h = RequestHandle(msg["uid"], msg["prompt"], msg["max_new"])
        h.prefix_id = msg["prefix_id"]
        return h

    def _step(self):
        eng = self.eng
        eng._collect(eng._run_chunk().numpy())
        if self.leader:
            self._deliver()
        else:
            self._retire()

    def _retire(self):
        """A follower's `_deliver`: forgets the finished requests."""
        fin, self.eng._finished = self.eng._finished, []
        for uid, gen in fin:
            self._handles.pop(uid, None)
            self.eng.stats["tokens_out"] += len(gen)

    def _deliver(self):
        """Pushes the engine's progress out to the handles (after each
        collect; finished slots have moved to eng._finished)."""
        eng = self.eng
        fin, eng._finished = eng._finished, []
        for st in eng._state:
            if st is None:
                continue
            h = self._handles[st.uid]
            if len(st.generated) > len(h.tokens):
                with h.cond:
                    h.tokens.extend(st.generated[len(h.tokens):])
                    h.cond.notify_all()
        for uid, gen in fin:
            h = self._handles.pop(uid)
            eng.stats["tokens_out"] += len(gen)
            with h.cond:
                h.tokens = list(gen)
                h.done.set()
                h.cond.notify_all()


class GillOnlineEngine(_ThreadedEngine):
    """Online front end over GillDecodeEngine: asynchronous intake of full
    GILL decode requests, refill at chunk boundaries, streaming of each
    request's VALID token prefix, and the [IMG] taps at completion."""

    _thread_name = "gill-serve-scheduler"

    def submit(self, prompt_embs, num_words: int, *,
               min_word_tokens: int = 0, img_scale: float = 1.0,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int = 0, max_img_runs: int = 1,
               prefix_id: Optional[int] = None) -> GillRequestHandle:
        from gill_tpu_torch.serve.gill_engine import GillServeRequest

        self._check_leader()
        # with prefix_id set, prompt_embs carry only the suffix rows AFTER
        # the registered prefix (gill_engine.register_prefix)
        req = GillServeRequest(
            uid=next(self._uid), embs=prompt_embs, num_words=num_words,
            min_word_tokens=min_word_tokens, img_scale=img_scale,
            temperature=temperature, top_p=top_p, seed=seed,
            max_img_runs=max_img_runs, prefix_id=prefix_id)
        self.eng._validate(req)      # admission: refuse before scheduling
        h = GillRequestHandle(req.uid, req)
        h.prefix_id = prefix_id
        return self._register(h)

    def register_prefix(self, embs) -> int:
        """Registers a shared (P, E) embedding prefix
        (GillDecodeEngine.register_prefix) through the scheduler thread.
        Blocks until its KV is cached; returns the id for
        submit(prefix_id=...)."""
        self._check_leader()
        self.eng._check_embs(embs, "prefix")
        if not 1 <= embs.shape[0] < self.eng.max_seq:
            raise ValueError(f"prefix length {embs.shape[0]} must be in "
                             f"[1, max_seq={self.eng.max_seq})")
        return self._submit_reg(_PrefixReg(embs))

    def _deactivate_slots(self, idx: torch.Tensor) -> None:
        """Stops the device decoding cancelled slots. The GILL chunk has no
        active flag (`done` derives from force == 0 and iter >= nw, and
        `valid` latches from it every step, gill_engine.py `_chunk`), so a
        slot is parked by draining its force counter and pushing iter past
        any budget, in place; valid is cleared too, so pos freezes from the
        next fed token."""
        st = self.eng._dstate
        st["iter"][idx] = 2 ** 30
        st["force"][idx] = 0
        st["valid"][idx] = False

    def _request(self, h: GillRequestHandle):
        return h.request

    # the request's scalar fields and their wire types
    _FIELDS = {"num_words": int, "min_word_tokens": int, "img_scale": float,
               "temperature": float, "top_p": float, "seed": int,
               "max_img_runs": int, "prefix_id": _opt_int}

    def _payload_out(self, payload, tensors):
        tensors.append(torch.as_tensor(payload))
        return len(tensors) - 1        # an embedding payload's index

    def _payload_in(self, msg, tensors):
        return tensors[msg]

    def _request_out(self, h: GillRequestHandle, tensors) -> dict:
        req = h.request
        out = {f: cast(getattr(req, f)) for f, cast in self._FIELDS.items()}
        out.update(uid=req.uid, embs=self._payload_out(req.embs, tensors))
        return out

    def _request_in(self, msg: dict, tensors) -> GillRequestHandle:
        from gill_tpu_torch.serve.gill_engine import GillServeRequest

        req = GillServeRequest(uid=msg["uid"], embs=tensors[msg["embs"]],
                               **{f: msg[f] for f in self._FIELDS})
        h = GillRequestHandle(req.uid, req)
        h.prefix_id = req.prefix_id
        return h

    def _step(self):
        eng = self.eng
        toks, valids, tap = eng._run_chunk()
        for st in eng._state:
            if st is not None:
                st.planned += eng.chunk    # the sampling draws' counter
        rows = self._fold(toks.numpy(), valids.numpy())
        if self.leader:
            self._deliver(rows, tap)
        else:
            for _, st, _, finished in rows:
                if finished:
                    self._handles.pop(st.uid, None)

    def _fold(self, toks, valids) -> list:
        """Folds one chunk's rows into the slot states and frees the slots
        whose budget and fed (tap) coverage are both collected: (slot
        state, its new VALID-prefix tokens, finished) per busy slot."""
        eng = self.eng
        rows = []
        for s in range(eng.slots):
            st = eng._state[s]
            if st is None:
                continue
            lo = 0 if st.fresh else 1
            st.fresh = False
            st.fed += toks.shape[0] - 1
            new_tok = []
            for r in range(lo, toks.shape[0]):
                if len(st.generated) >= st.budget:
                    break
                t = int(toks[r, s])
                st.generated.append(t)
                st.valid.append(bool(valids[r, s]))
                if st.prefix_ok and valids[r, s]:
                    new_tok.append(t)
                else:
                    st.prefix_ok = False   # valid latches off
            # output m's tap is captured at fed step m + 1: finish only
            # once the fed coverage reaches the budget
            finished = len(st.generated) >= st.budget and st.fed >= st.budget
            if finished:
                eng._state[s] = None
                eng._shadow[s] = 0
                eng._cap[s] = 0
            rows.append((s, st, new_tok, finished))
        return rows

    def _deliver(self, rows: list, tap):
        """Streams each request's new valid tokens and completes the
        finished ones with their taps. The tap ring comes to the host only
        when a slot finishes in this chunk."""
        tap_host = None
        for s, st, new_tok, finished in rows:
            h = self._handles[st.uid]
            if new_tok:
                with h.cond:
                    h.tokens.extend(new_tok)
                    h.cond.notify_all()
            if not finished:
                continue
            if tap_host is None:
                tap_host = tap.float().cpu().numpy()
            self._handles.pop(st.uid)
            self.eng.stats["tokens_out"] += len(h.tokens)
            with h.cond:
                h.img_hidden = np.array(tap_host[s, 0])
                h.img_runs = np.array(tap_host[s])
                h.done.set()
                h.cond.notify_all()
