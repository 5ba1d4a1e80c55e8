"""HTTP front end for the serving engines, stdlib only (counterpart of
gill_tpu/serve/http.py).

Endpoints:
  GET  /healthz        -> {"ok": true}
  GET  /stats          -> engine counters (prefills, chunks, tokens_out, ...)
  POST /v1/generate    -> body {"prompt": [int ids]} or {"text": "..."}
                          plus "max_new_tokens" (int, default 64),
                          "stream" (bool, default false), and optional
                          "prefix_id" (from /v1/prefix; the prompt must
                          start with that prefix's tokens).
  POST /v1/prefix      -> body {"prompt": [int ids]} or {"text": "..."};
                          prefills the shared prefix once and returns
                          {"prefix_id": id, "len": n} — subsequent
                          /v1/generate calls with that prefix_id skip the
                          shared tokens' prefill (prefix caching).
                          {"extend": pid, "prompt"/"text": ...} grows a
                          registered prefix by only prefilling the new
                          tokens (returns a NEW id; "len" = extension);
                          {"drop": pid} frees one.
  POST /v1/gill_prefix -> body {"prompts": [...]} (same format as
                          /v1/gill, optional "max_num_rets"); registers a
                          shared conversation prefix (system prompt +
                          history, images included) with the GILL engine
                          and returns {"prefix_id": id}. Subsequent
                          /v1/gill calls pass that prefix_id with prompts
                          holding only the NEW turn. {"extend": pid,
                          "prompts": [...]} grows a prefix by one turn
                          (prompt + generated reply text) without
                          re-prefilling history; {"drop": pid} frees one.
       non-stream: one JSON object {"tokens": [...], "text": "..."}.
       stream:     chunked NDJSON — one {"token": id, "text": piece} line
                   per generated token as it leaves the scheduler, then a
                   final {"done": true, "n": count} line.

"text" requires a tokenizer with encode()/decode() (gill_tpu_torch.tokenizer);
token-id requests work without one. Every request rides the continuous-
batching OnlineEngine — concurrent requests share the slot pool instead of
queueing behind each other (the reference demo's gradio queue serializes at
concurrency 1). POST /v1/gill and /v1/gill_prefix need a GILL model
(`make_server(gill=...)`): body {"prompts": [str | {"image_b64": ...}],
"num_words", "min_word_tokens", "ret_scale_factor", "gen_scale_factor",
"max_num_rets", "guidance_scale", "num_inference_steps", "prefix_id"} ->
{"outputs": generate_for_images_and_texts' structure, images as base64
PNG}.

    python -m gill_tpu_torch.serve.http [--model facebook/opt-125m]
        [--device cuda] [--port 8000]

serves an OPT model with zero weights of the right structure
(`models/opt.py init_dummy`) on the card unless --device names another.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from gill_tpu_torch.serve.online import OnlineEngine


def _b64_png(img) -> str:
    import base64
    import io

    buf = io.BytesIO()
    img.save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _serialize_gill_outputs(outs):
    """generate_for_images_and_texts output -> JSON-safe structure (PIL
    images as base64 PNG, numpy scalars as floats)."""
    ser = []
    for o in outs:
        if isinstance(o, str):
            ser.append(o)
            continue
        d = {"decision": o.get("decision"),
             "ret": [{"image_b64": _b64_png(img), "score": float(s)}
                     for img, _, s in o.get("ret", [])],
             "gen": []}
        for g in o.get("gen", []):
            if isinstance(g, tuple):
                d["gen"].append({"image_b64": _b64_png(g[0]),
                                 "score": float(g[1])})
        ser.append(d)
    return ser


def make_server(online: Optional[OnlineEngine] = None, tokenizer=None,
                host: str = "127.0.0.1", port: int = 0,
                gill=None, sd_batching: bool = True) -> ThreadingHTTPServer:
    """Build (not start) the server; port 0 picks a free port
    (server_address[1] after construction). Run with serve_forever().

    online: plain-LM continuous-batching backend for /v1/generate.
    gill:   an api.GILL model enabling /v1/gill — the FULL multimodal
            pipeline (interleaved text+image prompts, [IMG]-routed
            retrieval / decision / SD generation) over the online GILL
            engine; concurrent requests share its slot pool.
    sd_batching: coalesce concurrent /v1/gill SD denoises into one
            cross-request CFG batch (serve/sd_queue.py) instead of
            serializing them on the device."""
    if gill is not None and sd_batching and gill.sd_pipe is not None:
        gill.enable_sd_batching()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):     # quiet by default
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                stats = {}
                if online is not None:
                    stats["lm"] = dict(online.eng.stats)
                if gill is not None and getattr(gill, "_online_engines",
                                                None):
                    stats["gill"] = {
                        str(k): dict(v.eng.stats)
                        for k, v in gill._online_engines.items()}
                self._json(200, stats)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def _gill_prompts(self, req):
            import base64
            import io

            from PIL import Image as PILImage

            prompts = []
            for p in req.get("prompts", []):
                if isinstance(p, str):
                    prompts.append(p)
                elif isinstance(p, dict) and "image_b64" in p:
                    prompts.append(PILImage.open(io.BytesIO(
                        base64.b64decode(p["image_b64"]))).convert("RGB"))
                else:
                    raise ValueError(
                        "prompts entries must be strings or "
                        "{'image_b64': ...} objects")
            if not prompts:
                raise ValueError("need non-empty 'prompts'")
            return prompts

        def _do_gill(self, req):
            prompts = self._gill_prompts(req)
            max_num_rets = int(req.get("max_num_rets", 1))
            pid = req.get("prefix_id")
            handle = gill.generate_async(
                prompts, num_words=int(req.get("num_words", 32)),
                min_word_tokens=int(req.get("min_word_tokens", 0)),
                ret_scale_factor=float(req.get("ret_scale_factor", 1.0)),
                gen_scale_factor=float(req.get("gen_scale_factor", 1.0)),
                max_num_rets=max_num_rets,
                prefix_id=None if pid is None else int(pid))
            outs = gill.finalize_async(
                handle,
                guidance_scale=float(req.get("guidance_scale", 7.5)),
                num_inference_steps=int(req.get("num_inference_steps", 50)),
                max_num_rets=max_num_rets)
            self._json(200, {"outputs": _serialize_gill_outputs(outs)})

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data + b"\r\n")

        def _prompt_ids(self, req):
            if "prompt" in req:
                return [int(t) for t in req["prompt"]]
            if "text" in req:
                if tokenizer is None:
                    raise ValueError(
                        "'text' requires a server-side tokenizer; "
                        "send token ids via 'prompt'")
                return list(tokenizer.encode(req["text"]))
            raise ValueError("need 'prompt' (ids) or 'text'")

        def do_POST(self):
            if self.path not in ("/v1/generate", "/v1/gill", "/v1/prefix",
                                 "/v1/gill_prefix"):
                self._json(404, {"error": f"no route {self.path}"})
                return
            if self.path == "/v1/gill_prefix":
                if gill is None:
                    self._json(404, {"error": "no GILL model mounted"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    rets = int(req.get("max_num_rets", 1))
                    if "drop" in req:
                        gill.drop_prefix_async(int(req["drop"]),
                                               max_num_rets=rets)
                        self._json(200, {"ok": True})
                        return
                    prompts = self._gill_prompts(req)
                    if "extend" in req:
                        pid = gill.extend_prefix_async(
                            int(req["extend"]), prompts, max_num_rets=rets)
                    else:
                        pid = gill.register_prefix_async(
                            prompts, max_num_rets=rets)
                    self._json(200, {"prefix_id": pid})
                except (ValueError, KeyError, TypeError, OSError,
                        RuntimeError, json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                return
            if self.path == "/v1/prefix":
                if online is None:
                    self._json(404, {"error": "no LM engine mounted"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if "drop" in req:
                        online.drop_prefix(int(req["drop"]))
                        self._json(200, {"ok": True})
                        return
                    ids = self._prompt_ids(req)
                    if "extend" in req:
                        # "len" is the EXTENSION length here, not the total
                        pid = online.extend_prefix(int(req["extend"]), ids)
                    else:
                        pid = online.register_prefix(ids)
                    self._json(200, {"prefix_id": pid, "len": len(ids)})
                except (ValueError, KeyError, TypeError, RuntimeError,
                        json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                return
            if self.path == "/v1/gill":
                if gill is None:
                    self._json(404, {"error": "no GILL model mounted"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    self._do_gill(req)
                # OSError covers PIL.UnidentifiedImageError on garbage
                # image_b64 payloads (binascii.Error is a ValueError)
                except (ValueError, KeyError, TypeError, OSError,
                        json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                return
            if online is None:
                self._json(404, {"error": "no LM engine mounted"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = self._prompt_ids(req)
                max_new = int(req.get("max_new_tokens", 64))
                pid = req.get("prefix_id")
                handle = online.submit(prompt, max_new,
                                       prefix_id=None if pid is None
                                       else int(pid))
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return

            if not req.get("stream", False):
                toks = handle.result()
                text = tokenizer.decode(toks) if tokenizer else None
                self._json(200, {"tokens": toks, "text": text})
                return

            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            count = 0
            try:
                for tok in handle.stream():
                    piece = tokenizer.decode([tok]) if tokenizer else None
                    self._chunk(json.dumps(
                        {"token": tok, "text": piece}).encode() + b"\n")
                    count += 1
                self._chunk(json.dumps({"done": True, "n": count}).encode()
                            + b"\n")
            except RuntimeError as e:
                # engine closed / scheduler crash mid-stream: the client
                # gets a terminal error record, not a truncated body
                self._chunk(json.dumps({"error": str(e)}).encode() + b"\n")
            except OSError:
                # the CLIENT went away mid-stream (broken pipe / reset):
                # cancel the request so its slot frees at the next chunk
                # boundary instead of decoding to completion for nobody
                handle.cancel()
                self.close_connection = True
                return
            self.wfile.write(b"0\r\n\r\n")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[list] = None):
    """CLI: serves an OPT model with zero weights of the right structure
    (`models/opt.py init_dummy`) for token-id requests, on the card unless
    --device names another."""
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="facebook/opt-125m")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--slots", type=int, default=16)
    p.add_argument("--max-seq", type=int, default=512)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--kv-read-buckets", default="auto",
                   help="decode KV read-window buckets: 'auto' "
                        "(power-of-two ladder), 'off' (always read "
                        "max_seq rows), or comma-separated row counts "
                        "(e.g. 256,512,1024)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: the card)")
    args = p.parse_args(argv)
    if args.kv_read_buckets == "off":
        kv_buckets = None
    elif args.kv_read_buckets == "auto":
        kv_buckets = "auto"
    else:
        kv_buckets = tuple(int(b) for b in
                           args.kv_read_buckets.split(","))

    from gill_tpu_torch.config import OPTConfig
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.serve.engine import DecodeEngine

    device = torch.device(args.device)
    cfg = OPTConfig.from_name(args.model)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = opt_mod.init_dummy(cfg, dtype, device=device)
    eng = DecodeEngine(params, cfg, slots=args.slots, max_seq=args.max_seq,
                       chunk=args.chunk, kv_dtype=dtype,
                       kv_read_buckets=kv_buckets)
    eng.warmup()
    online = OnlineEngine(eng)
    srv = make_server(online, host=args.host, port=args.port)
    print(f"serving {args.model} on {device} at http://{args.host}:"
          f"{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        online.close()


if __name__ == "__main__":
    main()
