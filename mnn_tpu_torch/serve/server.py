"""OpenAI-compatible HTTP server.

Counterpart of `mnn_tpu/serve/server.py`: POST /v1/chat/completions and
/v1/completions (also without the /v1 prefix) with optional SSE streaming
and logprobs, POST /reset, GET /v1/models and /metrics, on the standard
library's `http.server` (the engine is the bottleneck, not the HTTP layer).

Two modes. Single-stream (`batch` 1): each request runs through
`Llm.stream` under one lock, one at a time, on the `Llm`'s own cache.
Engine mode (`batch` > 1): a `BatchEngine` over the `Llm`'s weights serves
the requests side by side. Its one scheduler thread runs all of its device
work; the handler threads only submit, cancel and read the requests'
queues, so no two threads launch kernels at once (the per-device
workspaces of flash decode, the M = 1 GEMV and the fused expert kernel
allow one stream at a time). `/reset` touches only the `Llm`'s own cache,
under the lock.

One departure from the JAX server: streamed /v1/completions chunks carry
their logprobs in the completions format (`tokens`, `token_logprobs`,
`top_logprobs`), as its non-streamed answers do; the JAX server streams
them in the chat format there. Per-request `temperature` / `top_p` are
written into the `Llm`'s runtime config as the JAX server writes them, so
the engine, which keeps its own, does not see them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _sse(obj) -> bytes:
    return f"data: {json.dumps(obj)}\n\n".encode()


def make_handler(llm, lock: threading.Lock, engine=None):
    tok = llm.tokenizer

    def chat_logprobs(items):
        """OpenAI chat.completion logprobs of (token, lp, tops) items."""
        return {"content": [{
            "token": tok.decode([t]), "logprob": lp,
            "top_logprobs": [{"token": tok.decode([i]), "logprob": v}
                             for i, v in tops]} for t, lp, tops in items]}

    def completion_logprobs(items):
        """OpenAI text_completion logprobs of (token, lp, tops) items."""
        return {"tokens": [tok.decode([t]) for t, _, _ in items],
                "token_logprobs": [lp for _, lp, _ in items],
                "top_logprobs": [{tok.decode([i]): v for i, v in tops}
                                 for _, _, tops in items]}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _start_sse(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data + b"\r\n")

        def _end_sse(self, rid, created, model_name):
            self._chunk(_sse({
                "id": rid, "object": "chat.completion.chunk",
                "created": created, "model": model_name,
                "choices": [{"index": 0, "delta": {}, "finish_reason": "stop"}],
            }))
            self._chunk(b"data: [DONE]\n\n")
            self._chunk(b"")

        def do_GET(self):
            if self.path in ("/v1/models", "/models"):
                self._json(200, {
                    "object": "list",
                    "data": [{
                        "id": llm.config.name, "object": "model",
                        "owned_by": "mnn_tpu",
                    }],
                })
            elif self.path == "/metrics":
                p = llm.perf
                self._json(200, {
                    "prompt_len": p.prompt_len, "gen_len": p.gen_len,
                    "prefill_tok_s": round(p.prefill_tok_s, 2),
                    "decode_tok_s": round(p.decode_tok_s, 2),
                    "context_len": llm.context_len,
                    **llm.info(),
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._json(400, {"error": {"message": "invalid JSON body"}})
                return

            if self.path in ("/reset", "/v1/reset"):
                with lock:
                    llm.reset()
                self._json(200, {"ok": True})
                return
            if self.path not in ("/v1/chat/completions", "/chat/completions",
                                 "/v1/completions", "/completions"):
                self._json(404, {"error": "not found"})
                return

            chat = "chat" in self.path
            try:
                if chat:
                    prompt = tok.apply_chat_template(body["messages"])
                else:
                    prompt = body["prompt"]
            except (KeyError, TypeError) as e:
                self._json(400, {"error": {"message": f"missing field: {e}"}})
                return

            max_tokens = body.get("max_tokens") or body.get(
                "max_completion_tokens") or llm.rt.max_new_tokens
            # OpenAI logit_bias: {"token_id": bias} -> (id, bias) pairs
            logit_bias = None
            if body.get("logit_bias"):
                logit_bias = tuple(
                    (int(k), float(v))
                    for k, v in dict(body["logit_bias"]).items())
            timeout_s = float(body.get("timeout", 0) or 0)
            if body.get("temperature") is not None:
                llm.rt.temperature = float(body["temperature"])
            if body.get("top_p") is not None:
                llm.rt.top_p = float(body["top_p"])
            stream = bool(body.get("stream"))
            # OpenAI logprobs: chat = bool `logprobs` + int `top_logprobs`;
            # completions = int `logprobs` (top-N). -1 = off.
            if chat:
                lp = (int(body.get("top_logprobs") or 0)
                      if body.get("logprobs") else -1)
            else:
                lp = (int(body["logprobs"])
                      if body.get("logprobs") is not None else -1)
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            created = int(time.time())
            model_name = body.get("model") or llm.config.name

            if engine is not None:
                self._engine_completion(prompt, max_tokens, stream, rid,
                                        created, model_name, chat,
                                        logit_bias=logit_bias,
                                        timeout_s=timeout_s or None,
                                        logprobs=lp)
                return
            if lp >= 0:
                self._json(400, {"error": {"message":
                    "logprobs requires the batching engine "
                    "(serve with --batch > 1)"}})
                return
            with lock:
                llm.rt = dataclasses.replace(llm.rt, logit_bias=logit_bias)
                if not body.get("continue_context"):
                    llm.reset()
                if stream:
                    self._start_sse()
                    buf = []
                    for t in llm.stream(token_ids=tok.encode(prompt),
                                        max_new_tokens=max_tokens,
                                        timeout_s=timeout_s or None):
                        buf.append(t)
                        text = tok.decode(buf)
                        if text.endswith("�"):
                            continue
                        buf.clear()
                        self._chunk(_sse({
                            "id": rid, "object": "chat.completion.chunk",
                            "created": created, "model": model_name,
                            "choices": [{
                                "index": 0,
                                "delta": {"content": text} if chat else {},
                                "text": None if chat else text,
                                "finish_reason": None,
                            }],
                        }))
                    self._end_sse(rid, created, model_name)
                    return

                text = llm.generate(token_ids=tok.encode(prompt),
                                    max_new_tokens=max_tokens)
                p = llm.perf
                msg = {"role": "assistant", "content": text}
                self._json(200, {
                    "id": rid, "object": "chat.completion" if chat else
                    "text_completion", "created": created,
                    "model": model_name,
                    "choices": [{
                        "index": 0,
                        "message" if chat else "text": msg if chat else text,
                        "finish_reason": "stop",
                    }],
                    "usage": {
                        "prompt_tokens": p.prompt_len,
                        "completion_tokens": p.gen_len,
                        "total_tokens": p.prompt_len + p.gen_len,
                    },
                })

        def _engine_completion(self, prompt, max_tokens, stream, rid,
                               created, model_name, chat, logit_bias=None,
                               timeout_s=None, logprobs=-1):
            ids = tok.encode(prompt)
            req = engine.submit(ids, max_tokens, timeout_s=timeout_s,
                                logit_bias=logit_bias, logprobs=logprobs)
            fmt = chat_logprobs if chat else completion_logprobs

            def items():
                """(token, lp, tops) until the request ends."""
                while True:
                    item = req.out.get()
                    if item is None:
                        return
                    yield item if logprobs >= 0 else (item, None, None)

            if stream:
                self._start_sse()
                buf, lps = [], []
                for item in items():
                    lps.append(item)
                    buf.append(item[0])
                    text = tok.decode(buf)
                    if text.endswith("�"):
                        continue
                    buf.clear()
                    choice = {"index": 0,
                              "delta": {"content": text} if chat else {},
                              "text": None if chat else text,
                              "finish_reason": None}
                    if logprobs >= 0:
                        choice["logprobs"] = fmt(lps)
                    lps = []
                    self._chunk(_sse({
                        "id": rid, "object": "chat.completion.chunk",
                        "created": created, "model": model_name,
                        "choices": [choice],
                    }))
                self._end_sse(rid, created, model_name)
                return
            got = list(items())
            text = tok.decode([t for t, _, _ in got])
            msg = {"role": "assistant", "content": text}
            choice = {"index": 0,
                      "message" if chat else "text": msg if chat else text,
                      "finish_reason": "stop"}
            if logprobs >= 0:
                choice["logprobs"] = fmt(got)
            self._json(200, {
                "id": rid, "object": "chat.completion" if chat else
                "text_completion", "created": created, "model": model_name,
                "choices": [choice],
                "usage": {"prompt_tokens": len(ids),
                          "completion_tokens": len(got),
                          "total_tokens": len(ids) + len(got)},
            })

    return Handler


def serve(llm, host: str = "127.0.0.1", port: int = 9090, batch: int = 1,
          snapshot_path: str = "", dp: int = 1):
    """Serve `llm` until interrupted. batch > 1 enables the
    continuous-batching engine (multi-request) on the `Llm`'s device.

    snapshot_path makes the serving loop restartable: on startup the engine
    resumes from the snapshot if present; on shutdown the full engine state
    (KV cache, sampler, in-flight requests) is written back, so a restarted
    server continues mid-decode.

    dp > 1 (the batch sharded over a data-parallel mesh) is not ported:
    it is part of the parallelism work, ROADMAP.md Queue 1 item 11."""
    if dp > 1:
        raise NotImplementedError(
            "serving with dp > 1 (the engine's batch over a data-parallel "
            "mesh) is not ported: ROADMAP.md Queue 1 item 11, parallelism")
    lock = threading.Lock()
    engine = None
    stop = threading.Event()
    worker = None
    if batch > 1:
        from mnn_tpu_torch.runtime.batch_engine import BatchEngine

        rt = dataclasses.replace(llm.rt, max_batch=batch)
        eos = getattr(llm.tokenizer, "eos_ids", set())
        if snapshot_path and os.path.exists(snapshot_path):
            engine = BatchEngine.resume(
                snapshot_path, llm.config, llm.params, rt,
                tokenizer=llm.tokenizer, eos_ids=eos)
            n_live = sum(1 for s in engine.slots if s is not None)
            print(f"[mnn-tpu-torch] resumed engine from {snapshot_path} "
                  f"({n_live} in-flight requests)", flush=True)
        else:
            engine = BatchEngine(llm.config, llm.params, rt,
                                 tokenizer=llm.tokenizer, eos_ids=eos)
        worker = threading.Thread(target=engine.run_forever, args=(stop,),
                                  daemon=True)
        worker.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(llm, lock, engine))
    mode = f"continuous batching x{batch}" if engine else "single-stream"
    print(f"[mnn-tpu-torch] serving OpenAI-compatible API on "
          f"http://{host}:{httpd.server_address[1]} ({mode})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        if worker is not None:
            worker.join()
        if engine is not None and snapshot_path:
            engine.snapshot(snapshot_path)
            print(f"[mnn-tpu-torch] engine state snapshotted to "
                  f"{snapshot_path}", flush=True)
        httpd.server_close()
