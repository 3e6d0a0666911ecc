"""The port's OpenAI-compatible server and `cli serve`, on the CPU.

Every route of `mnn_tpu/serve/server.py` (`tests/test_server.py`,
`tests/test_server_batch.py`) on a `tiny` model with random weights, served
on 127.0.0.1 at a free port: single-stream mode (`Llm.stream` under the
lock) and engine mode (a 3-slot `BatchEngine` on its own thread). Every
socket has a timeout, so no case can hang the suite.

One expected difference from the JAX server: streamed /v1/completions
chunks carry their logprobs in the completions format (`tokens`,
`token_logprobs`, `top_logprobs`), as the non-streamed answer does; the
JAX server streams them in the chat format (`{"content": [...]}`) there.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import pytest
import torch

from mnn_tpu_torch import cli
from mnn_tpu_torch.models import decoder
from mnn_tpu_torch.models.config import PRESETS, RuntimeConfig
from mnn_tpu_torch.runtime.batch_engine import BatchEngine
from mnn_tpu_torch.runtime.llm import Llm
from mnn_tpu_torch.serve import server

CFG = PRESETS["tiny"]
RT = RuntimeConfig(max_seq_len=128, prefill_chunk=32, decode_block=4,
                   sampler="greedy", kv_quant=True, lm_head_bits=4,
                   max_new_tokens=6)
TIMEOUT = 60


def make_llm():
    params = decoder.init_random_params(CFG, torch.Generator().manual_seed(2),
                                        scale=0.05, lm_head_bits=4, device="cpu")
    return Llm(CFG, params, RT, device="cpu")


def start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_server(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def single():
    llm = make_llm()
    httpd, thread, url = start(server.make_handler(llm, threading.Lock()))
    yield url, llm
    stop_server(httpd, thread)


@pytest.fixture(scope="module")
def batched():
    llm = make_llm()
    engine = BatchEngine(CFG, llm.params, dataclasses.replace(RT, max_batch=3),
                         tokenizer=llm.tokenizer, eos_ids=llm.tokenizer.eos_ids)
    stop = threading.Event()
    worker = threading.Thread(target=engine.run_forever, args=(stop,), daemon=True)
    worker.start()
    httpd, thread, url = start(server.make_handler(llm, threading.Lock(), engine))
    yield url, llm, engine
    stop_server(httpd, thread)
    stop.set()
    worker.join(timeout=TIMEOUT)
    assert not worker.is_alive()


def post(url, path, obj, raw=None):
    req = urllib.request.Request(url + path, data=raw or json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, r.headers, r.read().decode()


def post_json(url, path, obj):
    status, _, body = post(url, path, obj)
    return status, json.loads(body)


def get(url, path):
    with urllib.request.urlopen(url + path, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def events(raw):
    lines = [ln[len("data: "):] for ln in raw.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(ln) for ln in lines[:-1]]


def status_of(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def chat(content, max_tokens=6, **kw):
    return dict(messages=[{"role": "user", "content": content}],
                max_tokens=max_tokens, **kw)


# --------------------------------------------------------------------------
# single-stream mode
# --------------------------------------------------------------------------

def test_models_and_metrics(single):
    url, _ = single
    status, body = get(url, "/v1/models")
    assert status == 200 and body["data"][0]["id"] == "tiny"
    assert get(url, "/models")[1] == body
    post_json(url, "/v1/chat/completions", chat("hello"))
    status, m = get(url, "/metrics")
    assert status == 200 and m["gen_len"] == 6 and "decode_tok_s" in m
    assert m["device"] == "cpu" and m["model"] == "tiny" and m["kv_bits"] == 8
    assert m["context_len"] == m["prompt_len"] + m["gen_len"]


def test_chat_completion(single):
    url, llm = single
    status, body = post_json(url, "/v1/chat/completions", chat("hello", 5))
    assert status == 200 and body["object"] == "chat.completion"
    msg = body["choices"][0]["message"]
    assert msg["role"] == "assistant" and body["choices"][0]["finish_reason"] == "stop"
    assert body["usage"]["completion_tokens"] == 5
    prompt = llm.tokenizer.apply_chat_template([{"role": "user", "content": "hello"}])
    llm.reset()
    assert msg["content"] == llm.generate(token_ids=llm.tokenizer.encode(prompt),
                                          max_new_tokens=5)
    assert body["usage"]["prompt_tokens"] == len(llm.tokenizer.encode(prompt))


def test_streaming(single):
    url, _ = single
    status, headers, raw = post(url, "/v1/chat/completions",
                                chat("hi", 6, stream=True))
    assert status == 200 and headers["Content-Type"].startswith("text/event-stream")
    evs = events(raw)
    assert evs[-1]["choices"][0]["finish_reason"] == "stop"
    text = "".join(e["choices"][0]["delta"].get("content", "") for e in evs)
    _, body = post_json(url, "/v1/chat/completions", chat("hi", 6))
    assert body["choices"][0]["message"]["content"].startswith(text)


def test_completions_single_stream(single):
    url, _ = single
    status, body = post_json(url, "/v1/completions", {"prompt": "abc", "max_tokens": 4})
    assert status == 200 and body["object"] == "text_completion"
    assert isinstance(body["choices"][0]["text"], str)
    assert body["usage"] == {"prompt_tokens": 3, "completion_tokens": 4,
                             "total_tokens": 7}
    _, _, raw = post(url, "/completions", {"prompt": "abc", "max_tokens": 4,
                                           "stream": True})
    evs = events(raw)
    assert all(e["choices"][0]["delta"] == {} for e in evs)
    text = "".join(e["choices"][0].get("text") or "" for e in evs)
    assert body["choices"][0]["text"].startswith(text)


def test_logprobs_need_the_engine(single):
    url, _ = single
    assert status_of(lambda: post(url, "/v1/completions",
                                  {"prompt": "a", "logprobs": 1})) == 400


def test_reset_and_continue_context(single):
    url, llm = single
    status, body = post_json(url, "/reset", {})
    assert status == 200 and body["ok"] and llm.context_len == 0
    post_json(url, "/v1/completions", {"prompt": "abcd", "max_tokens": 3})
    assert get(url, "/metrics")[1]["context_len"] == 7
    post_json(url, "/v1/completions", {"prompt": "xy", "max_tokens": 2,
                                       "continue_context": True})
    assert get(url, "/metrics")[1]["context_len"] == 7 + 2 + 2
    assert post_json(url, "/v1/reset", {})[0] == 200 and llm.context_len == 0


def test_logit_bias_and_timeout(single):
    url, _ = single
    _, body = post_json(url, "/v1/completions", {
        "prompt": "abc", "max_tokens": 5, "logit_bias": {str(ord("Q")): 1000}})
    assert body["choices"][0]["text"] == "QQQQQ"
    _, body = post_json(url, "/v1/completions", {"prompt": "abc", "max_tokens": 5})
    assert body["choices"][0]["text"] != "QQQQQ"       # per request
    # a streamed request stops after its first decode block (the JAX
    # server, too, passes `timeout` to the streamed single-stream branch only)
    _, _, raw = post(url, "/v1/completions", {
        "prompt": "abc", "max_tokens": 10_000, "timeout": 1e-9, "stream": True})
    assert len(events(raw)) <= RT.decode_block + 1


def test_bad_json_missing_field_and_unknown_routes(single):
    url, _ = single
    assert status_of(lambda: post(url, "/v1/chat/completions", None,
                                  raw=b"{not json")) == 400
    assert status_of(lambda: post(url, "/v1/chat/completions", {"max_tokens": 4})) == 400
    assert status_of(lambda: post(url, "/v1/completions", {"max_tokens": 4})) == 400
    assert status_of(lambda: post(url, "/v1/chat/completions",
                                  {"messages": 5})) == 400
    assert status_of(lambda: get(url, "/nope")) == 404
    assert status_of(lambda: post(url, "/v1/nope", {})) == 404


# --------------------------------------------------------------------------
# engine mode
# --------------------------------------------------------------------------

def test_engine_concurrent_clients_match_sequential(batched):
    url, _, engine = batched
    contents = ["first prompt", "a second, longer prompt of the three", "3"]
    one = lambda c: post_json(url, "/v1/chat/completions", chat(c, 6))[1]
    sequential = [one(c) for c in contents]
    with ThreadPoolExecutor(3) as ex:
        concurrent = [f.result(timeout=TIMEOUT) for f in
                      [ex.submit(one, c) for c in contents]]
    for a, b in zip(sequential, concurrent):
        assert b["usage"]["completion_tokens"] == 6
        assert a["choices"][0]["message"] == b["choices"][0]["message"]
    assert engine.slots == [None] * 3


def test_engine_answers_what_single_stream_answers(batched, single):
    burl = batched[0]
    surl = single[0]
    for c in ("hello", "something else"):
        a = post_json(burl, "/v1/chat/completions", chat(c, 6))[1]
        b = post_json(surl, "/v1/chat/completions", chat(c, 6))[1]
        assert a["choices"][0]["message"] == b["choices"][0]["message"]


def test_engine_streaming(batched):
    url = batched[0]
    _, headers, raw = post(url, "/v1/chat/completions", chat("hi", 6, stream=True))
    assert headers["Content-Type"].startswith("text/event-stream")
    evs = events(raw)
    assert evs[-1]["choices"][0]["finish_reason"] == "stop"
    text = "".join(e["choices"][0]["delta"].get("content", "") for e in evs)
    _, body = post_json(url, "/v1/chat/completions", chat("hi", 6))
    assert body["choices"][0]["message"]["content"].startswith(text)


def test_engine_completions_logprobs_in_the_completions_format(batched):
    """Both branches: the non-streamed answer and every streamed chunk carry
    `tokens` / `token_logprobs` / `top_logprobs` (the JAX server streams
    the chat format here; this is the port's one departure)."""
    url = batched[0]
    req = {"prompt": "logprobs, please", "max_tokens": 6, "logprobs": 2}
    _, body = post_json(url, "/v1/completions", req)
    lp = body["choices"][0]["logprobs"]
    assert set(lp) == {"tokens", "token_logprobs", "top_logprobs"}
    assert len(lp["token_logprobs"]) == 6 and all(v <= 0 for v in lp["token_logprobs"])
    assert all(1 <= len(t) <= 2 for t in lp["top_logprobs"])
    assert "".join(lp["tokens"]) == body["choices"][0]["text"]
    _, _, raw = post(url, "/v1/completions", dict(req, stream=True))
    streamed = {"tokens": [], "token_logprobs": []}
    for e in events(raw)[:-1]:
        chunk_lp = e["choices"][0]["logprobs"]
        assert set(chunk_lp) == {"tokens", "token_logprobs", "top_logprobs"}
        assert "content" not in chunk_lp
        for k in streamed:
            streamed[k] += chunk_lp[k]
    n = len(streamed["tokens"])
    assert n >= 1
    assert streamed["tokens"] == lp["tokens"][:n]
    assert streamed["token_logprobs"] == pytest.approx(lp["token_logprobs"][:n])


def test_engine_chat_logprobs(batched):
    url = batched[0]
    _, body = post_json(url, "/v1/chat/completions",
                        chat("hi", 4, logprobs=True, top_logprobs=3))
    content = body["choices"][0]["logprobs"]["content"]
    assert len(content) == 4
    for entry in content:
        assert entry["logprob"] <= 0 and len(entry["top_logprobs"]) == 3
        assert entry["top_logprobs"][0]["logprob"] == pytest.approx(entry["logprob"])


def test_engine_logit_bias_timeout_and_reset(batched):
    url, llm, _ = batched
    _, body = post_json(url, "/v1/completions", {
        "prompt": "abc", "max_tokens": 4, "logit_bias": {str(ord("Z")): 1000}})
    assert body["choices"][0]["text"] == "ZZZZ"
    _, body = post_json(url, "/v1/completions", {
        "prompt": "abc", "max_tokens": 10_000, "timeout": 1e-9})
    assert body["usage"]["completion_tokens"] == 0     # expired while queued
    assert post_json(url, "/reset", {})[0] == 200 and llm.context_len == 0
    assert status_of(lambda: post(url, "/v1/completions", {})) == 400


# --------------------------------------------------------------------------
# serve() and cli serve
# --------------------------------------------------------------------------

def test_serve_in_a_thread_answers_and_snapshots(monkeypatch, tmp_path, capsys):
    """`serve()` itself, started in a thread on a free port in engine mode:
    it answers, writes its engine's state on shutdown, and a second
    `serve()` resumes from that file."""
    made = []

    class Recording(ThreadingHTTPServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(server, "ThreadingHTTPServer", Recording)
    llm = make_llm()
    snap = str(tmp_path / "state")
    for run in range(2):
        thread = threading.Thread(target=server.serve, args=(llm,), daemon=True,
                                  kwargs=dict(port=0, batch=2, snapshot_path=snap))
        thread.start()
        deadline = time.monotonic() + TIMEOUT
        while len(made) <= run and time.monotonic() < deadline:
            time.sleep(0.01)
        url = f"http://127.0.0.1:{made[run].server_address[1]}"
        status, body = post_json(url, "/v1/completions", {"prompt": "hi", "max_tokens": 3})
        assert status == 200 and body["usage"]["completion_tokens"] == 3
        made[run].shutdown()
        thread.join(timeout=TIMEOUT)
        assert not thread.is_alive() and os.path.exists(snap)
    out = capsys.readouterr().out
    assert "(continuous batching x2)" in out and f"snapshotted to {snap}" in out
    assert f"resumed engine from {snap} (0 in-flight requests)" in out


def test_serve_refuses_data_parallel():
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        server.serve(make_llm(), port=0, dp=2)


def test_cli_serve_parses_its_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(server, "serve", lambda llm, **kw: seen.update(llm=llm, **kw))
    cli.main(["serve", "--synthetic", "tiny", "--device", "cpu", "--max-seq-len", "64",
              "--batch", "4", "--snapshot", "s.npz", "--host", "0.0.0.0",
              "--port", "8123", "--dp", "1", "--sampler", "greedy"])
    llm = seen.pop("llm")
    assert seen == dict(host="0.0.0.0", port=8123, batch=4, snapshot_path="s.npz", dp=1)
    assert llm.device == torch.device("cpu") and llm.rt.max_seq_len == 64
    assert llm.rt.kv_bits == 8 and llm.rt.prefill_act_bits == 8
    monkeypatch.undo()                # the real serve() refuses dp > 1
    with pytest.raises(NotImplementedError):
        cli.main(["serve", "--synthetic", "tiny", "--device", "cpu",
                  "--max-seq-len", "64", "--dp", "2"])


def test_cli_serve_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "--synthetic", "tiny"])
