"""The HTTP server of rrs_tpu_torch on the CPU: the cases of
tests/test_server.py for the ported routes (slot save / restore / erase
included), the routes and request options that once waited for the grammar
and server slices (now answering), the 501 answer of image parts, and
``python -m rrs_tpu_torch generate|serve|chat`` with bf16 and quantized KV caches. The in-process
server runs the tiny preset with random dense weights (scale 0.3, so that
greedy text varies) and the char-level vocabulary of tests/test_server.py."""

import http.client
import json
import queue
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest

from rrs_tpu_torch.models.config import PRESETS
from rrs_tpu_torch.models.llama import random_weights
from rrs_tpu_torch.models.vocab import Vocab
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.serving.engine import Engine, GenRequest
from rrs_tpu_torch.serving.server import ServerState, make_handler

from test_torch_common import tcq4_gguf, tiny_vocab_tokens

ROOT = Path(__file__).resolve().parent.parent
_STATE: dict = {}


@pytest.fixture(scope="module")
def server():
    cfg = PRESETS["tiny"]
    ctx = InferenceContext(cfg, random_weights(cfg, seed=0, scale=0.3, device="cpu"),
                           n_lanes=2, max_seq=128, device="cpu")
    engine = Engine(ctx)
    engine.start()
    n = cfg.vocab_size
    vocab = Vocab(model="gpt2", tokens=tiny_vocab_tokens(n), scores=None, token_types=[1] * n,
                  merges=[], pre="gpt-2", bos_id=0, eos_id=1, add_bos=False)
    _STATE["state"] = ServerState(cfg, vocab, engine, {}, "tiny-test")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(_STATE["state"]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield httpd.server_address[1], engine
    httpd.shutdown()
    httpd.server_close()
    engine.stop()


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def test_health_props_models(server):
    port, _ = server
    status, data = _req(port, "GET", "/health")
    assert status == 200 and json.loads(data)["status"] == "ok"
    assert json.loads(_req(port, "GET", "/props")[1])["total_slots"] == 2
    assert json.loads(_req(port, "GET", "/v1/models")[1])["data"][0]["id"] == "tiny-test"


def test_completion_nonstream(server):
    port, _ = server
    status, data = _req(port, "POST", "/v1/completions",
                        {"prompt": [5, 6, 7], "max_tokens": 4, "temperature": 0.0})
    assert status == 200, data
    body = json.loads(data)
    assert body["choices"][0]["finish_reason"] in ("stop", "length")
    assert isinstance(body["choices"][0]["text"], str)
    assert body["usage"]["prompt_tokens"] == 3 and body["usage"]["completion_tokens"] <= 4


def test_completion_stream(server):
    port, _ = server
    status, data = _req(port, "POST", "/completion",
                        {"prompt": [5, 6, 7], "n_predict": 5, "temperature": 0.0,
                         "stream": True})
    assert status == 200
    lines = [l for l in data.decode().split("\n") if l.startswith("data: ")]
    assert lines[-1] == "data: [DONE]"
    assert json.loads(lines[-2][6:])["choices"][0]["finish_reason"] == "length"


def test_chat_completion(server):
    port, _ = server
    status, data = _req(port, "POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 3, "temperature": 0.0})
    assert status == 200, data
    body = json.loads(data)
    assert body["choices"][0]["message"]["role"] == "assistant"
    assert body["usage"]["completion_tokens"] == 3


def test_parallel_requests_and_metrics(server):
    port, engine = server
    results = []

    def go(seed):
        s, d = _req(port, "POST", "/v1/completions",
                    {"prompt": [seed, seed + 1], "max_tokens": 4, "temperature": 0.0})
        results.append((s, json.loads(d)))

    threads = [threading.Thread(target=go, args=(i + 3,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 3 and all(s == 200 for s, _ in results)
    status, data = _req(port, "GET", "/metrics")
    assert status == 200 and b"llamacpp:requests_total" in data
    assert engine.n_decode_runs >= 1 and b"llamacpp:decode_runs_total" in data
    status, data = _req(port, "GET", "/slots")
    assert status == 200 and len(json.loads(data)) == 2


def test_tokenize_roundtrip(server):
    port, _ = server
    ids = json.loads(_req(port, "POST", "/tokenize", {"content": "AB"})[1])["tokens"]
    assert json.loads(_req(port, "POST", "/detokenize", {"tokens": ids})[1])["content"] == "AB"


def test_apply_template(server):
    port, _ = server
    status, data = _req(port, "POST", "/apply-template",
                        {"messages": [{"role": "user", "content": "hello"}]})
    assert status == 200 and "hello" in json.loads(data)["prompt"]


def test_logprobs_completion(server):
    port, _ = server
    status, data = _req(port, "POST", "/v1/completions", {
        "prompt": [5, 6, 7], "max_tokens": 3, "temperature": 0.0, "logprobs": 2})
    assert status == 200, data
    lp = json.loads(data)["choices"][0]["logprobs"]
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == 3
    assert all(v <= 0.0 for v in lp["token_logprobs"])
    assert all(1 <= len(t) <= 2 for t in lp["top_logprobs"])


def test_prompt_cache_reuse(server):
    port, engine = server
    prompt = [20, 21, 22, 23, 24, 25]
    _req(port, "POST", "/v1/completions", {"prompt": prompt, "max_tokens": 2,
                                            "temperature": 0.0})
    _req(port, "POST", "/v1/completions", {"prompt": prompt + [26], "max_tokens": 2,
                                            "temperature": 0.0})
    assert any(s.n_reused > 0 for s in engine.slots)


def test_engine_error_rollback(server):
    """A failing prefill releases the slot with reason 'error' and the engine
    keeps serving."""
    port, engine = server
    orig = engine.ctx.prefill
    calls = {"n": 0}

    def boom(seq_id, tokens, all_logits=True):
        calls["n"] += 1
        raise RuntimeError("injected fault")

    engine.ctx.prefill = boom
    try:
        q = queue.Queue()
        engine.submit(GenRequest(prompt_tokens=[1, 2, 3], max_tokens=2,
                                 on_token=lambda t, p, fin, r: q.put((fin, r))))
        fin, reason = q.get(timeout=60)
        assert fin and reason == "error" and calls["n"] == 1
    finally:
        engine.ctx.prefill = orig
    s, _ = _req(port, "POST", "/v1/completions",
                {"prompt": [4, 5], "max_tokens": 2, "temperature": 0.0})
    assert s == 200


def test_finish_reason_length(server):
    port, _ = server
    st, body = _req(port, "POST", "/v1/completions",
                    {"prompt": "ab", "max_tokens": 1, "temperature": 0})
    assert st == 200 and json.loads(body)["choices"][0]["finish_reason"] == "length"


def test_prompt_too_long_rejected(server):
    port, _ = server
    st, body = _req(port, "POST", "/v1/completions", {"prompt": "a" * 200, "max_tokens": 2})
    assert st == 200
    assert "prompt too long" in (json.loads(body)["choices"][0]["finish_reason"] or "")


def test_stop_string_reason_and_no_prefix_leak(server):
    port, _ = server
    _, free = _req(port, "POST", "/v1/completions",
                   {"prompt": "ab", "max_tokens": 6, "temperature": 0})
    text = json.loads(free)["choices"][0]["text"]
    assert len(text) >= 4, text
    stop = text[2:4]
    st, body = _req(port, "POST", "/v1/completions",
                    {"prompt": "ab", "max_tokens": 6, "temperature": 0, "stop": [stop]})
    out = json.loads(body)["choices"][0]
    assert st == 200 and out["finish_reason"] == "stop"
    assert out["text"] == text.split(stop)[0]


# Routes and request options that once answered 501 / 400 naming the ROADMAP
# item that brings them. The A6 (grammar) and A13 (the rest of the server)
# cases now answer: 200, or 400 where the request itself is wrong for this
# server (no FIM tokens in the vocabulary, an unregistered model name). The
# A11 and A11b cases (an image part, an audio part) answer as JAX's server
# does without a tower: the part reaches the chat template as it is (200).
WAITING = [
    ("POST", "/v1/embeddings", {"input": "AB"}, "A13", 200),
    ("POST", "/rerank", {"query": "a", "documents": ["b"]}, "A13", 200),
    ("POST", "/infill", {"input_prefix": "a", "input_suffix": "b"}, "A13", 400),
    ("POST", "/v1/messages", {"messages": [{"role": "user", "content": "hi"}],
                              "max_tokens": 4}, "A13", 200),
    ("POST", "/models/load", {"model": "x"}, "A13", 400),
    ("POST", "/models/unload", {"model": "x"}, "A13", 400),
    ("GET", "/", None, "A13", 200),
    ("POST", "/completion", {"prompt": "ab", "grammar": "root ::= [a-z]+", "max_tokens": 4},
     "A6", 200),
    ("POST", "/v1/completions", {"prompt": "ab", "json_schema": {"type": "object"},
                                 "max_tokens": 4}, "A6", 200),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                      "response_format": {"type": "json_object"},
                                      "max_tokens": 4}, "A6", 200),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AA=="}}]}]}, "A11",
     200),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "input_audio", "input_audio": {"data": "AA==", "format": "wav"}}]}]}, "A11b",
     200),
]


@pytest.mark.parametrize("method,path,body,item,code", WAITING,
                         ids=[f"{m} {p} {i}" for m, p, _, i, _ in WAITING])
def test_waiting_routes_answer_501(server, method, path, body, item, code):
    port, _ = server
    status, data = _req(port, method, path, body)
    assert status == code, data
    if code == 400:
        assert "ROADMAP" not in json.loads(data)["error"]
    elif path == "/":
        assert data.startswith(b"<!")
    else:
        assert "error" not in json.loads(data)


def test_slot_save_restore(server, tmp_path_factory):
    """The cases of tests/test_server.py: save answers 400 until a save
    directory is set and for any name that is not a plain file name; then
    save, erase and restore give back the slot's tokens, and a request
    continues from the restored prompt cache."""
    port, engine = server
    prompt = [9, 10, 11, 12, 13, 14]
    _req(port, "POST", "/v1/completions", {"prompt": prompt, "max_tokens": 2,
                                            "temperature": 0.0})
    idx = next(i for i, s in enumerate(engine.slots) if s.cache_tokens[:6] == prompt)
    _STATE["state"].slot_save_path = None
    status, data = _req(port, "POST", f"/slots/{idx}?action=save", {"filename": "s.npz"})
    assert status == 400 and b"slot-save-path" in data
    base = tmp_path_factory.mktemp("slots")
    _STATE["state"].slot_save_path = str(base)
    try:
        for bad in ("../evil.npz", "/tmp/evil.npz", "a/b.npz", ".."):
            status, data = _req(port, "POST", f"/slots/{idx}?action=save", {"filename": bad})
            assert status == 400, (bad, data)
        status, data = _req(port, "POST", f"/slots/{idx}?action=save", {})
        assert status == 200, data
        saved = json.loads(data)
        assert saved["n_saved"] == 7 and (base / f"slot{idx}.rrsstate").exists()
        status, data = _req(port, "POST", f"/slots/{idx}?action=erase", {})
        assert status == 200 and json.loads(data)["success"]
        assert engine.slots[idx].retained_seq < 0
        status, data = _req(port, "POST", f"/slots/{idx}?action=restore", {})
        assert status == 200, data
        assert json.loads(data)["n_restored"] == saved["n_saved"]
        assert engine.slots[idx].cache_tokens[:6] == prompt
        status, data = _req(port, "POST", f"/slots/{idx}?action=bogus", {})
        assert status == 400
        status, _ = _req(port, "POST", "/slots/9?action=save", {})
        assert status == 400
    finally:
        _STATE["state"].slot_save_path = None


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return tcq4_gguf(tmp_path_factory.mktemp("torch_server"))


def test_cli_serve_subprocess(gguf):
    """``python -m rrs_tpu_torch serve -m <tcq4 gguf> --device cpu --port 0``
    answers /health and a completion, and stops on interrupt."""
    path = gguf
    proc = subprocess.Popen(
        [sys.executable, "-m", "rrs_tpu_torch", "serve", "-m", str(path), "--device", "cpu",
         "--port", "0", "--parallel", "2", "--ctx", "256"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving" in line, (line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        assert json.loads(_req(port, "GET", "/health")[1])["status"] == "ok"
        status, data = _req(port, "POST", "/v1/completions",
                            {"prompt": "the fox", "max_tokens": 4, "temperature": 0.0})
        body = json.loads(data)
        assert status == 200 and body["choices"][0]["finish_reason"] in ("length", "stop")
        assert body["usage"]["completion_tokens"] >= 1
    finally:
        proc.send_signal(2)                             # SIGINT: serve_forever stops
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode is not None


def test_cli_chat_subprocess(gguf):
    """``python -m rrs_tpu_torch chat`` answers two turns read from stdin
    (the second reuses the first's prompt cache) and exits on /exit."""
    r = subprocess.run(
        [sys.executable, "-m", "rrs_tpu_torch", "chat", "-m", str(gguf), "--device", "cpu",
         "--n-predict", "4", "--temp", "0"],
        cwd=ROOT, input="hello\n/system be brief\nhow are you\n/exit\n",
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "chat:" in r.stderr and "(system prompt set)" in r.stderr
    assert r.stdout.count("> ") >= 3


@pytest.mark.parametrize("cache_type", ["q8", "q4"])
def test_cli_generate_quantized_kv(gguf, cache_type, capsys):
    """``generate --cache-type q8|q4 --device cpu`` runs the quantized cache."""
    from rrs_tpu_torch.__main__ import main

    main(["generate", "-m", str(gguf), "-p", "the fox", "-n", "4", "--device", "cpu",
          "--cache-type", cache_type, "--ctx", "64"])
    out = capsys.readouterr()
    assert "perf: prompt" in out.err and "gen 4 tok" in out.err


def test_cli_serve_quantized_kv_slots_subprocess(gguf, tmp_path):
    """``serve --cache-type q4 --slot-save-path DIR --device cpu``: a
    completion, then a slot saved, erased and restored over HTTP, the file
    landing in DIR."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "rrs_tpu_torch", "serve", "-m", str(gguf), "--device", "cpu",
         "--port", "0", "--parallel", "1", "--ctx", "128", "--cache-type", "q4",
         "--slot-save-path", str(tmp_path / "slots")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving" in line and "KV q4" in line, (
            line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        status, data = _req(port, "POST", "/v1/completions",
                            {"prompt": "the fox", "max_tokens": 3, "temperature": 0.0})
        assert status == 200 and json.loads(data)["usage"]["completion_tokens"] == 3
        for action, key in (("save", "n_saved"), ("erase", "success"), ("restore", "n_restored")):
            status, data = _req(port, "POST", f"/slots/0?action={action}", {"filename": "a.bin"})
            assert status == 200 and json.loads(data)[key], (action, data)
        assert (tmp_path / "slots" / "a.bin").exists()
    finally:
        proc.send_signal(2)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def test_cli_chat_quantized_kv_subprocess(gguf):
    r = subprocess.run(
        [sys.executable, "-m", "rrs_tpu_torch", "chat", "-m", str(gguf), "--device", "cpu",
         "--n-predict", "3", "--temp", "0", "--cache-type", "q8"],
        cwd=ROOT, input="hello\n/exit\n", capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("> ") >= 2
