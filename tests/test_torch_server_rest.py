"""The rest of the port's server against the JAX package's: embeddings,
rerank, infill, /v1/messages, the grammar request options, the model router
and the web UI.

- ``ctx.embed`` (mean and last pooling) on the 2-layer W4A4 model of
  tests/test_torch_common.py against JAX's (op by op under
  ``jax.disable_jit()``), within tests/test_torch_model.py's LOGIT_ATOL
  (0.05) relative to the vector's largest entry;
- ``infill_sample`` against JAX's on the same logits in each of its four
  branches (EOG-dominant, prefix merge, threshold, nothing left), with the
  one uniform draw the same in both;
- both servers in-process on the tiny preset's dense weights at scale 0.3
  with a character vocabulary: the JAX engine is not started but driven by
  ``_iterate()`` op by op in the test thread while its request waits. The
  grammar routes, /v1/messages (streamed and not) and /infill give JAX's
  greedy text, each text accepted by a fresh grammar where there is one;
  /rerank's scores are JAX's within 0.05 (a mean log probability; JAX's
  side runs jitted in its handler thread) and /v1/embeddings' vectors
  within LOGIT_ATOL of the vector's scale;
- the router loads a TCQ4 GGUF under a name, routes a completion to it
  (the port's own greedy text for that file) and unloads it; ``GET /``
  serves the port's ``webui.html``.
"""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.models.config import PRESETS as JAX_PRESETS
from rrs_tpu.models.llama import random_weights as jax_random_weights
from rrs_tpu.models.vocab import Vocab as JaxVocab
from rrs_tpu.runtime import sampler as jsampler
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu.serving import server as jserver
from rrs_tpu.serving.engine import Engine as JaxEngine
from rrs_tpu_torch.models.config import PRESETS
from rrs_tpu_torch.models.llama import weights_from_numpy
from rrs_tpu_torch.models.vocab import Vocab
from rrs_tpu_torch.runtime import sampler as tsampler
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.runtime.grammar import Grammar
from rrs_tpu_torch.serving import server as tserver
from rrs_tpu_torch.serving.engine import Engine

from test_torch_common import small_jax_model, tcq4_gguf, tiny_vocab_tokens, torch_cfg, \
    weights_tree

ROOT = Path(__file__).resolve().parent.parent
LOGIT_ATOL = 0.05
FIM = dict(fim_pre_id=2, fim_suf_id=3, fim_mid_id=4)


# -- ctx.embed -----------------------------------------------------------------

@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_embed_matches_jax(pooling):
    jcfg, jw = small_jax_model(seed=0)
    cfg = torch_cfg(jcfg)
    ctx = InferenceContext(cfg, weights_from_numpy(cfg, weights_tree(jw), device="cpu"),
                           max_seq=64, device="cpu")
    toks = [3, 17, 42, 99, 5, 8, 250, 1, 77, 64, 12, 13]
    got = ctx.embed(toks, pooling)
    assert got.dtype == np.float32 and got.shape == (cfg.n_embd,)
    assert ctx.kv.lengths == [0]                       # the context's cache is untouched
    with jax.disable_jit():
        ref = JaxContext(jcfg, jw, n_lanes=1, max_seq=64).embed(toks, pooling)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got / scale, ref / scale, atol=LOGIT_ATOL, rtol=0)


# -- infill_sample ---------------------------------------------------------------

def _infill_case(branch):
    """Logits over 64 tokens with pieces, built to take one branch."""
    v = 64
    pieces = [f"w{i}" for i in range(v)]
    logits = np.full(v, -8.0, np.float32)
    eog = {1, 2}
    if branch == "eog dominant":
        logits[1], logits[2], logits[10] = 2.0, 1.5, 2.5
    elif branch == "prefix merge":
        pieces[10], pieces[11], pieces[12] = "ab", "abc", "abd"
        logits[10], logits[11], logits[12], logits[20] = 1.0, 1.2, 0.9, 1.1
    elif branch == "threshold":
        logits[10], logits[11], logits[12] = 3.0, 2.9, 0.0
    else:                                       # nothing left: all below 0.2
        logits[10:40] = 1.0
        logits[1] = -6.0
    return logits, pieces, eog


@pytest.mark.parametrize("branch", ["eog dominant", "prefix merge", "threshold",
                                    "nothing left"])
@pytest.mark.parametrize("u", [0.1, 0.6, 0.95])
def test_infill_sample_matches_jax(monkeypatch, branch, u):
    logits, pieces, eog = _infill_case(branch)
    # the same uniform draw in both packages (their random streams differ)
    monkeypatch.setattr(jsampler.jax.random, "uniform", lambda key, *a, **k: jnp.float32(u))
    ref = jsampler.infill_sample(logits, pieces, eog, jax.random.PRNGKey(0))
    monkeypatch.setattr(tsampler.torch, "rand", lambda *a, **k: torch.tensor(u))
    got = tsampler.infill_sample(logits, pieces, eog, torch.Generator().manual_seed(0))
    assert got == ref
    if branch == "eog dominant":
        assert got in eog
    if branch == "nothing left":
        assert got == 1


# -- both servers ----------------------------------------------------------------

def _vocabs():
    toks = tiny_vocab_tokens(JAX_PRESETS["tiny"].vocab_size)
    kw = dict(model="gpt2", tokens=toks, scores=None, token_types=[1] * len(toks), merges=[],
              pre="gpt-2", bos_id=0, eos_id=1, add_bos=False, **FIM)
    return Vocab(**kw), JaxVocab(**kw)


@pytest.fixture(scope="module")
def servers():
    jw = jax_random_weights(JAX_PRESETS["tiny"], seed=0, scale=0.3)
    cfg = PRESETS["tiny"]
    tw = weights_from_numpy(cfg, weights_tree(jw), device="cpu")
    tvocab, jvocab = _vocabs()
    tctx = InferenceContext(cfg, tw, n_lanes=2, max_seq=256, device="cpu")
    teng = Engine(tctx)
    teng.start()
    tstate = tserver.ServerState(cfg, tvocab, teng, {}, "tiny-test")
    jctx = JaxContext(JAX_PRESETS["tiny"], jw, n_lanes=2, max_seq=256)
    jeng = JaxEngine(jctx)                       # driven by _iterate() in the test thread
    jstate = jserver.ServerState(JAX_PRESETS["tiny"], jvocab, jeng, {}, "tiny-test")
    out = {}
    for name, st, mod in (("port", tstate, tserver), ("jax", jstate, jserver)):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(st))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        out[name] = (httpd, st)
    yield {k: v[0].server_address[1] for k, v in out.items()}, tstate, jeng
    for httpd, _ in out.values():
        httpd.shutdown()
        httpd.server_close()
    teng.stop()
    for h in tstate.models.values():
        h.unload()


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def _jax_req(port, jeng, method, path, body):
    """A request to the JAX server, its engine stepped op by op here while
    the request waits in its own thread."""
    box = {}
    t = threading.Thread(target=lambda: box.update(r=_req(port, method, path, body)))
    t.start()
    with jax.disable_jit():
        while t.is_alive():
            jeng._iterate()
    t.join()
    return box["r"]


def _text(path, data, stream):
    if path == "/v1/messages":
        if stream:
            events = [json.loads(line[6:]) for line in data.decode().split("\n")
                      if line.startswith("data: ")]
            assert [e["type"] for e in events[:2]] == ["message_start", "content_block_start"]
            assert [e["type"] for e in events[-3:]] == ["content_block_stop", "message_delta",
                                                        "message_stop"]
            return "".join(e["delta"]["text"] for e in events
                           if e["type"] == "content_block_delta")
        return json.loads(data)["content"][0]["text"]
    out = json.loads(data)
    if path == "/infill":
        return out["content"]
    choice = out["choices"][0]
    return choice["message"]["content"] if "message" in choice else choice["text"]


CHAT = [{"role": "user", "content": "hi"}]
SCHEMA = {"type": "object", "properties": {"a": {"type": "integer"}}, "required": ["a"]}
ROUTES = [
    ("grammar", "/completion", {"prompt": "ab", "grammar": "root ::= [a-z]+"},
     "root ::= [a-z]+"),
    ("json_schema", "/v1/completions", {"prompt": "ab", "json_schema": SCHEMA}, SCHEMA),
    ("response_format json_object", "/v1/chat/completions",
     {"messages": CHAT, "response_format": {"type": "json_object"}}, {}),
    ("response_format json_schema", "/v1/chat/completions",
     {"messages": CHAT, "response_format": {"type": "json_schema",
                                            "json_schema": {"schema": SCHEMA}}}, SCHEMA),
    ("lazy grammar", "/completion",
     {"prompt": "ab", "grammar": 'root ::= "X" [a-z]+',
      "grammar_triggers": [{"type": "word", "value": "X"}]}, None),
    ("messages", "/v1/messages", {"messages": CHAT, "system": "be brief"}, None),
    ("messages stream", "/v1/messages", {"messages": CHAT, "stream": True}, None),
    ("infill", "/infill", {"input_prefix": "de", "input_suffix": "gh"}, None),
]


@pytest.mark.parametrize("name,path,body,grammar", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_gives_jax_greedy_text(servers, monkeypatch, name, path, body, grammar):
    from rrs_tpu_torch.runtime.json_schema import json_schema_to_gbnf

    ports, _, jeng = servers
    body = {**body, "temperature": 0.0, "max_tokens": 8}
    if path == "/infill":
        # the infill sampler draws even at temperature 0: the same draw in both
        monkeypatch.setattr(jsampler.jax.random, "uniform",
                            lambda key, *a, **k: jnp.float32(0.5))
        monkeypatch.setattr(tsampler.torch, "rand", lambda *a, **k: torch.tensor(0.5))
    st, data = _req(ports["port"], "POST", path, body)
    assert st == 200, data
    jst, jdata = _jax_req(ports["jax"], jeng, "POST", path, body)
    assert jst == 200, jdata
    got, ref = _text(path, data, body.get("stream")), _text(path, jdata, body.get("stream"))
    assert got == ref
    if grammar is not None:
        gbnf = grammar if isinstance(grammar, str) else json_schema_to_gbnf(grammar)
        assert got and Grammar(gbnf).accepts_text(got), got


def test_bad_grammar_answers_400(servers):
    ports, _, _ = servers
    st, data = _req(ports["port"], "POST", "/completion",
                    {"prompt": "ab", "grammar": 'start ::= "a"', "max_tokens": 2})
    assert st == 400 and "root" in json.loads(data)["error"]


def test_rerank_matches_jax(servers):
    ports, _, jeng = servers
    body = {"query": "abc", "documents": ["abcabc", "xyz", "hello there", ""], "top_n": 4}
    st, data = _req(ports["port"], "POST", "/rerank", body)
    assert st == 200, data
    jst, jdata = _jax_req(ports["jax"], jeng, "POST", "/rerank", body)
    got = {r["index"]: r["relevance_score"] for r in json.loads(data)["results"]}
    ref = {r["index"]: r["relevance_score"] for r in json.loads(jdata)["results"]}
    assert set(got) == set(ref) == {0, 1, 2, 3} and got[3] == ref[3] == -1e30
    for i in range(3):
        assert abs(got[i] - ref[i]) <= 0.05, (i, got[i], ref[i])
    scores = [r["relevance_score"] for r in json.loads(data)["results"]]
    assert scores == sorted(scores, reverse=True)


def test_embeddings_route_matches_jax(servers):
    ports, _, jeng = servers
    body = {"input": ["hello world", "abc"]}
    st, data = _req(ports["port"], "POST", "/v1/embeddings", body)
    assert st == 200, data
    jst, jdata = _jax_req(ports["jax"], jeng, "POST", "/v1/embeddings", body)
    got, ref = json.loads(data)["data"], json.loads(jdata)["data"]
    assert [d["index"] for d in got] == [0, 1] and len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g["embedding"]), np.asarray(r["embedding"])
        scale = np.abs(r).max()
        np.testing.assert_allclose(g / scale, r / scale, atol=LOGIT_ATOL, rtol=0)
    # a list of token ids is one input, as in JAX
    st, data = _req(ports["port"], "POST", "/embeddings", {"input": [[5, 6, 7], "abc"]})
    jst, jdata = _jax_req(ports["jax"], jeng, "POST", "/embeddings",
                          {"input": [[5, 6, 7], "abc"]})
    assert st == jst == 200 and len(json.loads(data)["data"]) == 2
    g = np.asarray(json.loads(data)["data"][0]["embedding"])
    r = np.asarray(json.loads(jdata)["data"][0]["embedding"])
    np.testing.assert_allclose(g / np.abs(r).max(), r / np.abs(r).max(), atol=LOGIT_ATOL,
                               rtol=0)


def test_web_ui(servers):
    ports, _, _ = servers
    for path in ("/", "/index.html"):
        st, data = _req(ports["port"], "GET", path)
        assert st == 200
        assert data == (ROOT / "rrs_tpu_torch" / "serving" / "webui.html").read_bytes()
        assert b"<title>rrs_tpu_torch server</title>" in data


def test_router_loads_routes_and_unloads(servers, tmp_path):
    from rrs_tpu_torch.models.loader import load_model

    ports, tstate, _ = servers
    path = tcq4_gguf(tmp_path)
    tstate.models["second"] = tserver.ModelHandle("second", str(path), n_lanes=1,
                                                  max_seq=128, device="cpu")
    assert _req(ports["port"], "POST", "/models/load", {"model": "nope"})[0] == 400
    st, data = _req(ports["port"], "POST", "/models/load", {"model": "second"})
    assert st == 200 and json.loads(data) == {"success": True, "model": "second"}
    listed = {m["id"]: m["loaded"] for m in json.loads(_req(ports["port"], "GET",
                                                            "/v1/models")[1])["data"]}
    assert listed == {"tiny-test": True, "second": True}
    st, data = _req(ports["port"], "POST", "/v1/completions",
                    {"model": "second", "prompt": "abc", "max_tokens": 6, "temperature": 0})
    assert st == 200, data
    out = json.loads(data)
    assert out["model"] == "second"
    cfg, w, md = load_model(path, device="cpu")
    v = Vocab.from_gguf(md)
    ref = InferenceContext(cfg, w, max_seq=128, device="cpu").generate(
        v.encode("abc", add_special=True), 6, stop_tokens=(v.eos_id,))
    assert out["choices"][0]["text"] == v.decode(ref)
    st, _ = _req(ports["port"], "POST", "/models/unload", {"model": "second"})
    assert st == 200 and not tstate.models["second"].loaded
    listed = {m["id"]: m["loaded"] for m in json.loads(_req(ports["port"], "GET",
                                                            "/v1/models")[1])["data"]}
    assert listed == {"tiny-test": True, "second": False}
    del tstate.models["second"]
