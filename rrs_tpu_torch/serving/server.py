"""OpenAI-compatible HTTP server (tools/server analog, stdlib http.server).

Port of ``rrs_tpu/serving/server.py`` (``ModelHandle``, ``ServerState``,
``_sampler_params``, ``make_handler``, ``serve``) over the port's engine.
Routes:
  GET  /, /index.html (the web UI, the port's own ``webui.html``)
  GET  /health, /props, /slots, /metrics (Prometheus text), /v1/models
  POST /tokenize, /detokenize, /apply-template
  POST /completion, /v1/completions, /v1/chat/completions (SSE streaming or
       not, with logprobs / n_probs; ``grammar``, ``json_schema``,
       ``response_format`` json_schema / json_object, and lazy grammars with
       ``grammar_triggers`` / ``grammar_lazy``; a bad grammar answers 400)
  POST /v1/messages (Anthropic messages, streamed as its SSE events or not)
  POST /infill (fill-in-the-middle; 400 without the vocab's FIM tokens)
  POST /rerank, /v1/rerank, /reranking (mean log p(document | query))
  POST /v1/embeddings, /embeddings, /embedding (mean-pooled final hidden)
  POST /models/load, /models/unload (the router: a request whose "model"
       names a registered model runs on that model's engine)
  POST /slots/{id}?action=save|restore|erase (slot state files, confined to
       ``--slot-save-path``: a plain file name, else 400)
A non-streamed completion reports ``usage`` with the exact count of
generated tokens and the reference server's ``timings`` (prompt_ms: submit
to first token; predicted_ms: first token to finish).

With a vision tower (``serve --mmproj``), the chat route lifts each
``image_url`` part out of the messages, in order, leaving a marker in the
rendered text; each image is decoded (PNG without Pillow; a format that
cannot be decoded answers 400), encoded by the tower and fed as an embedding
chunk between the text's token runs (the engine's ``segments``). With an
audio tower (the same flag: a file may hold both), each ``input_audio`` part
is lifted the same way: the WAV is decoded (one that cannot be decoded
answers 400) and its 30 s chunks, encoded and concatenated, make one
embedding chunk. Without the tower a part needs, it reaches the chat
template as it is, as in the JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import queue
import re
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from rrs_tpu_torch.runtime.sampler import SamplerParams
from rrs_tpu_torch.serving.chat import (build_prompt, detect_template, detect_tool_format,
                                        extract_reasoning, parse_tool_calls)
from rrs_tpu_torch.serving.engine import Engine, GenRequest

WEBUI = Path(__file__).resolve().parent / "webui.html"


class ModelHandle:
    """One model of the router: loaded on its first request (or
    ``/models/load``) onto ``device``, unloaded to free the card's memory."""

    def __init__(self, name: str, path: str, n_lanes: int = 2, max_seq: int = 2048,
                 kv_quant: str = "none", device=None):
        self.name = name
        self.path = path
        self.n_lanes = n_lanes
        self.max_seq = max_seq
        self.kv_quant = kv_quant
        self.device = device
        self.state: "ServerState | None" = None

    @property
    def loaded(self) -> bool:
        return self.state is not None

    def load(self) -> "ServerState":
        if self.state is None:
            from rrs_tpu_torch.models.loader import load_model
            from rrs_tpu_torch.models.vocab import Vocab
            from rrs_tpu_torch.runtime.recurrent import make_context

            cfg, weights, md = load_model(self.path, device=self.device)
            ctx = make_context(cfg, weights, n_lanes=self.n_lanes, max_seq=self.max_seq,
                               kv_quant=self.kv_quant, device=self.device)
            engine = Engine(ctx)
            engine.start()
            self.state = ServerState(cfg, Vocab.from_gguf(md), engine, md, self.name)
        return self.state

    def unload(self) -> None:
        """Stop the model's engine and drop every reference to its weights
        and caches (the engine thread holds reference cycles)."""
        if self.state is not None:
            self.state.engine.stop()
            self.state = None
            gc.collect()


class ServerState:
    def __init__(self, cfg, vocab, engine: Engine, md: dict, model_name: str):
        self.cfg = cfg
        self.vocab = vocab
        self.engine = engine
        self.md = md
        self.model_name = model_name
        self.template = detect_template(md)
        # the model's own Jinja template (primary path) and tool-call dialect
        self.chat_template = str(md.get("tokenizer.chat_template", "") or "")
        self.tool_format = detect_tool_format(self.chat_template)
        bos = vocab.tokens[vocab.bos_id] if 0 <= vocab.bos_id < len(vocab.tokens) else ""
        eos = vocab.tokens[vocab.eos_id] if 0 <= vocab.eos_id < len(vocab.tokens) else ""
        self.special_tokens = {"bos_token": bos, "eos_token": eos}
        self.t_start = time.time()
        # base directory of slot state files; the save / restore actions are
        # refused while it is unset (``--slot-save-path``)
        self.slot_save_path = None
        # the router: name -> ModelHandle; a request whose "model" names one
        # runs on that model's engine
        self.models: dict[str, ModelHandle] = {}
        # the towers of ``--mmproj``: vision (ClipConfig, ClipWeights) and
        # audio (AudioConfig, AudioWeights)
        self.clip_cfg = None
        self.clip_weights = None
        self.audio_cfg = None
        self.audio_weights = None

    def render_chat(self, messages, tools=None, add_assistant=True):
        """(prompt text, extra stop strings) via the model's Jinja template,
        falling back to the heuristic family."""
        return build_prompt(self.chat_template, self.template, messages, tools=tools,
                            add_assistant=add_assistant, special=self.special_tokens)


def _sampler_params(body: dict) -> SamplerParams:
    return SamplerParams(
        temperature=float(body.get("temperature", 1.0 if "temperature" in body else 0.8)),
        top_k=int(body.get("top_k", 40)),
        top_p=float(body.get("top_p", 0.95)),
        min_p=float(body.get("min_p", 0.05)),
        penalty_repeat=float(body.get("repeat_penalty", 1.0)),
        penalty_freq=float(body.get("frequency_penalty", 0.0)),
        penalty_present=float(body.get("presence_penalty", 0.0)),
        seed=int(body.get("seed", 42)),
        xtc_probability=float(body.get("xtc_probability", 0.0)),
        xtc_threshold=float(body.get("xtc_threshold", 0.1)),
        top_n_sigma=float(body.get("top_n_sigma", 0.0)),
        mirostat=int(body.get("mirostat", 0)),
        mirostat_tau=float(body.get("mirostat_tau", 5.0)),
        mirostat_eta=float(body.get("mirostat_eta", 0.1)),
        dry_multiplier=float(body.get("dry_multiplier", 0.0)),
        dry_base=float(body.get("dry_base", 1.75)),
        dry_allowed_length=int(body.get("dry_allowed_length", 2)),
        logit_bias=tuple(
            (int(k), float(v)) for k, v in (body.get("logit_bias") or {}).items()
        ) if isinstance(body.get("logit_bias"), dict) else (),
    )


def _grammar_from_body(body: dict):
    """The request's grammar, or None: ``grammar`` (GBNF text), else
    ``json_schema``, else ``response_format`` (``json_schema`` with its
    schema, or ``json_object``: any JSON), converted to GBNF. Trigger words,
    patterns or tokens in ``grammar_triggers`` (or ``grammar_lazy``) make
    it lazy: unconstrained until a trigger fires. A bad grammar raises."""
    from rrs_tpu_torch.runtime.grammar import Grammar
    from rrs_tpu_torch.runtime.json_schema import json_schema_to_gbnf

    gbnf = body.get("grammar")
    rf = body.get("response_format") or {}
    if not gbnf and body.get("json_schema"):
        gbnf = json_schema_to_gbnf(body["json_schema"])
    if not gbnf and rf.get("type") == "json_schema":
        gbnf = json_schema_to_gbnf(rf.get("json_schema", {}).get("schema", {}))
    if not gbnf and rf.get("type") == "json_object":
        gbnf = json_schema_to_gbnf({})
    if not gbnf:
        return None
    words, patterns, ttoks = [], [], []
    for trig in body.get("grammar_triggers") or []:
        if isinstance(trig, str):
            words.append(trig)
        elif isinstance(trig, dict):
            ty = trig.get("type", "word")
            val = trig.get("value", trig.get("word", ""))
            if ty in ("pattern", "pattern_full", 2, 3):
                patterns.append(str(val))
            elif ty in ("token", 0):
                ttoks.append(int(val))
            else:
                words.append(str(val))
    return Grammar(gbnf, lazy=bool(body.get("grammar_lazy")) or bool(words or patterns or ttoks),
                   trigger_words=words, trigger_patterns=patterns, trigger_tokens=ttoks)


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        st = state

        def log_message(self, fmt, *args):
            pass

        # -- helpers -----------------------------------------------------

        def _json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _run_request(self, prompt_tokens, body, stop_strings=(), probs_out=None,
                         infill=False, segments=None):
            """Submit and collect: returns an iterator of (piece, finished,
            reason) with the submitted GenRequest as ``.req`` (aborted on
            disconnect). Set-up (grammar parse, schema conversion, submit)
            runs eagerly, so an invalid request raises here and the route
            answers 400 instead of dropping the connection."""
            grammar = _grammar_from_body(body)
            q: "queue.Queue" = queue.Queue()
            stats = {"n": 0, "t0": time.perf_counter(), "t_first": None, "t_end": None}

            def on_token(token, piece, finished, reason):
                now = time.perf_counter()
                if token is not None:
                    stats["n"] += 1
                    if stats["t_first"] is None:
                        stats["t_first"] = now
                if finished:
                    stats["t_end"] = now
                q.put((piece, finished, reason))

            n_probs = int(body.get("n_probs") or 0)
            if body.get("logprobs") not in (None, False):
                lp = body["logprobs"]
                n_probs = max(n_probs, lp if isinstance(lp, int) else 0, 1)
            n_probs = max(n_probs, int(body.get("top_logprobs") or 0))
            on_probs = None
            if n_probs and probs_out is not None:
                def on_probs(token, logprob, top):
                    probs_out.append((token, logprob, top))

            stops = body.get("stop") or []
            if isinstance(stops, str):
                stops = [stops]
            req = GenRequest(
                prompt_tokens=prompt_tokens,
                max_tokens=int(body.get("max_tokens") or body.get("n_predict") or 128),
                params=_sampler_params(body),
                stop_tokens=tuple(t for t in (self.st.vocab.eos_id,) if t is not None and t >= 0),
                stop_strings=tuple(stops) + tuple(stop_strings),
                on_token=on_token,
                decode_fn=lambda ids: self.st.vocab.decode(ids),
                grammar=grammar,
                token_pieces=self.st.vocab.pieces() if grammar or infill else None,
                token_trie=self.st.vocab.token_trie() if grammar is not None else None,
                n_probs=n_probs,
                on_probs=on_probs,
                infill=infill,
                segments=segments,
            )
            self.st.engine.submit(req)

            def _collect():
                while True:
                    piece, finished, reason = q.get()
                    yield piece, finished, reason
                    if finished:
                        break

            class _Collected:
                def __init__(self, it, rq):
                    self._it = it
                    self.req = rq
                    self.stats = stats

                def __iter__(self):
                    return self._it

            return _Collected(_collect(), req)

        def _start(self, toks, body, **kw):
            """_run_request with its errors (a bad grammar, say) answered
            400; None when the response was already sent."""
            try:
                return self._run_request(toks, body, **kw)
            except Exception as e:                            # noqa: BLE001
                self._json({"error": str(e)}, 400)
            return None

        def _stream_sse(self, gen, wrap):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send_chunk(obj):
                data = b"data: " + json.dumps(obj).encode() + b"\n\n"
                self.wfile.write(hex(len(data))[2:].encode() + b"\r\n" + data + b"\r\n")

            try:
                for piece, finished, reason in gen:
                    if piece or finished:
                        send_chunk(wrap(piece, finished, reason))
            except (BrokenPipeError, ConnectionResetError):
                # the client went away: stop the slot instead of generating
                # to max_tokens into a queue nobody drains
                gen.req.abort = True
                return
            data = b"data: [DONE]\n\n"
            self.wfile.write(hex(len(data))[2:].encode() + b"\r\n" + data + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")

        @staticmethod
        def _gather(gen):
            parts, reason = [], "stop"
            for piece, finished, r in gen:
                parts.append(piece)
                if finished:
                    reason = r or "stop"
            return "".join(parts), reason

        @staticmethod
        def _usage(gen, n_prompt: int) -> dict:
            st = gen.stats
            first = st["t_first"] if st["t_first"] is not None else st["t_end"]
            return {"usage": {"prompt_tokens": n_prompt, "completion_tokens": st["n"],
                              "total_tokens": n_prompt + st["n"]},
                    "timings": {"prompt_n": n_prompt, "predicted_n": st["n"],
                                "prompt_ms": (first - st["t0"]) * 1e3,
                                "predicted_ms": (st["t_end"] - first) * 1e3}}

        def _slot_action(self, body):
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            m = re.match(r"^/slots/(\d+)$", u.path)
            if not m:
                self._json({"error": "not found"}, 404)
                return
            idx = int(m.group(1))
            if idx >= len(self.st.engine.slots):
                self._json({"error": "no such slot"}, 400)
                return
            action = (parse_qs(u.query).get("action") or [""])[0]

            def confined(fname: str) -> str:
                # the file is written on behalf of an HTTP client: only a plain
                # name inside the operator's directory
                base = self.st.slot_save_path
                if not base:
                    raise ValueError("slot save/restore disabled (start the server with "
                                     "--slot-save-path)")
                if not fname or os.path.basename(fname) != fname or fname in (".", ".."):
                    raise ValueError(f"invalid filename {fname!r}")
                return os.path.join(base, fname)

            eng = self.st.engine
            try:
                if action in ("save", "restore"):
                    path = confined(body.get("filename", f"slot{idx}.rrsstate"))
                    fn = eng.save_slot if action == "save" else eng.restore_slot
                    self._json(fn(idx, path))
                elif action == "erase":
                    eng.call(lambda: eng.erase_slot(idx))
                    self._json({"id_slot": idx, "success": True})
                else:
                    self._json({"error": f"unknown action '{action}'"}, 400)
            except Exception as e:                            # noqa: BLE001
                self._json({"error": str(e)}, 400)

        # -- routes --------------------------------------------------------

        def do_GET(self):
            e = self.st.engine
            if self.path in ("/", "/index.html"):
                page = WEBUI.read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)
            elif self.path == "/health":
                self._json({"status": "ok"})
            elif self.path in ("/v1/models", "/models"):
                data = [{"id": self.st.model_name, "object": "model",
                         "created": int(self.st.t_start), "owned_by": "rrs_tpu_torch",
                         "loaded": True}]
                data += [{"id": name, "object": "model", "created": int(self.st.t_start),
                          "owned_by": "rrs_tpu_torch", "loaded": h.loaded}
                         for name, h in self.st.models.items()]
                self._json({"object": "list", "data": data})
            elif self.path == "/props":
                self._json({"model": self.st.model_name, "chat_template": self.st.template,
                            "total_slots": len(e.slots), "n_ctx": e.ctx.kv.max_seq})
            elif self.path == "/slots":
                self._json([{"id": s.index, "state": s.state.name, "n_prompt": s.n_prompt,
                             "n_generated": len(s.generated) if s.req else 0}
                            for s in e.slots])
            elif self.path == "/metrics":
                p = e.ctx.perf()
                lines = [
                    "# TYPE llamacpp:prompt_tokens_total counter",
                    f"llamacpp:prompt_tokens_total {e.n_prompt_tokens}",
                    "# TYPE llamacpp:tokens_predicted_total counter",
                    f"llamacpp:tokens_predicted_total {e.n_generated_tokens}",
                    "# TYPE llamacpp:requests_total counter",
                    f"llamacpp:requests_total {e.n_requests}",
                    "# TYPE llamacpp:decode_runs_total counter",
                    f"llamacpp:decode_runs_total {e.n_decode_runs}",
                    "# TYPE llamacpp:prompt_tokens_seconds_total counter",
                    f"llamacpp:prompt_tokens_seconds_total {p['t_p_eval_ms'] / 1e3:.3f}",
                    "# TYPE llamacpp:predicted_tokens_seconds_total counter",
                    f"llamacpp:predicted_tokens_seconds_total {p['t_eval_ms'] / 1e3:.3f}",
                    "# TYPE llamacpp:prompt_tokens_per_second gauge",
                    f"llamacpp:prompt_tokens_per_second {p['pp_tok_per_s']:.2f}",
                    "# TYPE llamacpp:predicted_tokens_per_second gauge",
                    f"llamacpp:predicted_tokens_per_second {p['tg_tok_per_s']:.2f}",
                ]
                data = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            try:
                body = self._read_body()
            except Exception as e:                            # noqa: BLE001
                self._json({"error": str(e)}, 400)
                return
            path = self.path
            if path in ("/models/load", "/models/unload"):
                self._model_action(path, body)
                return
            try:
                self._route(body)
            except Exception as e:                            # noqa: BLE001
                self._json({"error": f"model {body.get('model')!r}: {e}"}, 400)
                return
            if path.startswith("/slots/"):
                self._slot_action(body)
            elif path == "/tokenize":
                self._json({"tokens": self.st.vocab.encode(
                    body.get("content", ""), add_special=bool(body.get("add_special", False)))})
            elif path == "/detokenize":
                self._json({"content": self.st.vocab.decode(body.get("tokens", []))})
            elif path == "/apply-template":
                text, _ = self.st.render_chat(body.get("messages", []),
                                              tools=body.get("tools") or None)
                self._json({"prompt": text})
            elif path == "/v1/chat/completions":
                self._chat(body)
            elif path in ("/v1/completions", "/completion", "/completions"):
                self._completion(body)
            elif path == "/v1/messages":
                self._anthropic(body)
            elif path == "/infill":
                self._infill(body)
            elif path in ("/rerank", "/v1/rerank", "/reranking"):
                self._rerank(body)
            elif path in ("/v1/embeddings", "/embeddings", "/embedding"):
                self._embeddings(body)
            else:
                self._json({"error": "not found"}, 404)

        # -- the router ------------------------------------------------------

        def _route(self, body) -> None:
            """A request naming a registered model other than the default
            runs on that model's engine (loaded on first use)."""
            name = body.get("model")
            if name and name != state.model_name and name in state.models:
                self.st = state.models[name].load()

        def _model_action(self, path, body) -> None:
            h = state.models.get(body.get("model", ""))
            if h is None:
                self._json({"error": "unknown model"}, 400)
                return
            try:
                h.load() if path == "/models/load" else h.unload()
            except Exception as e:                            # noqa: BLE001
                self._json({"error": str(e)}, 400)
                return
            self._json({"success": True, "model": h.name})

        # -- the other routes ------------------------------------------------

        def _anthropic(self, body):
            """Anthropic /v1/messages: a message object, or its SSE events
            (message_start, content_block_start / _delta / _stop,
            message_delta, message_stop) when streamed."""
            messages = list(body.get("messages", []))
            if body.get("system"):
                messages = [{"role": "system", "content": body["system"]}] + messages
            text, stops = self.st.render_chat(messages)
            toks = self.st.vocab.encode(text, add_special=False)
            rid = f"msg_{uuid.uuid4().hex[:16]}"
            body = dict(body)
            body.setdefault("max_tokens", 256)
            gen = self._start(toks, body, stop_strings=stops)
            if gen is None:
                return
            if not body.get("stream"):
                content, reason = self._gather(gen)
                self._json({"id": rid, "type": "message", "role": "assistant",
                            "model": self.st.model_name,
                            "content": [{"type": "text", "text": content}],
                            "stop_reason": "max_tokens" if reason == "length" else "end_turn",
                            "usage": {"input_tokens": len(toks),
                                      "output_tokens": gen.stats["n"]}})
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def ev(name, obj):
                data = f"event: {name}\ndata: {json.dumps(obj)}\n\n".encode()
                self.wfile.write(hex(len(data))[2:].encode() + b"\r\n" + data + b"\r\n")

            try:
                ev("message_start", {"type": "message_start", "message": {
                    "id": rid, "type": "message", "role": "assistant", "content": [],
                    "model": self.st.model_name,
                    "usage": {"input_tokens": len(toks), "output_tokens": 0}}})
                ev("content_block_start", {"type": "content_block_start", "index": 0,
                                           "content_block": {"type": "text", "text": ""}})
                stop_reason = "end_turn"
                for piece, finished, reason in gen:
                    if piece:
                        ev("content_block_delta", {"type": "content_block_delta", "index": 0,
                                                   "delta": {"type": "text_delta",
                                                             "text": piece}})
                    if finished:
                        stop_reason = "max_tokens" if reason == "length" else "end_turn"
                ev("content_block_stop", {"type": "content_block_stop", "index": 0})
                ev("message_delta", {"type": "message_delta",
                                     "delta": {"stop_reason": stop_reason},
                                     "usage": {"output_tokens": gen.stats["n"]}})
                ev("message_stop", {"type": "message_stop"})
            except (BrokenPipeError, ConnectionResetError):
                gen.req.abort = True
                return
            self.wfile.write(b"0\r\n\r\n")

        def _infill(self, body):
            """Fill-in-the-middle: fim_pre + prefix + fim_suf + suffix +
            fim_mid [+ prompt], sampled by the infill sampler."""
            v = self.st.vocab
            if v.fim_pre_id < 0 or v.fim_suf_id < 0 or v.fim_mid_id < 0:
                self._json({"error": "model has no FIM tokens"}, 400)
                return
            extra = str(body.get("prompt", "") or "")
            toks = ([v.fim_pre_id] + v.encode(str(body.get("input_prefix", "")),
                                              add_special=False)
                    + [v.fim_suf_id] + v.encode(str(body.get("input_suffix", "")),
                                                add_special=False)
                    + [v.fim_mid_id] + (v.encode(extra, add_special=False) if extra else []))
            gen = self._start(toks, body, infill=True)
            if gen is None:
                return
            content, reason = self._gather(gen)
            self._json({"content": content, "stop_type": reason, "tokens_evaluated": len(toks),
                        "tokens_predicted": gen.stats["n"]})

        def _rerank(self, body):
            """Causal-LM reranking: a document's score is the mean log
            probability of its tokens after "Query: {query}\nDocument: ",
            from ``prefill_logprobs`` on the engine thread."""
            query = str(body.get("query", ""))
            docs = body.get("documents") or []
            top_n = int(body.get("top_n") or len(docs))
            eng = self.st.engine
            results = []
            for i, doc in enumerate(docs):
                q_toks = self.st.vocab.encode(f"Query: {query}\nDocument: ", add_special=True)
                d_toks = self.st.vocab.encode(str(doc), add_special=False)
                if not d_toks:
                    results.append({"index": i, "relevance_score": -1e30})
                    continue
                toks = (q_toks + d_toks)[: eng.ctx.kv.max_seq - 1]
                nd = len(toks) - len(q_toks)

                def score(toks=toks, nd=nd):
                    ctx = eng.ctx
                    seq = ctx.new_sequence()
                    try:
                        lp = ctx.prefill_logprobs(seq, toks, list(toks[1:]) + [0])
                    finally:
                        ctx.kv.seq_rm(seq)
                    return float(lp[len(toks) - nd - 1: len(toks) - 1].sum()) / max(nd, 1)

                try:
                    results.append({"index": i, "relevance_score": eng.call(score)})
                except Exception as e:                        # noqa: BLE001
                    self._json({"error": str(e)}, 400)
                    return
            results.sort(key=lambda r: -r["relevance_score"])
            self._json({"model": self.st.model_name, "object": "list",
                        "results": results[:top_n], "usage": {"total_tokens": 0}})

        def _embeddings(self, body):
            """One mean-pooled embedding per input (a text, or a list of
            token ids), each a standalone forward on the engine thread."""
            inputs = body.get("input") or body.get("content") or ""
            if isinstance(inputs, str):
                inputs = [inputs]
            eng = self.st.engine
            data = []
            try:
                for i, text in enumerate(inputs):
                    toks = (list(text) if isinstance(text, list)
                            else self.st.vocab.encode(str(text), add_special=True))
                    vec = eng.call(lambda toks=toks: eng.ctx.embed(toks))
                    data.append({"object": "embedding", "index": i,
                                 "embedding": np.asarray(vec, np.float64).tolist()})
            except Exception as e:                            # noqa: BLE001
                self._json({"error": str(e)}, 400)
                return
            self._json({"object": "list", "data": data, "model": self.st.model_name})

        def _chat(self, body):
            tools = body.get("tools") or None
            messages, media = _lift_media(body.get("messages", []),
                                          images=self.st.clip_weights is not None,
                                          audio=self.st.audio_weights is not None)
            text, chat_stops = self.st.render_chat(messages, tools=tools)
            toks = self.st.vocab.encode(text, add_special=False)
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            probs = []
            segments = None
            if media:
                try:
                    segments = self._media_segments(text, media)
                except Exception as e:                        # noqa: BLE001
                    self._json({"error": str(e)}, 400)
                    return
            gen = self._start(toks, body, stop_strings=chat_stops, probs_out=probs,
                              segments=segments)
            if gen is None:
                return
            if body.get("stream"):
                def wrap(piece, finished, reason):
                    return {"id": rid, "object": "chat.completion.chunk",
                            "model": self.st.model_name,
                            "choices": [{"index": 0,
                                         "delta": {} if finished else {"content": piece},
                                         "finish_reason": reason if finished else None}]}
                self._stream_sse(gen, wrap)
                return
            content, reason = self._gather(gen)
            reasoning, content = extract_reasoning(content)
            tool_calls = []
            if tools:
                content, tool_calls = parse_tool_calls(content, fmt=self.st.tool_format)
            msg = {"role": "assistant", "content": content}
            if reasoning is not None:
                msg["reasoning_content"] = reasoning
            if tool_calls:
                msg["tool_calls"] = tool_calls
                reason = "tool_calls"
            choice = {"index": 0, "finish_reason": reason, "message": msg}
            if probs:
                dec = self.st.vocab.decode
                choice["logprobs"] = {"content": [
                    {"token": dec([t]), "logprob": lp,
                     "top_logprobs": [{"token": dec([tt]), "logprob": tlp} for tt, tlp in top]}
                    for t, lp, top in probs]}
            self._json({"id": rid, "object": "chat.completion", "model": self.st.model_name,
                        "created": int(time.time()), "choices": [choice],
                        **self._usage(gen, len(toks))})

        def _media_segments(self, text: str, media: list) -> list:
            """The rendered text split at the media markers into token runs,
            each image or audio clip decoded and encoded into its embedding
            chunk between them (a Qwen2-VL chunk with its merged grid; an
            audio clip's 30 s chunks concatenated)."""
            import torch

            from rrs_tpu_torch.mtmd.audio import embed_audio
            from rrs_tpu_torch.mtmd.pipeline import (IMAGE_MARKER, decode_audio_b64,
                                                     decode_image_b64, embed_images)

            chunks = []
            for kind, payload in media:
                if kind == "image":
                    chunks.extend(embed_images(self.st.clip_cfg, self.st.clip_weights,
                                               [decode_image_b64(payload)]))
                else:
                    chunks.append(torch.cat(embed_audio(
                        self.st.audio_cfg, self.st.audio_weights, decode_audio_b64(payload))))
            segments = []
            for i, piece in enumerate(text.split(IMAGE_MARKER)):
                if piece:
                    segments.append(("tokens", self.st.vocab.encode(piece, add_special=False)))
                if i < len(chunks):
                    segments.append(("embeds_mrope" if isinstance(chunks[i], tuple)
                                     else "embeds", chunks[i]))
            return segments

        def _completion(self, body):
            prompt = body.get("prompt", "")
            toks = (prompt if isinstance(prompt, list)
                    else self.st.vocab.encode(str(prompt), add_special=True))
            rid = f"cmpl-{uuid.uuid4().hex[:12]}"
            probs = []
            gen = self._start(toks, body, probs_out=probs)
            if gen is None:
                return
            if body.get("stream"):
                def wrap(piece, finished, reason):
                    return {"id": rid, "object": "text_completion", "model": self.st.model_name,
                            "choices": [{"index": 0, "text": piece,
                                         "finish_reason": reason if finished else None}]}
                self._stream_sse(gen, wrap)
                return
            text, reason = self._gather(gen)
            choice = {"index": 0, "text": text, "finish_reason": reason}
            if probs:
                dec = self.st.vocab.decode
                choice["logprobs"] = {
                    "tokens": [dec([t]) for t, _, _ in probs],
                    "token_logprobs": [lp for _, lp, _ in probs],
                    "top_logprobs": [{dec([tt]): tlp for tt, tlp in top} for _, _, top in probs],
                }
            self._json({"id": rid, "object": "text_completion", "model": self.st.model_name,
                        "created": int(time.time()), "choices": [choice],
                        **self._usage(gen, len(toks))})

    return Handler


def _lift_media(messages, images: bool, audio: bool):
    """Each ``image_url`` part (when ``images``) and ``input_audio`` part
    (when ``audio``) of the messages, in order, replaced by a text part
    holding the media marker: (new messages, [("image", url) | ("audio",
    base64 WAV)])."""
    from rrs_tpu_torch.mtmd.pipeline import IMAGE_MARKER

    media, out = [], []
    for m in messages:
        c = m.get("content")
        if (images or audio) and isinstance(c, list):
            parts = []
            for part in c:
                kind = part.get("type") if isinstance(part, dict) else None
                if kind == "image_url" and images:
                    url = part["image_url"]
                    media.append(("image", url.get("url") if isinstance(url, dict) else url))
                elif kind == "input_audio" and audio:
                    media.append(("audio", part.get("input_audio", {}).get("data", "")))
                else:
                    parts.append(part)
                    continue
                parts.append({"type": "text", "text": IMAGE_MARKER})
            m = {**m, "content": parts}
        out.append(m)
    return out, media


def load_towers(path: str, device=None):
    """``--mmproj``: the towers an mmproj GGUF holds, each on ``device``:
    (vision (ClipConfig, ClipWeights) or None, audio (AudioConfig,
    AudioWeights) or None). A file with neither is refused."""
    from rrs_tpu_torch.gguf.reader import read_gguf
    from rrs_tpu_torch.mtmd.audio import load_audio_mmproj
    from rrs_tpu_torch.mtmd.clip import load_mmproj

    with read_gguf(path) as g:
        names = set(g.tensors)
    has_vision = "v.blk.0.ln1.weight" in names or "v.patch_embd.weight" in names
    has_audio = "a.conv1d.1.weight" in names
    if not (has_vision or has_audio):
        raise ValueError(f"{path}: no vision (v.*) or audio (a.*) tower in this mmproj file")
    return (load_mmproj(path, device=device) if has_vision else None,
            load_audio_mmproj(path, device=device) if has_audio else None)


def serve(args):
    """``python -m rrs_tpu_torch serve``: load the GGUF on ``args.device``
    (over a tensor / data parallel mesh with ``--tp`` / ``--dp``), start the
    engine and serve HTTP until interrupted."""
    from rrs_tpu_torch.models.loader import load_model, parse_kv_overrides
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.parallel.distributed import lanes_for, maybe_initialize, mesh_from_args
    from rrs_tpu_torch.runtime.recurrent import make_context

    maybe_initialize(args)
    mesh = mesh_from_args(args)
    cfg, weights, md = load_model(args.model, device=args.device, fuse=mesh is None,
                                  overrides=parse_kv_overrides(args.override_kv))
    vocab = Vocab.from_gguf(md)
    ctx = make_context(cfg, weights, n_lanes=lanes_for(args.parallel, mesh), max_seq=args.ctx,
                       kv_quant=args.cache_type, device=args.device, mesh=mesh)
    del weights
    if mesh is not None:
        print(f"tensor/data parallel over mesh {mesh.shape}", flush=True)
    draft_ctx = None
    if args.model_draft:
        dcfg, dweights, _ = load_model(args.model_draft, device=args.device)
        draft_ctx = make_context(dcfg, dweights, n_lanes=args.parallel, max_seq=args.ctx,
                                 device=args.device)
        print(f"speculative decoding with draft {args.model_draft}", flush=True)
    clip, audio = load_towers(args.mmproj, device=args.device) if args.mmproj else (None, None)
    engine = Engine(ctx, draft_ctx=draft_ctx, n_draft=args.draft)
    engine.start()
    state = ServerState(cfg, vocab, engine, md, model_name=str(args.model))
    if clip is not None:
        state.clip_cfg, state.clip_weights = clip
        print(f"loaded vision projector {args.mmproj} ({clip[0].projector_type})", flush=True)
    if audio is not None:
        state.audio_cfg, state.audio_weights = audio
        print(f"loaded audio tower {args.mmproj} ({audio[0].projector} projector, "
              f"{audio[0].n_mel} mel bins)", flush=True)
    if args.slot_save_path:
        os.makedirs(args.slot_save_path, exist_ok=True)
        state.slot_save_path = args.slot_save_path
    for extra in args.models or []:
        name, _, path = extra.partition("=")
        state.models[name] = ModelHandle(name, path or name, n_lanes=args.parallel,
                                         max_seq=args.ctx, kv_quant=args.cache_type,
                                         device=args.device)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(state))
    print(f"serving {args.model} on http://{args.host}:{httpd.server_address[1]} "
          f"({args.parallel} slots, ctx {args.ctx}, KV {args.cache_type}, {ctx.device})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.stop()
        for h in state.models.values():
            h.unload()
