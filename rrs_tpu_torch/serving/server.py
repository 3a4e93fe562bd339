"""OpenAI-compatible HTTP server (tools/server analog, stdlib http.server).

Port of ``rrs_tpu/serving/server.py`` (``ServerState``, ``_sampler_params``,
``make_handler``, ``serve``) over the port's engine. Routes:
  GET  /health, /props, /slots, /metrics (Prometheus text), /v1/models
  POST /tokenize, /detokenize, /apply-template
  POST /completion, /v1/completions, /v1/chat/completions (SSE streaming or
       not, with logprobs / n_probs)
  POST /slots/{id}?action=save|restore|erase (slot state files, confined to
       ``--slot-save-path``: a plain file name, else 400)
A non-streamed completion reports ``usage`` with the exact count of
generated tokens and the reference server's ``timings`` (prompt_ms: submit
to first token; predicted_ms: first token to finish).

The JAX package's other routes answer 501 with a JSON error naming the
ROADMAP item that brings them; so do image or audio content parts. Grammar,
JSON-schema and response-format requests answer 400 with the same kind of
error, naming the grammar slice.
"""

from __future__ import annotations

import json
import os
import queue
import re
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from rrs_tpu_torch.runtime.sampler import SamplerParams
from rrs_tpu_torch.serving.chat import (build_prompt, detect_template, detect_tool_format,
                                        extract_reasoning, parse_tool_calls)
from rrs_tpu_torch.serving.engine import Engine, GenRequest

# Routes of the JAX server that wait for a later slice of the port.
WAITING_ROUTES = {
    "/": "the web UI waits for ROADMAP A13",
    "/index.html": "the web UI waits for ROADMAP A13",
    "/v1/embeddings": "embeddings wait for ROADMAP A13",
    "/embeddings": "embeddings wait for ROADMAP A13",
    "/embedding": "embeddings wait for ROADMAP A13",
    "/rerank": "reranking waits for ROADMAP A13",
    "/v1/rerank": "reranking waits for ROADMAP A13",
    "/reranking": "reranking waits for ROADMAP A13",
    "/infill": "infill waits for ROADMAP A13",
    "/v1/messages": "the Anthropic messages route waits for ROADMAP A13",
    "/models/load": "the multi-model router waits for ROADMAP A13",
    "/models/unload": "the multi-model router waits for ROADMAP A13",
}
GRAMMAR = "grammar, json_schema and response_format wait for ROADMAP A6 (grammar slice)"
MEDIA = "image and audio content parts wait for ROADMAP A11 (multimodal slice)"


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


def _has_media(messages) -> bool:
    return any(isinstance(m.get("content"), list)
               and any(isinstance(p, dict) and p.get("type") in ("image_url", "input_audio")
                       for p in m["content"])
               for m in messages if isinstance(m, dict))


class _Unported(Exception):
    """A request for a feature of a later slice: answered with ``code``
    (501, or 400 for a request option the route cannot honour yet)."""

    def __init__(self, why: str, code: int = 501):
        super().__init__(why)
        self.code = code


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

        def _not_ported(self, why: str, code: int = 501):
            kind = "not_implemented" if code == 501 else "invalid_request_error"
            self._json({"error": {"code": code, "type": kind, "message": why}}, code)

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _run_request(self, prompt_tokens, body, stop_strings=(), probs_out=None):
            """Submit and collect: returns an iterator of (piece, finished,
            reason) with the submitted GenRequest as ``.req`` (aborted on
            disconnect). Set-up runs eagerly, so an invalid request raises
            here and the route answers 400 (or 501 for a later slice's
            route) instead of dropping the connection."""
            if body.get("grammar") or body.get("json_schema") or body.get("response_format"):
                raise _Unported(GRAMMAR, 400)
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
                n_probs=n_probs,
                on_probs=on_probs,
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
            """_run_request with its errors mapped to 501 / 400; None when
            the response was already sent."""
            try:
                return self._run_request(toks, body, **kw)
            except _Unported as e:
                self._not_ported(str(e), e.code)
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
            if self.path in WAITING_ROUTES:
                self._not_ported(WAITING_ROUTES[self.path])
            elif self.path == "/health":
                self._json({"status": "ok"})
            elif self.path in ("/v1/models", "/models"):
                self._json({"object": "list", "data": [{
                    "id": self.st.model_name, "object": "model",
                    "created": int(self.st.t_start), "owned_by": "rrs_tpu_torch",
                    "loaded": True}]})
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
            if path in WAITING_ROUTES:
                self._not_ported(WAITING_ROUTES[path])
            elif path.startswith("/slots/"):
                self._slot_action(body)
            elif path == "/tokenize":
                self._json({"tokens": self.st.vocab.encode(
                    body.get("content", ""), add_special=bool(body.get("add_special", False)))})
            elif path == "/detokenize":
                self._json({"content": self.st.vocab.decode(body.get("tokens", []))})
            elif path == "/apply-template":
                messages = body.get("messages", [])
                if _has_media(messages):
                    self._not_ported(MEDIA)
                    return
                text, _ = self.st.render_chat(messages, tools=body.get("tools") or None)
                self._json({"prompt": text})
            elif path == "/v1/chat/completions":
                self._chat(body)
            elif path in ("/v1/completions", "/completion", "/completions"):
                self._completion(body)
            else:
                self._json({"error": "not found"}, 404)

        def _chat(self, body):
            messages = body.get("messages", [])
            if _has_media(messages):
                self._not_ported(MEDIA)
                return
            tools = body.get("tools") or None
            text, chat_stops = self.st.render_chat(messages, tools=tools)
            toks = self.st.vocab.encode(text, add_special=False)
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            probs = []
            gen = self._start(toks, body, stop_strings=chat_stops, probs_out=probs)
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


def serve(args):
    """``python -m rrs_tpu_torch serve``: load the GGUF on ``args.device``,
    start the engine and serve HTTP until interrupted."""
    from rrs_tpu_torch.models.loader import load_model, parse_kv_overrides
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg, weights, md = load_model(args.model, device=args.device,
                                  overrides=parse_kv_overrides(args.override_kv))
    vocab = Vocab.from_gguf(md)
    ctx = InferenceContext(cfg, weights, n_lanes=args.parallel, max_seq=args.ctx,
                           kv_quant=args.cache_type, device=args.device)
    engine = Engine(ctx)
    engine.start()
    state = ServerState(cfg, vocab, engine, md, model_name=str(args.model))
    if args.slot_save_path:
        os.makedirs(args.slot_save_path, exist_ok=True)
        state.slot_save_path = args.slot_save_path
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
