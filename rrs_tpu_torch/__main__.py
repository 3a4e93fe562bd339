"""CLI: ``python -m rrs_tpu_torch generate|serve|chat -m model.gguf``.

The ``generate``, ``serve`` and ``chat`` verbs of ``rrs_tpu/__main__.py``
with the same flags, plus ``--device`` (default ``cuda``; ``cpu`` must be
asked for). Flags whose feature is not ported yet (speculative and lookup
decoding, multimodal projectors, the multi-model router, tensor / data
parallelism) raise NotImplementedError when set.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="rrs_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="generate text from a GGUF model")
    g.add_argument("--model", "-m", required=True)
    g.add_argument("--prompt", "-p", default="Hello")
    g.add_argument("--n-tokens", "-n", type=int, default=64)
    g.add_argument("--temp", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=40)
    g.add_argument("--top-p", type=float, default=0.95)
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--ctx", type=int, default=2048)
    g.add_argument("--no-bos", action="store_true")
    g.add_argument("--cache-type", default="none", choices=["none", "q8", "q4"],
                   help="KV cache quantization")
    g.add_argument("--model-draft", "-md", default=None,
                   help="draft model for speculative decoding (not ported)")
    g.add_argument("--draft", type=int, default=4, help="draft length")
    g.add_argument("--lookup", action="store_true",
                   help="prompt-lookup speculative decoding (not ported)")
    g.add_argument("--override-kv", action="append", metavar="KEY=TYPE:VALUE",
                   help="override a GGUF metadata KV (repeatable; "
                        "TYPE in int/float/bool/str)")
    g.add_argument("--tp", type=int, default=1, help="tensor parallel (not ported)")
    g.add_argument("--dp", type=int, default=1, help="data parallel (not ported)")
    g.add_argument("--dist-coordinator", default=None, help="(not ported)")
    g.add_argument("--dist-procs", type=int, default=None, help="(not ported)")
    g.add_argument("--dist-id", type=int, default=None, help="(not ported)")
    _device_arg(g)

    s = sub.add_parser("serve", help="OpenAI-compatible HTTP server")
    s.add_argument("--model", "-m", required=True)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--parallel", type=int, default=4, help="server slots")
    s.add_argument("--ctx", type=int, default=4096)
    s.add_argument("--cache-type", default="none", choices=["none", "q8", "q4"],
                   help="KV cache quantization")
    s.add_argument("--models", nargs="*", default=None,
                   help="extra routable models name=path.gguf (not ported)")
    s.add_argument("--mmproj", default=None, help="multimodal projector GGUF (not ported)")
    s.add_argument("--model-draft", "-md", default=None,
                   help="draft model for server-side speculative decoding (not ported)")
    s.add_argument("--draft", type=int, default=4, help="speculative draft length")
    s.add_argument("--override-kv", action="append", metavar="KEY=TYPE:VALUE",
                   help="override a GGUF metadata KV (repeatable)")
    s.add_argument("--slot-save-path", default=None,
                   help="base dir for /slots save/restore")
    s.add_argument("--tp", type=int, default=1, help="tensor parallel (not ported)")
    s.add_argument("--dp", type=int, default=1, help="data parallel (not ported)")
    s.add_argument("--dist-coordinator", default=None, help="(not ported)")
    s.add_argument("--dist-procs", type=int, default=None, help="(not ported)")
    s.add_argument("--dist-id", type=int, default=None, help="(not ported)")
    _device_arg(s)

    ch = sub.add_parser("chat", help="interactive chat REPL on the serving engine")
    ch.add_argument("--model", "-m", required=True)
    ch.add_argument("--system", default=None, help="system prompt")
    ch.add_argument("--temp", type=float, default=0.8)
    ch.add_argument("--top-k", type=int, default=40)
    ch.add_argument("--top-p", type=float, default=0.95)
    ch.add_argument("--seed", type=int, default=42)
    ch.add_argument("--ctx", type=int, default=2048)
    ch.add_argument("--n-predict", "-n", type=int, default=512, help="max tokens per reply")
    ch.add_argument("--cache-type", default="none", choices=["none", "q8", "q4"],
                    help="KV cache quantization")
    _device_arg(ch)

    args = p.parse_args(argv)
    _refuse_unported(args)
    if args.cmd == "generate":
        cmd_generate(args)
    elif args.cmd == "serve":
        from rrs_tpu_torch.serving.server import serve

        serve(args)
    elif args.cmd == "chat":
        cmd_chat(args)


def _device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs (default cuda; no silent CPU fallback)")


def _refuse_unported(args) -> None:
    """Raise NotImplementedError for a flag whose feature waits for a later
    slice (ROADMAP queue A)."""
    get = lambda name, default=None: getattr(args, name, default)   # noqa: E731
    unported = {
        "--model-draft (ROADMAP A13)": get("model_draft") is not None,
        "--lookup (ROADMAP A13)": bool(get("lookup")),
        "--mmproj (ROADMAP A11)": get("mmproj") is not None,
        "--models (ROADMAP A13)": bool(get("models")),
        "--tp/--dp (ROADMAP A12)": get("tp", 1) != 1 or get("dp", 1) != 1,
        "--dist-* (ROADMAP A12)": any(get(k) is not None
                                      for k in ("dist_coordinator", "dist_procs", "dist_id")),
    }
    bad = [k for k, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"{', '.join(bad)}: not ported to rrs_tpu_torch yet")


def cmd_generate(args):
    from rrs_tpu_torch.models.loader import load_model, parse_kv_overrides
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.runtime.sampler import SamplerParams

    cfg, weights, md = load_model(args.model, device=args.device,
                                  overrides=parse_kv_overrides(args.override_kv))
    vocab = Vocab.from_gguf(md)
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=args.ctx,
                           kv_quant=args.cache_type, device=args.device)
    tokens = vocab.encode(args.prompt, add_special=not args.no_bos)
    params = SamplerParams(temperature=args.temp, top_k=args.top_k, top_p=args.top_p,
                           seed=args.seed)
    stop = tuple(t for t in (vocab.eos_id,) if t >= 0)
    out = ctx.generate(tokens, args.n_tokens, params, stop_tokens=stop)
    print(vocab.decode(out))
    perf = ctx.perf()
    print(f"perf: prompt {perf['n_p_eval']} tok @ {perf['pp_tok_per_s']:.1f} tok/s | "
          f"gen {perf['n_eval']} tok @ {perf['tg_tok_per_s']:.1f} tok/s", file=sys.stderr)


def cmd_chat(args, read_line=input):
    """Interactive multi-turn chat on the serving engine. Each turn reuses
    the engine's retained prompt cache, so it prefills only the new suffix.
    Commands: /exit | /quit, /clear (drop history), /system <text>."""
    import threading

    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.runtime.sampler import SamplerParams
    from rrs_tpu_torch.serving.chat import build_prompt, detect_template
    from rrs_tpu_torch.serving.engine import Engine, GenRequest

    cfg, weights, md = load_model(args.model, device=args.device)
    vocab = Vocab.from_gguf(md)
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=args.ctx,
                           kv_quant=args.cache_type, device=args.device)
    template = str(md.get("tokenizer.chat_template", "") or "")
    fallback = detect_template(md)
    eng = Engine(ctx)
    eng.start()
    params = SamplerParams(temperature=args.temp, top_k=args.top_k, top_p=args.top_p,
                           seed=args.seed)
    stop_ids = tuple(t for t in (vocab.eos_id,) if t is not None and t >= 0)
    messages = [{"role": "system", "content": args.system}] if args.system else []
    print(f"chat: {args.model} (template: {fallback or 'jinja'}; /exit to quit, "
          "/clear to reset)", file=sys.stderr)
    try:
        while True:
            try:
                line = read_line("> ").strip()
            except EOFError:
                break
            if not line:
                continue
            if line in ("/exit", "/quit"):
                break
            if line == "/clear":
                messages = [{"role": "system", "content": args.system}] if args.system else []
                print("(history cleared)", file=sys.stderr)
                continue
            if line.startswith("/system "):
                messages = [m for m in messages if m["role"] != "system"]
                messages.insert(0, {"role": "system", "content": line[len("/system "):]})
                print("(system prompt set)", file=sys.stderr)
                continue
            messages.append({"role": "user", "content": line})
            prompt, stops = build_prompt(template, fallback, messages)
            done = threading.Event()
            reply = []

            def on_token(tok, piece, finished, reason, _done=done, _reply=reply):
                if piece:
                    _reply.append(piece)
                    print(piece, end="", flush=True)
                if finished:
                    _done.set()

            eng.submit(GenRequest(prompt_tokens=vocab.encode(prompt, add_special=False),
                                  max_tokens=args.n_predict, params=params,
                                  stop_tokens=stop_ids, stop_strings=stops,
                                  decode_fn=vocab.decode, on_token=on_token))
            done.wait()
            print()
            messages.append({"role": "assistant", "content": "".join(reply)})
    finally:
        eng.stop()


if __name__ == "__main__":
    main()
