"""CLI: ``python -m rrs_tpu_torch generate -m model.gguf``.

The ``generate`` verb of ``rrs_tpu/__main__.py`` with the same flags, plus
``--device`` (default ``cuda``; ``cpu`` must be asked for). Flags whose
feature is not ported yet (quantized KV, speculative and lookup decoding,
tensor / data parallelism) raise NotImplementedError when set.
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
                   help="KV cache quantization (only 'none' is ported)")
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
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default cuda; no silent CPU fallback)")

    args = p.parse_args(argv)
    if args.cmd == "generate":
        cmd_generate(args)


def cmd_generate(args):
    unported = {
        "--cache-type": args.cache_type != "none",
        "--model-draft": args.model_draft is not None,
        "--lookup": args.lookup,
        "--tp/--dp": args.tp != 1 or args.dp != 1,
        "--dist-*": any(v is not None for v in (args.dist_coordinator, args.dist_procs,
                                                 args.dist_id)),
    }
    bad = [k for k, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"{', '.join(bad)}: not ported to rrs_tpu_torch yet")

    from rrs_tpu_torch.models.loader import load_model, parse_kv_overrides
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.runtime.sampler import SamplerParams

    cfg, weights, md = load_model(args.model, device=args.device,
                                  overrides=parse_kv_overrides(args.override_kv))
    vocab = Vocab.from_gguf(md)
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=args.ctx, device=args.device)
    tokens = vocab.encode(args.prompt, add_special=not args.no_bos)
    params = SamplerParams(temperature=args.temp, top_k=args.top_k, top_p=args.top_p,
                           seed=args.seed)
    stop = tuple(t for t in (vocab.eos_id,) if t >= 0)
    out = ctx.generate(tokens, args.n_tokens, params, stop_tokens=stop)
    print(vocab.decode(out))
    perf = ctx.perf()
    print(f"perf: prompt {perf['n_p_eval']} tok @ {perf['pp_tok_per_s']:.1f} tok/s | "
          f"gen {perf['n_eval']} tok @ {perf['tg_tok_per_s']:.1f} tok/s", file=sys.stderr)


if __name__ == "__main__":
    main()
