"""CLI: ``python -m rrs_tpu_torch <verb>``.

The verbs of ``rrs_tpu/__main__.py`` with the same flags: ``generate``,
``serve``, ``chat``, ``bench``, ``batched-bench``, ``perplexity``,
``imatrix``, ``quantize``, ``gguf-split``, ``quantize-stats``, ``tokenize``,
``export-lora``, ``cvector``, ``fit-params``, ``convert-hf``, ``tts`` and
``finetune``, plus
``--device`` on the verbs that compute on a device (default ``cuda``;
``cpu`` must be asked for). Every ``-m`` takes a single GGUF or any shard of
a ``-NNNNN-of-NNNNN`` set; ``quantize``, ``gguf-split``, ``tokenize``,
``export-lora``, ``fit-params`` and ``convert-hf`` are host code.
``generate`` decodes speculatively with ``--model-draft`` or by prompt
lookup with ``--lookup``; ``serve`` takes a draft model and extra routable
``--models`` and the vision and audio towers of an mmproj file
(``--mmproj``). ``convert-hf --mmproj`` extracts a VLM's vision tower.
``tts`` speaks a prompt with an OuteTTS model and a WavTokenizer vocoder
into a WAV. ``finetune`` trains an f32 model on a text file and writes it
back to GGUF (a quantized or fused layer refuses to export, as in JAX).
``generate``, ``serve`` and ``bench`` take ``--tp`` / ``--dp`` (a (dp, tp)
mesh of shards, ``parallel/sharding.py``) and ``--dist-*`` (several
processes, ``parallel/distributed.py``); ``perplexity --pp`` runs the layer
split of ``parallel/pipeline.py``.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    from rrs_tpu_torch.parallel.distributed import add_parallel_args

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
                   help="draft model for speculative decoding")
    g.add_argument("--draft", type=int, default=4, help="draft length")
    g.add_argument("--lookup", action="store_true",
                   help="prompt-lookup (n-gram) speculative decoding")
    g.add_argument("--override-kv", action="append", metavar="KEY=TYPE:VALUE",
                   help="override a GGUF metadata KV (repeatable; "
                        "TYPE in int/float/bool/str)")
    add_parallel_args(g)
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
                   help="extra routable models: name=path.gguf ... (multi-model router)")
    s.add_argument("--mmproj", default=None,
                   help="mmproj GGUF: its vision tower, audio tower, or both")
    s.add_argument("--model-draft", "-md", default=None,
                   help="draft model GGUF for server-side speculative decoding")
    s.add_argument("--draft", type=int, default=4, help="speculative draft length")
    s.add_argument("--override-kv", action="append", metavar="KEY=TYPE:VALUE",
                   help="override a GGUF metadata KV (repeatable)")
    s.add_argument("--slot-save-path", default=None,
                   help="base dir for /slots save/restore")
    add_parallel_args(s)
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

    pp = sub.add_parser("perplexity", help="windowed NLL perplexity on a text file")
    pp.add_argument("--model", "-m", required=True)
    pp.add_argument("--file", "-f", default=None)
    pp.add_argument("--n-ctx", type=int, default=512)
    pp.add_argument("--max-chunks", type=int, default=0)
    pp.add_argument("--hellaswag", default=None, metavar="FILE",
                    help="HellaSwag datafile (6 lines a task)")
    pp.add_argument("--hellaswag-tasks", type=int, default=400)
    pp.add_argument("--winogrande", default=None, metavar="CSV",
                    help="Winogrande CSV (index,sentence,choice1,choice2,answer)")
    pp.add_argument("--winogrande-tasks", type=int, default=0)
    pp.add_argument("--multiple-choice", default=None, metavar="JSON",
                    help="JSON file of {prompt, choices, answer} tasks, or the "
                         "reference's .bin task format")
    pp.add_argument("--kl-divergence-base", default=None, metavar="NPZ",
                    help=".npz with 'tokens' + 'logits' from a base model; prints "
                         "KL(base||model) stats")
    pp.add_argument("--save-logits", default=None, metavar="NPZ",
                    help="save this model's tokens + logits for a later "
                         "--kl-divergence-base comparison")
    pp.add_argument("--pp", type=int, default=1, metavar="N",
                    help="pipeline (layer-split) stages for text-file perplexity")
    pp.add_argument("--override-kv", action="append", metavar="KEY=TYPE:VALUE",
                    help="override a GGUF metadata KV (repeatable)")
    pp.add_argument("--pp-micro", type=int, default=2, metavar="M",
                    help="microbatches (chunks) per pipeline dispatch")
    _device_arg(pp)

    b = sub.add_parser("bench", help="pp/tg throughput sweeps")
    b.add_argument("--model", "-m", nargs="*", default=None)
    b.add_argument("--preset", nargs="*", default=["qwen3-4b"])
    b.add_argument("--pp", "-p", type=int, nargs="*", default=[512])
    b.add_argument("--tg", "-n", type=int, nargs="*", default=[128])
    b.add_argument("--pg", nargs="*", default=[], metavar="PP,TG",
                   help="combined prefill+decode tests, e.g. 512,128")
    b.add_argument("--depth", "-d", type=int, nargs="*", default=[0],
                   help="prior KV depth for each test")
    b.add_argument("--batch", "-b", type=int, nargs="*", default=[1],
                   help="parallel decode lanes")
    b.add_argument("--ctk", nargs="*", default=["bf16"],
                   choices=["bf16", "f16", "q8_0", "q4_0"], help="KV cache K type(s)")
    b.add_argument("--ctv", default=None, choices=["bf16", "f16", "q8_0", "q4_0"],
                   help="KV cache V type (default: same as --ctk)")
    b.add_argument("--reps", "-r", type=int, default=3)
    b.add_argument("--output-format", "-o", default="md",
                   choices=["md", "csv", "json", "jsonl", "sql"])
    b.add_argument("--json", action="store_true", help="shorthand for -o jsonl")
    add_parallel_args(b)
    _device_arg(b)

    bb = sub.add_parser("batched-bench", help="parallel decode throughput grid")
    bb.add_argument("--model", "-m", default=None)
    bb.add_argument("--preset", default="qwen3-0.6b")
    bb.add_argument("--pp", type=int, nargs="*", default=[128, 512])
    bb.add_argument("--tg", type=int, nargs="*", default=[128])
    bb.add_argument("--pl", type=int, nargs="*", default=[1, 4, 8])
    bb.add_argument("--json", action="store_true")
    _device_arg(bb)

    q = sub.add_parser("quantize", help="requantize a GGUF model to TCQ4_K32")
    q.add_argument("src")
    q.add_argument("dst")
    q.add_argument("--type", dest="out_type", default="tcq4",
                   choices=("tcq4", "q2_k", "q2_k_s", "q3_k_s", "q3_k_m", "q3_k_l", "q4_0",
                            "q4_1", "q4_k", "q4_k_s", "q4_k_m", "q5_0", "q5_1", "q5_k_s",
                            "q5_k_m", "q6_k", "iq4_nl", "iq4_xs", "q8_0", "mxfp4", "f16"),
                   help="output ftype (llama-quantize menu analog; K-quant ftypes apply the "
                        "per-tensor mix policy)")
    q.add_argument("--tcq4-imatrix", "--imatrix", dest="imatrix", default=None,
                   help="imatrix GGUF: per-block channel reordering for --type tcq4, "
                        "importance-weighted encoders for the K-quant/IQ4 ftypes")

    im = sub.add_parser("imatrix", help="collect activation statistics")
    im.add_argument("--model", "-m", required=True)
    im.add_argument("--file", "-f", required=True)
    im.add_argument("--output", "-o", default="imatrix.gguf")
    im.add_argument("--chunk-len", type=int, default=512)
    im.add_argument("--max-chunks", type=int, default=20)
    _device_arg(im)

    sp = sub.add_parser("gguf-split", help="shard or merge GGUF files")
    sp.add_argument("--split", type=int, default=0, help="number of shards")
    sp.add_argument("--merge", action="store_true")
    sp.add_argument("src")
    sp.add_argument("dst")

    qs2 = sub.add_parser("quantize-stats",
                         help="per-tensor RMSE + matvec error per format "
                              "(test-quantize-stats analog)")
    qs2.add_argument("--model", "-m", default=None,
                     help="GGUF to analyze (default: synthetic weights)")
    qs2.add_argument("--max-tensors", type=int, default=8)
    qs2.add_argument("--samples", type=int, default=64, help="activation rows per tensor")
    qs2.add_argument("--seed", type=int, default=0)
    qs2.add_argument("--json", action="store_true")
    _device_arg(qs2)

    tk = sub.add_parser("tokenize", help="tokenize text with a model's vocab")
    tk.add_argument("--model", "-m", required=True)
    tk.add_argument("--prompt", "-p", required=True)
    tk.add_argument("--ids-only", action="store_true")

    el = sub.add_parser("export-lora", help="merge a LoRA adapter into a GGUF")
    el.add_argument("--model", "-m", required=True)
    el.add_argument("--lora", required=True)
    el.add_argument("--output", "-o", required=True)
    el.add_argument("--lora-scale", type=float, default=1.0)

    cv = sub.add_parser("cvector", help="generate a control vector GGUF")
    cv.add_argument("--model", "-m", required=True)
    cv.add_argument("--positive-file", required=True, help="one positive prompt per line")
    cv.add_argument("--negative-file", required=True)
    cv.add_argument("--output", "-o", default="control_vector.gguf")
    _device_arg(cv)

    fp = sub.add_parser("fit-params", help="max context/lanes for a memory budget")
    fp.add_argument("--model", "-m", required=True)
    fp.add_argument("--hbm-gib", type=float, default=16.0)
    fp.add_argument("--parallel", type=int, default=1)
    fp.add_argument("--ctx", type=int, default=0)
    fp.add_argument("--cache-type", default="none", choices=["none", "q8", "q4"])

    hf = sub.add_parser("convert-hf", help="convert a local HF checkpoint dir to GGUF")
    hf.add_argument("model_dir")
    hf.add_argument("out")
    hf.add_argument("--outtype", default="f32", choices=["f32", "f16"])
    hf.add_argument("--mmproj", action="store_true",
                    help="extract the VLM vision tower into an mmproj GGUF")

    tts = sub.add_parser("tts", help="text-to-speech (OuteTTS + WavTokenizer)")
    tts.add_argument("--model", "-m", required=True, help="OuteTTS GGUF")
    tts.add_argument("--model-vocoder", "-mv", required=True, help="WavTokenizer-dec GGUF")
    tts.add_argument("--prompt", "-p", required=True)
    tts.add_argument("--output", "-o", default="output.wav")
    tts.add_argument("--max-codes", type=int, default=768)
    _device_arg(tts)

    ft = sub.add_parser("finetune", help="finetune a model on a text file")
    ft.add_argument("--model", "-m", required=True)
    ft.add_argument("--file", "-f", required=True)
    ft.add_argument("--output", "-o", required=True)
    ft.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ft.add_argument("--lr", type=float, default=1e-4)
    ft.add_argument("--epochs", type=int, default=1)
    ft.add_argument("--seq-len", type=int, default=256)
    ft.add_argument("--batch", type=int, default=1)
    _device_arg(ft)

    args = p.parse_args(argv)
    if args.cmd == "generate":
        cmd_generate(args)
    elif args.cmd == "serve":
        from rrs_tpu_torch.serving.server import serve

        serve(args)
    elif args.cmd == "chat":
        cmd_chat(args)
    elif args.cmd == "perplexity":
        # quality evals take the exact quantized matmuls (the i8p prefill
        # pack trades ~0.3% weight requantization error for speed)
        os.environ.setdefault("RRS_PREFILL_I8", "0")
        cmd_perplexity(args)
    elif args.cmd == "bench":
        from rrs_tpu_torch.tools.bench_sweep import run

        run(args)
    elif args.cmd == "batched-bench":
        cmd_batched_bench(args)
    elif args.cmd == "quantize":
        cmd_quantize(args)
    elif args.cmd == "imatrix":
        cmd_imatrix(args)
    elif args.cmd == "gguf-split":
        from rrs_tpu_torch.tools.gguf_split import merge_gguf, split_gguf

        if args.merge:
            out = merge_gguf(args.src, args.dst)
            print(f"merged -> {out}")
        else:
            paths = split_gguf(args.src, args.dst, args.split or 2)
            print("wrote:\n  " + "\n  ".join(str(p) for p in paths))
    elif args.cmd == "quantize-stats":
        from rrs_tpu_torch.tools.quantize_stats import run

        run(args)
    elif args.cmd == "tokenize":
        cmd_tokenize(args)
    elif args.cmd == "export-lora":
        from rrs_tpu_torch.tools.export_lora import export_lora_merged

        out = export_lora_merged(args.model, args.lora, args.output, scale=args.lora_scale)
        print(f"wrote merged model -> {out}")
    elif args.cmd == "cvector":
        cmd_cvector(args)
    elif args.cmd == "fit-params":
        cmd_fit_params(args)
    elif args.cmd == "tts":
        cmd_tts(args)
    elif args.cmd == "finetune":
        cmd_finetune(args)
    elif args.cmd == "convert-hf":
        import numpy as np

        from rrs_tpu_torch.tools.convert_hf import convert_hf_mmproj, convert_hf_to_gguf

        fn = convert_hf_mmproj if args.mmproj else convert_hf_to_gguf
        out = fn(args.model_dir, args.out,
                 out_dtype=np.float16 if args.outtype == "f16" else np.float32)
        print(f"wrote {out}")


def _device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs (default cuda; no silent CPU fallback)")


def cmd_finetune(args):
    """The JAX verb (rrs_tpu/__main__.py:303-323): load f32 and unfused,
    encode the file with its special tokens, train, print each step's loss,
    write the trained model with ``export_weights_gguf``; then the mean loss
    of the trained weights over the first two batches."""
    import torch

    from rrs_tpu_torch.models.export import export_weights_gguf
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.train.finetune import TrainConfig, evaluate, make_dataset, train

    cfg, weights, md = load_model(args.model, dtype=torch.float32, fuse=False,
                                  device=args.device)
    vocab = Vocab.from_gguf(md)
    with open(args.file) as f:
        toks = vocab.encode(f.read(), add_special=True)
    batches = make_dataset(toks, seq_len=args.seq_len, batch=args.batch)
    print(f"{len(toks)} tokens -> {len(batches)} batches")
    tc = TrainConfig(optimizer=args.optimizer, lr=args.lr)
    weights, _ = train(cfg, weights, batches, tc, n_epochs=args.epochs,
                       on_step=lambda i, l: print(f"step {i}: loss {l:.4f}", flush=True),
                       device=args.device)
    export_weights_gguf(cfg, weights, args.output, metadata=md)
    print(f"wrote {args.output}")
    print(f"trained loss {evaluate(cfg, weights, batches[:2], device=args.device):.6f} "
          f"(mean over {len(batches[:2])} batches)")


def cmd_generate(args):
    from rrs_tpu_torch.models.loader import load_model, parse_kv_overrides
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.recurrent import make_context
    from rrs_tpu_torch.runtime.sampler import SamplerParams

    from rrs_tpu_torch.parallel.distributed import lanes_for, maybe_initialize, mesh_from_args

    maybe_initialize(args)
    mesh = mesh_from_args(args)
    # a mesh shards the projections per head and per FFN column: unfused
    cfg, weights, md = load_model(args.model, device=args.device, fuse=mesh is None,
                                  overrides=parse_kv_overrides(args.override_kv))
    vocab = Vocab.from_gguf(md)
    ctx = make_context(cfg, weights, n_lanes=lanes_for(1, mesh), max_seq=args.ctx,
                       kv_quant=args.cache_type, device=args.device, mesh=mesh)
    del weights
    tokens = vocab.encode(args.prompt, add_special=not args.no_bos)
    params = SamplerParams(temperature=args.temp, top_k=args.top_k, top_p=args.top_p,
                           seed=args.seed)
    stop = tuple(t for t in (vocab.eos_id,) if t >= 0)
    if args.model_draft:
        from rrs_tpu_torch.runtime.speculative import generate_speculative

        dcfg, dweights, _ = load_model(args.model_draft, device=args.device)
        draft_ctx = make_context(dcfg, dweights, n_lanes=1, max_seq=args.ctx,
                                 device=args.device)
        out, stats = generate_speculative(ctx, draft_ctx, tokens, args.n_tokens,
                                          n_draft=args.draft, stop_tokens=stop)
        print(f"speculative: {stats.n_accepted}/{stats.n_drafted} drafts accepted "
              f"({stats.acceptance_rate:.0%})", file=sys.stderr)
    elif args.lookup:
        from rrs_tpu_torch.runtime.lookup import generate_lookup

        out, stats = generate_lookup(ctx, tokens, args.n_tokens, stop_tokens=stop)
        print(f"lookup: {stats.n_accepted}/{stats.n_drafted} drafts accepted", file=sys.stderr)
    else:
        out = ctx.generate(tokens, args.n_tokens, params, stop_tokens=stop)
    print(vocab.decode(out))
    perf = ctx.perf()
    print(f"perf: prompt {perf['n_p_eval']} tok @ {perf['pp_tok_per_s']:.1f} tok/s | "
          f"gen {perf['n_eval']} tok @ {perf['tg_tok_per_s']:.1f} tok/s", file=sys.stderr)


def cmd_perplexity(args):
    """Perplexity of a text file, or KL divergence against saved logits, or
    multiple-choice accuracy (HellaSwag, Winogrande, JSON / .bin tasks); the
    output lines of the JAX verb."""
    import json

    import numpy as np

    from rrs_tpu_torch.models.loader import load_model, parse_kv_overrides
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.tools import perplexity as ppl

    if args.pp > 1:
        from rrs_tpu_torch.parallel.pipeline import make_pp_mesh

        if not args.file:
            raise SystemExit("--pp supports text-file perplexity only")
        mesh = make_pp_mesh(args.pp, device=args.device)
        cfg, weights, md = load_model(args.model, device=args.device,
                                      overrides=parse_kv_overrides(args.override_kv))
        vocab = Vocab.from_gguf(md)
        with open(args.file, encoding="utf-8") as f:
            tokens = vocab.encode(f.read(), add_special=False)
        if args.max_chunks:
            tokens = tokens[: args.max_chunks * args.n_ctx]
        res = ppl.compute_perplexity_pp(cfg, weights, tokens, mesh, n_ctx=args.n_ctx,
                                        n_micro=args.pp_micro, progress=True)
        print(f"Final PPL = {res.ppl:.4f} over {res.n_tokens} tokens (pp={args.pp})")
        return
    cfg, weights, md = load_model(args.model, device=args.device,
                                  overrides=parse_kv_overrides(args.override_kv))
    vocab = Vocab.from_gguf(md)
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=args.n_ctx, device=args.device)
    if args.hellaswag:
        with open(args.hellaswag, encoding="utf-8") as f:
            tasks = ppl.load_hellaswag(f.read())
        acc = ppl.hellaswag_score(ctx, vocab, tasks, n_tasks=args.hellaswag_tasks, progress=True)
        n = min(args.hellaswag_tasks or len(tasks), len(tasks))
        print(f"hellaswag acc_norm = {100 * acc:.4f}% over {n} tasks")
        return
    if args.winogrande:
        with open(args.winogrande, encoding="utf-8") as f:
            tasks = ppl.load_winogrande(f.read())
        acc = ppl.winogrande_score(ctx, vocab, tasks, n_tasks=args.winogrande_tasks,
                                   progress=True)
        n = min(args.winogrande_tasks or len(tasks), len(tasks))
        print(f"winogrande accuracy = {100 * acc:.4f}% over {n} tasks")
        return
    if args.multiple_choice:
        if args.multiple_choice.endswith(".bin"):
            with open(args.multiple_choice, "rb") as f:
                tasks = ppl.load_multiple_choice_bin(f.read())
        else:
            with open(args.multiple_choice, encoding="utf-8") as f:
                tasks = json.load(f)
        acc, _ = ppl.multiple_choice_score(ctx, vocab, tasks)
        print(f"multiple-choice accuracy = {acc:.4f} over {len(tasks)} tasks")
        return
    if args.kl_divergence_base:
        z = np.load(args.kl_divergence_base)
        r = ppl.kl_divergence(ctx, z["logits"], [int(t) for t in z["tokens"]])
        print(f"KL(base||model): mean={r['mean_kl']:.6f} max={r['max_kl']:.4f} "
              f"same_top={r['same_top_rate']:.2%} over {r['n_pos']} positions")
        return
    if not args.file:
        raise SystemExit("need --file, --multiple-choice, or --kl-divergence-base")
    with open(args.file, encoding="utf-8") as f:
        tokens = vocab.encode(f.read(), add_special=False)
    if args.max_chunks:
        tokens = tokens[: args.max_chunks * args.n_ctx]
    if args.save_logits:
        toks = tokens[: args.n_ctx]
        logits = ppl.host_logits(ctx, toks)
        np.savez_compressed(args.save_logits, tokens=np.asarray(toks),
                            logits=logits.astype(np.float16))
        print(f"saved {logits.shape} logits -> {args.save_logits}")
        return
    res = ppl.compute_perplexity(ctx, tokens, n_ctx=args.n_ctx, progress=True)
    print(f"Final PPL = {res.ppl:.4f} over {res.n_tokens} tokens")


def cmd_batched_bench(args):
    from rrs_tpu_torch.tools.batched_bench import run_batched_bench

    if args.model:
        from rrs_tpu_torch.models.loader import load_model

        cfg, weights, _ = load_model(args.model, device=args.device)
    else:
        from rrs_tpu_torch.models import llama
        from rrs_tpu_torch.models.config import PRESETS

        cfg = PRESETS[args.preset]
        weights = llama.fabricated_tcq4_weights(cfg, seed=0, device=args.device)
    run_batched_bench(cfg, weights, args.pp, args.tg, args.pl, as_json=args.json)


def cmd_quantize(args):
    from rrs_tpu_torch.quantize.quantizer import quantize_model

    perms = None
    imatrix = None
    if args.imatrix:
        from rrs_tpu_torch.quantize.imatrix import derive_tcq4_perms, load_imatrix

        imatrix = load_imatrix(args.imatrix)
        if args.out_type == "tcq4":
            perms = derive_tcq4_perms(imatrix)
            print(f"derived {len(perms)} channel permutations from imatrix")
        else:
            print(f"imatrix-weighted encoders for {len(imatrix)} tensors")
    stats = quantize_model(args.src, args.dst, perms=perms, out_type=args.out_type,
                           imatrix=imatrix)
    print(f"quantized: {stats}")


def cmd_imatrix(args):
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.quantize.imatrix import collect_imatrix, save_imatrix

    cfg, weights, md = load_model(args.model, device=args.device)
    vocab = Vocab.from_gguf(md)
    with open(args.file, encoding="utf-8") as f:
        tokens = vocab.encode(f.read(), add_special=False)
    chunks = [tokens[i:i + args.chunk_len]
              for i in range(0, len(tokens), args.chunk_len)][:args.max_chunks]
    acc = collect_imatrix(cfg, weights, chunks, chunk_len=args.chunk_len)
    save_imatrix(args.output, acc)
    print(f"saved imatrix for {len(acc)} tensors -> {args.output}")


def cmd_tokenize(args):
    from rrs_tpu_torch.gguf.reader import read_gguf
    from rrs_tpu_torch.models.vocab import Vocab

    with read_gguf(args.model) as g:
        vocab = Vocab.from_gguf(g.metadata)
    ids = vocab.encode(args.prompt)
    if args.ids_only:
        print(" ".join(map(str, ids)))
    else:
        for i in ids:
            print(f"{i:>8} -> {vocab.tokens[i]!r}")


def cmd_tts(args):
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.recurrent import make_context
    from rrs_tpu_torch.tts.pipeline import synthesize
    from rrs_tpu_torch.tts.vocoder import load_vocoder

    cfg, weights, md = load_model(args.model, device=args.device)
    ctx = make_context(cfg, weights, n_lanes=1, max_seq=4096, device=args.device)
    voc = load_vocoder(args.model_vocoder, device=args.device)
    path, n_codes = synthesize(ctx, Vocab.from_gguf(md), voc, args.prompt,
                               max_codes=args.max_codes, out_path=args.output)
    print(f"wrote {path} ({n_codes} audio codes)")


def cmd_cvector(args):
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.tools.cvector import build_control_vector, save_control_vector

    cfg, weights, md = load_model(args.model, device=args.device)
    vocab = Vocab.from_gguf(md)

    def prompts(path):
        with open(path, encoding="utf-8") as f:
            return [vocab.encode(line, add_special=True) for line in f.read().splitlines() if line]

    dirs = build_control_vector(cfg, weights, prompts(args.positive_file),
                                prompts(args.negative_file))
    out = save_control_vector(args.output, dirs, model_hint=str(md.get("general.name", "")))
    print(f"wrote control vector ({dirs.shape[0]} layers) -> {out}")


def cmd_fit_params(args):
    from rrs_tpu_torch.gguf.reader import read_gguf
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.utils.fit_params import fit_params

    with read_gguf(args.model) as g:
        cfg = ModelConfig.from_gguf(g.metadata)
    r = fit_params(cfg, hbm_bytes=int(args.hbm_gib * 1024**3), n_lanes=args.parallel,
                   n_ctx=args.ctx, kv_quant=args.cache_type)
    print(f"fits={r.fits} n_ctx={r.n_ctx} n_lanes={r.n_lanes} "
          f"model={r.model_bytes/1e9:.2f}GB kv={r.kv_bytes/1e9:.2f}GB "
          f"free={r.free_bytes/1e9:.2f}GB")


def cmd_chat(args, read_line=input):
    """Interactive multi-turn chat on the serving engine. Each turn reuses
    the engine's retained prompt cache, so it prefills only the new suffix.
    Commands: /exit | /quit, /clear (drop history), /system <text>."""
    import threading

    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.recurrent import make_context
    from rrs_tpu_torch.runtime.sampler import SamplerParams
    from rrs_tpu_torch.serving.chat import build_prompt, detect_template
    from rrs_tpu_torch.serving.engine import Engine, GenRequest

    cfg, weights, md = load_model(args.model, device=args.device)
    vocab = Vocab.from_gguf(md)
    ctx = make_context(cfg, weights, n_lanes=1, max_seq=args.ctx, kv_quant=args.cache_type,
                       device=args.device)
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
