#!/usr/bin/env python3
"""On-card smoke run of rrs_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the stated peaks) and the repository around
it; exits non-zero without either, and on any failed phase. Phases:

1. build: compile every kernel in rrs_tpu_torch/csrc with nvcc (parallel,
   one process per source) and print the seconds it took;
2. kernel parity: each kernel of the generate and serving paths against its
   plain PyTorch version at the qwen3-4b shapes of those paths (a served
   step's M = 4, and attention over 4 lanes of a 4096-slot cache with a dead
   lane and a padded row, among them; B4 also at the down projection's M =
   2 and 8, outside gx_viable), with the stated tolerance, timed with CUDA
   events beside its bound, its plain version and one PyTorch library call
   for the same product, over as many weight copies as the kernel reads
   (together past L2; B1 also bit-equal across two launches and, at M = 1,
   to its order of sums emulated in PyTorch; the i8p kernel also against the
   dequant path, within the JAX bound, beside ``torch._int_mm`` on
   pre-decoded int8 weights, and bit-equal across two launches and, where
   its plan takes one K slice, to its plain version; attention beside the
   faster of two SDPA forms, K/V expanded to the query heads and
   ``enable_gqa``, on bf16 caches
   (dequantized beforehand for the quantized ones); B3 and B6-B8 also
   bit-equal across two launches at the served decode step and the prefill
   chunk); then each kernel's other instantiations and options, untimed
   (attention at T = 9 and T = 1);
3. main path: a 2-layer model on the card against the same weights on the
   CPU (bf16, q8 and q4 KV caches), and a 2-layer model with 3 kv heads and
   q4 KV, whose halves-packed cache takes B8 in the model; then
   ``generate`` at full qwen3-4b width (36 layers, fabricated TCQ4 weights
   with their i8p packs, Q8_0 lm_head) for three greedy requests and one
   sampled one, with every kernel's launch count read after the run (its
   decode profile is phase 8's, without ``RRS_GX3``); then ``generate`` with
   q8 and with q4 KV caches;
4. serving: the OpenAI-compatible server in-process at qwen3-4b width with
   4 slots and a 4096 context, answering concurrent completions (prompts of
   40 to 2000 tokens, greedy and sampled), a streamed chat, a penalized and a
   logprobs request; every response must finish by length or stop with the
   right token count, and every kernel, and the device decode runs, must be
   launched;
5. served steps: one 4-lane prefill step (T = 1024, a dead lane) and one
   4-lane decode step at qwen3-4b width with every kernel launch held to its
   plain version on the inputs it got, and the prefill step's shape again
   unheld under torch.profiler (B5's share of its device time); then one
   greedy device decode run on the 4-lane context against the same tokens
   fed step by step through ``ctx.decode``;
6. quantized served steps: the same prefill and decode step over q8 and q4
   KV caches, every kernel launch held to its plain version and every K/V
   store on the card held bit for bit to the CPU's store of the same rows;
7. serving with ``--cache-type q4`` and a slot save path (qwen3-4b's first 12
   of its 36 layers): four concurrent
   completions (1000 and 2000 tokens, greedy and sampled), then a slot
   saved, erased and restored over HTTP (codes equal, scales within 1e-6)
   and a greedy continuation from it; then one context shift of a q4 lane
   on the card held to the CPU's shift of a copy of it, and a profile of
   one q4 served decode run (4 lanes, B7 its only attention kernel);
8. the integer decode kernels and the measuring verbs at qwen3-4b width:
   B15 (``tcq4_matmul_gx3``, ``RRS_GX3``) against its plain version at M = 1
   and 4 and bit-equal to B14 on its own codes, B14 (``tcq4_matmul_gx``)
   against the integer oracle and bit-equal to B1 on B1's codes (both held
   bit-equal across two launches), B16 (``tcq4_matmul_a8``) against the oracle at M = 1,
   8 and 32, bit-equal across two launches and to its order of sums in
   PyTorch, each timed beside its bound, its plain version and
   ``torch.matmul`` on weights dequantized beforehand (rotated past L2, as
   the kernel's copies are); ``generate`` over the first 12 of the 36 layers
   without and with ``RRS_GX3`` (B1 or B15 at all 48 TCQ4 decode linears of
   a step, counted; decode profiles; greedy tokens compared, reported) and the bench
   decode counted the same way; a teacher-forced decode step under the flag
   with every launch held to its plain version and every B15 launch to B14
   and B16 on its codes; ``compute_perplexity`` of a 2-layer dense model on
   the card against the CPU, its two branches against each other and KL
   against its own logits, and at qwen3-4b width through B4; then
   ``bench`` (pp512 / tg64 over bf16 and q8 KV, and with the flag),
   ``batched-bench`` and ``perplexity`` on a GGUF, each run as a user runs
   it, in its own process;
9. B17 (``tcq4_matmul_fused``) and B18 (``tcq4_matmul_pb``), which no model
   path calls (as in the JAX package), at the four qwen3-4b projections, M = 1
   and 512: each against its plain version, B17 bit-equal to B4 on its
   dequantized activations, B18 bit-equal across two launches and within
   the JAX bound of B4 and of the integer oracle (M = 1, 4, 16), each timed
   beside its bound, its plain version and ``torch.matmul`` on weights
   dequantized beforehand (rotated past L2); then one
   teacher-forced 512-token prefill chunk at qwen3-4b width whose 144 TCQ4
   linears each also run B17 and B18 on their own activations, held the
   same way, with the int4 codes that differ from the model's rotation
   counted;
10. the rest of the server at qwen3-4b width, cut to its first 12 of 36
   layers (the synthetic vocabulary with
   three FIM ids, 4 slots, ctx 2048): a ``json_schema`` request alone (the
   optimistic path must resample), then a greedy and a sampled
   ``[a-z ]+`` grammar, a ``response_format: json_object`` chat and a lazy
   grammar with a trigger word at once, every text accepted as a prefix by
   a fresh host grammar; the ``[a-z ]+`` token DFA compiled in a spawned
   process (≤ 4 states) and a later request's runs carrying it with no
   resample, timed beside the same request without a grammar; one DFA run
   stepped on the card, its state trajectory equal to the host DFA's walk;
   ``/v1/embeddings`` of 40 and 300 tokens (B4 and B5 held to their plain
   versions), ``/rerank`` of 3 documents, ``/infill``, ``/v1/messages``
   (streamed and not), ``GET /`` equal to the port's ``webui.html``; a
   2-layer dense model's ``embed`` on the card against the CPU (GLUE_TOL),
   and its self-draft, whose decode logits must agree with the verify
   chunk's within GLUE_TOL at every drafted position;
   ``generate_speculative`` at qwen3-4b width with the target as its own
   draft (one round's launches held to their plain versions; that drift,
   W4A4's B1 against B4, reported) and with a fabricated qwen3-0.6b
   draft, their acceptance and agreement with plain greedy decode
   reported; ``Engine`` with the 0.6b draft on 4 concurrent greedy
   requests and ``generate_lookup`` on a repetitive prompt, their drafted
   and accepted counts reported;
11. gpt-oss-20b (the qwen3-4b tensors freed first): B11-B13 against their
   plain versions at gpt-oss shapes (B11 at M = 4, 300 and 2048, B12 at
   n_sel = 4 and 16, also with ids outside [0, E), and B13 over shared T =
   64 and per-expert C = 128, each bit-equal across two launches), timed
   beside their bounds and
   ``torch.matmul`` / ``torch.bmm`` on weights dequantized beforehand, with B2
   at the three Q8 shapes (qkv and o also at a served step's M = 4 and a
   served prefill chunk's M = 2048) and B3 / B6-B8 over a 640-slot ring
   with window 128 and sinks; a 2-layer gpt-oss model on the card against
   the same weights on the CPU (the CPU's expert ids replayed where the card's
   differ; every launch held to its plain version); ``generate`` at full
   width, cut to 6 of its 24 layers (fabricated weights), with prompts that
   reach every MoE branch,
   launch counts, the branches taken, a decode profile and a one-lane
   40-token prefill step under torch.profiler (B13's share of it), then over
   q8 rings; the server (4 slots, ctx 4096, four 1000 / 2000-token requests);
   a teacher-forced 4-lane prefill chunk and decode step, and the chunk's
   shape again unheld under torch.profiler (B11's share of an overflow-scan
   prefill step); one capacity-path prefill run twice, its logits held
   bit-equal;
12. Qwen3-30B-A3B (the gpt-oss tensors freed first): B9, B10 and B19
   (``tcq4_matmul_experts``, no model path calls it) against their plain
   versions at its shapes (B9 at n_sel = 8 and 32, also with ids outside
   [0, E); B10 over per-expert C = 64 with bf16 and f32 rows, per-expert C
   = 40 and shared T = 64; each bit-equal across two launches; B19 at M = 1
   and 40 with bf16 and f32 eff, bit-equal to B10 on the same experts),
   timed beside their bounds and
   ``torch.bmm`` / ``torch.matmul`` on experts dequantized beforehand; a
   2-layer qwen3moe model on the card against the same weights on the CPU,
   with dense bf16 experts (logits within GLUE_TOL) and with TCQ4 experts
   (every launch held to its plain version, the drift reported); ``generate``
   at full width, cut to 6 of its 48 layers (fabricated weights, the config
   from ``ModelConfig.from_gguf`` on the published metadata) with prompts that
   reach the rows, capacity and scan branches, a capacity prefill run twice
   and held bit-equal, a decode profile, a one-lane 40-token prefill step
   under torch.profiler (B10's share of a capacity-path step) and a run over
   q8 KV; the server (4
   slots, ctx 4096, four 1000 / 2000-token requests); a teacher-forced
   4-lane prefill chunk and decode step, every B9 launch also running B19
   on its rows and ids, whose diagonal must match B9;
13. the GGUF pipeline at qwen3-4b's widths cut to 2 layers, each verb a
   process of its own (the native host codec built in phase 1 and required;
   the host encoders timed first): the port's exporter writes F16 GGUFs;
   ``imatrix`` on the card, its mean squares per tensor held to the CPU
   port's on the same chunks (IMATRIX_TOL) and the permutation entries that
   differ counted; ``quantize --imatrix`` to TCQ4 (native encoder),
   ``gguf-split --split 2`` and ``generate`` from the first shard and from
   the unsplit file, greedy text identical; a teacher-forced prefill and
   decode step from the TCQ4 file on the card, every launch held to its
   plain version, the logits drift against the CPU reported; the model
   router: a server on the tiny preset ``/models/load``s the TCQ4 file
   under a name, answers a completion routed to it and ``/models/unload``s
   it, the card's allocated memory back within 0.1 GB; then
   ``quantize --type q4_k_m --imatrix`` on a 1-layer model with 4,096
   tokens (it runs beside phase 14), ``generate`` and ``perplexity`` on it,
   and its logits on the card within GLUE_TOL of the CPU's;
14. Qwen2-57B-A14B (config from ``ModelConfig.from_gguf`` on its published
   metadata): a 2-layer qwen2moe model at reduced widths on the card
   against the CPU, with dense experts (logits within GLUE_TOL) and TCQ4
   experts (every launch held to plain, drift reported), both with the
   dense shared expert; ``generate`` at the published widths, cut to 7 of
   its 28 layers (fabricated TCQ4 attention and experts, dense bf16 shared
   experts, Q8_0 lm_head) over prompts that take the rows, capacity and
   scan branches, with launch counts; on the same 14 layers, teacher-forced
   prefills of 40 tokens and of 300 copies and a decode step each, every
   launch held to its plain version; after the Q4_K_M part of phase 13 (no
   verb process beside them), decode profiles with and without the shared
   expert, whose difference is its device time a step;
15. the attention families: tiny-mla (q LoRA, V3 routing) in 2 layers on
   the card against the CPU with dense weights (logits within GLUE_TOL) and
   at E = 256 with TCQ4 weights (every launch held to its plain version),
   and gemma2 (softcaps 50 / 30 through B3 and B6), granite, minicpm, olmo2,
   phi3 (partial rotary, LongRoPE factors) and a llama-architecture MoE in 2
   layers against the CPU (GLUE_TOL); DeepSeek-V2-Lite at its published
   widths, cut to 9 of its 27 layers (MLA over one 576 / 512-wide cached row, a dense
   lead layer, 64 dense bf16 experts of 1,408 top-6 and two shared; TCQ4
   projections, Q8_0 lead down and head): ``generate`` over prompts of 5, 40
   and 300 tokens x 32 over bf16 and q8 KV with launch counts and the MoE
   branches, and of 40 x 32 over q4 KV (one head, the halves layout); over
   the q8 and the q4 cache held prefills of 40 and 300 tokens and decode
   steps, every K / V store bit-equal to the CPU's, and one context shift
   of an MLA lane held to the CPU's; the server (4 slots, ctx 4096, four
   1,000 / 2,000-token requests), then on its context a profiled 4-lane
   decode run and MLA's plain attention at 4 lanes x 4,096 slots over bf16
   and q8 KV as a share of it; a B = 1 decode profile, split by timing its
   router, routed-expert gather, shared experts and MLA attention alone;
   then gemma3-4b, cut to 12 of its 34 layers (two of them global):
   ``generate`` over prompts of 5, 40 and 1,600 tokens (the 1,536-slot rings
   wrap) over bf16 and q8 KV, a held 560-token prefill and decode step, a
   decode profile;
16. the recurrent families, every model through ``make_context``: Mamba,
   Falcon-Mamba (the weightless dt / B / C norms), RWKV6 and Jamba (an MoE
   Mamba layer, attention without RoPE) in 2 layers at E = 512 on the card
   against the CPU with dense weights (logits within GLUE_TOL, the states
   after prefill reported) and with TCQ4 weights (every launch held to its
   plain version, the drift reported); Falcon-Mamba-7B at its published
   widths, cut to 16 of its 64 layers (fabricated TCQ4 linears with their
   i8p packs: ssm_x at N = 288, ssm_dt at K = 256; a Q8_0 head):
   ``generate`` over 5-,
   40- and 300-token prompts x 32 with launch counts, a held 128-token
   chunk and decode step, a B = 1 decode profile with the conv's and the
   log-step scan's shares timed alone (and their shares of a 128-token
   chunk beside a loop over T), the server over a 4-lane context (ctx
   4,096; four 300 / 1,000-token requests prefilled at M = 4 x 128, B5; a
   full-prefix prompt-cache reuse and a mismatch that restarts) and one
   held 4-lane prefill step; RWKV-6 7B cut to 8 of 32 layers: ``generate``, a
   held chunk and decode step (B4 at M = 1 for K = 14,336), a decode
   profile with wkv6's share, and its share of a chunk; Jamba-v0.1 cut to 8
   of its 32 layers (one period): ``generate``, a held chunk and decode
   step (B3, B9, B1 / B4), a decode profile with the scan's share;
17. the tool suite at Qwen3-4B's published widths cut to 2 of its 36
   layers, each verb a process of its own: an HF-format directory
   (``config.json``, one BF16 ``model.safetensors`` drawn from a seed and
   written by the port's safetensors writer, a ``tokenizer.json``) through
   ``convert-hf --outtype f16`` and ``quantize`` (TCQ4); ``tokenize`` on both
   files equal to the port's ids; a rank-16 LoRA adapter on the seven
   projections of both layers: attached to the unfused F16 weights on the
   card against the ``export-lora`` merged file and against the CPU port
   (GLUE_TOL), then attached to the unfused TCQ4 weights for a
   teacher-forced 512-token prefill (B5 + delta), a 40-token prefill (B4 +
   delta) and a decode step (B1 + delta), every launch held to its plain
   version, the adapter's effect and a decode step's time with and without
   it reported; control vectors on the F16 file, the card's directions
   within GLUE_TOL of the CPU port's, the GGUF read back equal, a steered
   forward card vs CPU (GLUE_TOL); the ``cvector`` verb on the TCQ4 file;
   ``quantize-stats`` on the card and at ``--device cpu`` over the TCQ4
   file's four smallest projections (the k / v of both layers): every
   statistic equal, the TCQ4 ``rmse_dot`` from the integer oracle, and the
   matvec through B4 (``rmse_dot_b4``) within B4's tolerance of its plain
   version's; ``fit-params --hbm-gib 80`` beside the card's allocation for
   the same file;
18. vision, Qwen2-VL-2B at its published widths, all 28 text layers
   (fabricated TCQ4 linears with their i8p packs and qkv biases, a Q8_0
   head) and the whole 32-layer vision tower (``random_clip_weights``, f32):
   two PNGs written here and decoded by the port (448 x 448 and 448 x 672
   after the bicubic resize), each image's tower timed on the card beside
   its f32 bound; ``generate_with_images`` over each (launch counts as
   ``launches_qwen2vl``: B1-B5); a teacher-forced [text, image, text]
   prefill and a decode step with every launch held to its plain version;
   the server (4 slots, ctx 4096) with the tower loaded: four chat requests
   at once, two with an ``image_url`` part, each one's time to first token
   and the served decode tok/s; a B = 1 decode profile of an image lane;
   the tower on the card against the CPU port (a 112 x 112 image, rel L2 <=
   VISION_TOL); a 2-layer qwen2vl model fed an image chunk (GLUE_TOL), each
   projector at a small width (VISION_TOL) and ``seq_div`` over a bf16 and
   a q4 cache (K bit-equal), card against CPU; an HF-format directory (text
   cut to 2 layers, the full tower, BF16) through ``convert-hf`` and
   ``convert-hf --mmproj`` as processes (the converted tower bit-equal to
   the in-memory one of the same BF16 weights) and ``serve --mmproj``
   answering a chat request with an image;
19. audio and TTS: Ultravox v0.5 at its published widths, all 16 of
   Llama-3.2-1B's layers (fabricated TCQ4 linears with their i8p packs, a
   Q8_0 head) and the whole 32-layer whisper-large-v3-turbo tower with the
   ultravox projector (f32, drawn on the card): two WAVs written here (5 s
   mono at 16 kHz, 8 s stereo at 44.1 kHz) decoded by ``decode_audio_b64``,
   each one's mel front end on the host and its tower on the card beside its
   f32 bound; ``multimodal_prefill`` over [text, audio, text] + greedy
   decode (``launches_audio``: B1-B4, B4 at the chunk's M = 188); a held
   [text, audio, text] prefill and decode step; the server (4 slots, ctx
   4096) with two ``input_audio`` chats and two text chats at once, each
   one's time to first token and the served decode tok/s; a B = 1 decode
   profile after the audio; the tower cut to 2 layers at full width with the
   ultravox and qwen2a projectors on the card against the CPU port
   (AUDIO_TOL); then OuteTTS-0.2-500M at its published widths, all 24 layers
   (Q8_0 qkv / o / gate-up at K = 896 padded to 1,024, TCQ4 ``ffn_down``,
   the head favouring the code ids) with WavTokenizer's decoder at its
   published widths: ``synthesize`` (``launches_tts``; its decode tok/s, the
   vocoder's and the synthesis' ms, the real-time factor), a held prefill and
   decode step (B2 padded, B3 at the GQA group of 7), a decode profile, the
   vocoder on the card against the CPU port (AUDIO_TOL); then the files,
   written by a process started at the phase's beginning, through ``serve
   --mmproj`` (an audio chat) and ``tts`` (a 24 kHz 16-bit mono WAV of the
   right length) as processes;
20. training (``train/finetune.py``), run right after phase 10 on its
   qwen3-4b weights with f32 copies of the float leaves, as the verb loads
   them: the ``finetune`` verb as a process at Qwen3-0.6B's published widths
   (4 of 28 layers, f32, an untied head), its reloaded output's loss within
   1e-3 of the trained one; 2 layers trained at T = 256 / 128 / 8 with every
   B5 / B4 / B1 / B2 launch inside the autograd Functions held to its plain
   version; the STE backward (qkv at M = 8 / 128 / 256) and the Q8 head's
   (dx and d scale) card against CPU; a dense f32 2-layer model's three AdamW
   steps card against CPU (losses and weights); the wrappers' refusal under
   autograd; then ``train()`` at 12 of the 36 layers (AdamW over one repeated
   T = 256 batch, one step at T = 128 and one at T = 8): the loss falls, the
   frozen codes keep their checksums, B5 / B4 / B1 / B2 launch and B3 does
   not (``launches_training``); each step's wall and device-timeline ms, the
   peak memory, a profiled step split into forward, backward and optimizer,
   and the step's bound (the verb's process, and phase 21's two, start with
   the phase; the verb's result is read after phase 22);
21. the parallel paths (``parallel/sharding.py``, ``distributed.py``,
   ``pipeline.py``), run right after phase 20 on phase 3's qwen3-4b weights
   at full width, cut to 6 of 36 layers (12 until phase 22 needed the
   room): tp = 2 as two shards on cuda:0
   (the projections unfused and split per head and FFN column, o and down
   all-reduced, the vocab gathered), prompts of 5 and 300 tokens x 16 greedy
   steps with every kernel's launches counted (``launches_parallel``) and by
   shard, their agreement with the unsharded context and that of one
   device's unfused weights reported, a decode profile of the sharded step;
   over 2 layers a teacher-forced 40- and 300-token prefill and a decode
   step, bf16 and q8 KV, every launch on each shard held to its plain
   version and every row-parallel reduce, before the cast, held to the
   unsharded kernel on the shards' joined inputs; phase 3's 2-layer model
   with dense bf16 weights at tp = 2 and tp 2 x dp 2 held to the unsharded
   context (every logits row within GLUE_TOL on the same tokens, and the
   tp 2 x dp 2 engine's tokens maxima of the unsharded logits); tp 2 x dp
   2 (four shards on cuda:0) with the engine serving four greedy requests on
   4 lanes at full width; ``compute_perplexity_pp`` over two stages on
   cuda:0 against ``compute_perplexity`` (mean NLL within 1e-4 nats, the
   pipeline's logits rows within 1e-3 relative L2); ``generate`` through one NCCL
   process (``--dist-coordinator``, ``--dist-procs 1``) against plain
   ``generate``, as processes;
22. the SPMD train step (``parallel/train_step.py``), right after phase 21:
   qwen3-4b at full width, 12 of 36 layers in f32 floats, at tp = 2 and dp
   2 x tp 2 as shards on cuda:0, three AdamW steps on one repeated T = 256
   batch and one at T = 8 with every B5 / B1 / B4 / B2 launch on each shard
   held to its plain version, the losses falling, the frozen codes equal to
   the caller's, B3 not launched, the launches by shard
   (``launches_train_mesh``), one unheld T = 256 step profiled at tp = 2, a
   fresh dp 2 x tp 2 mesh's unheld losses bit-equal to the held ones;
   phase 3's dense bf16 2-layer model at tp = 2 and dp 2 x tp 2 and an f32
   dense-expert qwen3moe of its width at dp 2 x ep 2 x tp 2, each leaf's
   joined gradient within MESH_GRAD_TOL of one device's and the loss within
   MESH_LOSS_TOL, a second fresh mesh's loss and gradients bit-equal to the
   first's (dp 2 and up), a clipped SGD step's update norm lr x clip within
   MESH_CLIP_TOL; ep 2 x tp 2 at Qwen3-30B-A3B's published widths (2 layers,
   dense f32 experts): the step-0 loss against one device's, falling;
23. the ``{"kernels": [...]}`` line (nineteen kernels; B14 / B16 / B17 / B18 /
   B19 launch on no model path and carry ``held_launches``; the kernels of
   phases 10, 13-21 also carry ``launches_server_rest`` /
   ``launches_gguf_tcq4`` / ``launches_qwen2moe`` / ``launches_mla`` (with
   ``launches_mla_q8`` and ``launches_mla_q4``), ``launches_gemma3``
   (with ``launches_gemma3_q8``), ``launches_falcon_mamba`` /
   ``launches_rwkv6`` / ``launches_jamba``, ``launches_tools``,
   ``launches_qwen2vl``, ``launches_audio``, ``launches_tts``,
   ``launches_training``, ``launches_parallel`` and ``launches_train_mesh``),
   the card's name and power limit, and the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import subprocess
import sys
import tempfile
import threading
import time

GB = 1e9
# Published dense peaks (NVIDIA data sheets): bytes/s, bf16 FLOP/s, int8 OP/s,
# and f32 FLOP/s outside the tensor cores (B17's rotation).
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 1513e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 1671e12, 60e12),
    "H200": (4.8e12, 989e12, 1979e12, 67e12),
    "H100": (3.35e12, 989e12, 1979e12, 67e12),     # SXM
}

QWEN3_4B_LINEARS = {            # (K, N) of the fused projections of one layer
    "qkv": (2560, 6144), "o": (4096, 2560), "gate_up": (2560, 19456), "down": (9728, 2560),
}
L2_BYTES = 50e6


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return PEAKS["H100"]


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_ms(fn, arg_sets, reps: int = 20) -> float:
    """Mean device time of fn over reps launches, rotating through arg_sets
    (copies of the weights, together larger than L2, so every launch reads
    its weights from device memory as the model's layers do). A short device
    sleep first lets the host queue the launches, so host launch overhead
    does not show as device gaps."""
    import torch

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 2e5))
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def n_copies(nbytes: float) -> int:
    return max(2, min(24, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


class Report:
    def __init__(self, name, source, replaces, bound_by):
        self.entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "bound_by": bound_by, "library_ms": 0.0,
                      "shapes": []}

    def add(self, shape: dict, headline: bool):
        self.entry["shapes"].append(shape)
        self.entry["max_abs_err"] = max(self.entry["max_abs_err"], shape["max_abs_err"])
        if headline:
            for key in ("ms", "plain_ms", "bound_ms", "library_ms", "library_int_mm_ms"):
                if key in shape:
                    self.entry[key] = self.entry.get(key, 0.0) + shape[key]
            if "library_form" in shape:
                self.entry["library_form"] = shape["library_form"]
        extra = "".join(f" {k} {shape[k]:.4f}" for k in ("library_int_mm_ms", "dequant_dev",
                                                         "library_expanded_ms", "library_gqa_ms")
                        if k in shape)
        if "library_form" in shape:
            extra += f" (SDPA {shape['library_form']})"
        timed = (f" ms {shape['ms']:.4f} bound {shape['bound_ms']:.4f} ({shape['bound_by']}) "
                 f"plain {shape['plain_ms']:.4f} library {shape['library_ms']:.4f}"
                 if "ms" in shape else "")
        print(f"  {self.entry['name']} {shape['shape']}: err {shape['max_abs_err']:.3e} "
              f"(rel {shape['rel_err']:.2e} <= {shape['tol']:.0e}){timed}{extra}", flush=True)


def compare(name, got, ref, tol):
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    if not (torch.isfinite(got.float()).all() and rel <= tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version: "
                             f"max abs err {err:.3e}, rel {rel:.3e} > {tol:.0e}")
    return err, rel


def sdpa_ms(q, kv_sets, mask, g, scale, reps):
    """The attention yardstick: SDPA on bf16 caches [B, Hkv, S, D] timed in
    two forms, K/V expanded to the query heads with ``repeat_interleave``
    (outside the timing) and unexpanded with ``enable_gqa=True``; the faster
    is ``library_ms``. q [B, T, H, D], mask [B, 1, T, S] bool."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2)
    expanded = [(k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)) for k, v in kv_sets]
    forms = {"expanded": time_ms(lambda k, v: sdpa(qt, k, v, attn_mask=mask, scale=scale),
                                 expanded, reps),
             "enable_gqa": time_ms(lambda k, v: sdpa(qt, k, v, attn_mask=mask, scale=scale,
                                                    enable_gqa=True), kv_sets, reps)}
    form = min(forms, key=forms.get)
    return {"library_ms": forms[form], "library_form": form,
            "library_expanded_ms": forms["expanded"], "library_gqa_ms": forms["enable_gqa"]}


def phase_parity(peaks):
    """Each kernel against its plain version at the qwen3-4b main-path shapes."""
    import torch

    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.ops import q8_matmul as q8
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    bw, bf16_peak, int8_peak, _ = peaks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ms = lambda b: b / bw * 1e3                             # noqa: E731

    def tcq4_weights(k, n, copies):
        return [(torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                               dtype=torch.uint8),
                 (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                  ).to(torch.bfloat16)) for _ in range(copies)]

    reports = {}

    # -- gx2: decode M = 1 (generate) and M = 4 (a 4-lane served step) ------
    # for every projection the route sends to it (gx_viable: not down at M =
    # 4); two launches bit-equal, and at M = 1 bit-equal to the kernel's
    # order of sums emulated in plain PyTorch (tcq4_matmul_gx_splitk_plain)
    from rrs_tpu_torch.formats.tcq4 import quantize_activations_rrs

    rep = reports["gx2"] = Report("tcq4_matmul_gx2", "rrs_tpu_torch/csrc/tcq4_gx2.cu",
                                  "rrs_tpu/ops/tcq4_matmul.py:1262", "bytes")
    hold_s = 0.0
    for lname, (k, n) in QWEN3_4B_LINEARS.items():
        wbytes = k // 2 * n + k // 32 * n * 2
        ws = tcq4_weights(k, n, n_copies(wbytes))
        wl = [tm.dequantize_w(*w).to(torch.bfloat16) for w in ws[:max(2, n_copies(2 * k * n))]]
        for m in (1, 4):
            if not tm.gx_viable(m, k, n):
                continue
            a = torch.randn((m, k), generator=gen, device=dev)
            got = tm.tcq4_matmul_gx2(a, *ws[0])
            ref = tm.tcq4_matmul_gx2_plain(a, *ws[0])
            err, rel = compare(f"gx2 {lname} M={m}", got, ref, 1e-5)
            t_hold = time.perf_counter()
            if not torch.equal(got, tm.tcq4_matmul_gx2(a, *ws[0])):
                raise AssertionError(f"gx2 {lname} M={m}: two launches differ")
            plan = tm.gx_plan(m, k, n)
            if m == 1 and not torch.equal(got, tm.tcq4_matmul_gx_splitk_plain(
                    *quantize_activations_rrs(a), *ws[0], plan)):
                raise AssertionError(f"gx2 {lname} M={m}: not the kernel order's bits")
            hold_s += time.perf_counter() - t_hold
            a16 = a.to(torch.bfloat16)
            t_bytes = ms(wbytes + m * k * 4 + m * n * 4)
            t_ops = 2 * m * k * n / int8_peak * 1e3
            rep.add({"shape": f"{lname} M={m} K={k} N={n} ({plan.slices} K slices; two launches "
                              f"bit-equal{', the emulated order bit for bit' if m == 1 else ''})",
                     "max_abs_err": err, "rel_err": rel, "tol": 1e-5,
                     "ms": time_ms(tm.tcq4_matmul_gx2, [(a, q, e) for q, e in ws], 40),
                     "plain_ms": time_ms(tm.tcq4_matmul_gx2_plain, [(a, q, e) for q, e in ws],
                                         10),
                     "library_ms": time_ms(torch.matmul, [(a16, w) for w in wl], 40),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
                    headline=(m == 1))
        del ws, wl
    print(f"  gx2 holds beyond the plain version (two launches, the emulated order): "
          f"{hold_s:.2f} s", flush=True)

    # -- tcq4_matmul: the served decode step's M = 4 (the down projection's
    # route; all four held), the down projection at M = 2 and 8 (outside
    # gx_viable), and the prefill buckets M = 16, 64, 512 --------------------
    rep = reports["tcq4"] = Report("tcq4_matmul", "rrs_tpu_torch/csrc/tcq4_matmul.cu",
                                   "rrs_tpu/ops/tcq4_matmul.py:895", "operations")
    for m in (2, 4, 8, 16, 64, 512):
        for lname, (k, n) in QWEN3_4B_LINEARS.items():
            if m in (2, 8) and lname != "down":
                continue
            wbytes = k // 2 * n + k // 32 * n * 2
            ws = tcq4_weights(k, n, n_copies(wbytes))
            a = (torch.randint(-7, 8, (m, k), generator=gen, device=dev).float()
                 * (torch.rand((m, 1), generator=gen, device=dev) + 0.5) / 7.0)
            got = tm.tcq4_matmul(a, *ws[0])
            ref = tm.tcq4_matmul_plain(a, *ws[0])
            err, rel = compare(f"tcq4_matmul {lname} M={m}", got, ref, 1e-3)
            # the library call reads as many bf16 copies as the kernel's, past L2
            wl = [tm.dequantize_w(*w).to(torch.bfloat16) for w in ws[:n_copies(2 * k * n)]]
            a16 = a.to(torch.bfloat16)
            t_bytes = ms(wbytes + m * k * 4 + m * n * 4)
            t_ops = 2 * m * k * n / bf16_peak * 1e3
            rep.add({"shape": f"{lname} M={m} K={k} N={n}", "max_abs_err": err, "rel_err": rel,
                     "tol": 1e-3,
                     "ms": time_ms(tm.tcq4_matmul, [(a, q, e) for q, e in ws], 20),
                     "plain_ms": time_ms(tm.tcq4_matmul_plain, [(a, q, e) for q, e in ws[:2]], 5),
                     "library_ms": time_ms(torch.matmul, [(a16, w) for w in wl], 20),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
                    headline=(m == 512))
            del ws, wl

    # -- q8_matmul: the padded lm_head at M = 1, 4 (4 lanes) and 64 ----------
    rep = reports["q8"] = Report("q8_matmul", "rrs_tpu_torch/csrc/q8_matmul.cu",
                                 "rrs_tpu/ops/q8_matmul.py:48", "bytes")
    k, n = 2560, 153600
    qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    qs_ = torch.rand((k // 32, n), generator=gen, device=dev) * 1e-3
    wl = (qw.float().reshape(k // 32, 32, n) * qs_[:, None]).reshape(k, n).to(torch.bfloat16)
    for m in (1, 4, 64):
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        got = q8.q8_matmul(a, qw, qs_)
        ref = q8.q8_matmul_plain(a, qw, qs_)
        err, rel = compare(f"q8_matmul M={m}", got, ref, 1e-3)
        t_bytes = ms(k * n + k // 32 * n * 4 + m * k * 2 + m * n * 4)
        t_ops = 2 * m * k * n / bf16_peak * 1e3
        rep.add({"shape": f"lm_head M={m} K={k} N={n}", "max_abs_err": err, "rel_err": rel,
                 "tol": 1e-3,
                 "ms": time_ms(q8.q8_matmul, [(a, qw, qs_)], 20),
                 "plain_ms": time_ms(q8.q8_matmul_plain, [(a, qw, qs_)], 3),
                 "library_ms": time_ms(torch.matmul, [(a, wl)], 20),
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
                headline=(m == 1))
    del qw, qs_, wl

    # -- flash_attention: generate's T = 1 and 64 over S = 384, and a served
    # step's 4 lanes over the 4096-slot cache at T = 1 (decode) and T = 1024
    # (a prefill chunk), lane 3 dead; at T > 1 one row is padded ------------
    rep = reports["fa"] = Report("flash_attention", ATTN_SOURCE,
                                 "rrs_tpu/ops/flash_attention.py:343", "bytes")
    h, hkv, d = 32, 8, 128
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    # (T, S, each lane's first position (-1: a dead lane), headline)
    for t, s, starts, headline in ((1, 384, (367,), True), (64, 384, (304,), False),
                                   (1, 4096, (3999, 1500, 299, -1), False),
                                   (1024, 4096, (0, 2048, 3000, -1), False)):
        b = len(starts)
        kv_bytes = 2 * b * hkv * s * d * 2
        caches = [(torch.randn((b, hkv, s, d), generator=gen, device=dev).to(torch.bfloat16),
                   torch.randn((b, hkv, s, d), generator=gen, device=dev).to(torch.bfloat16))
                  for _ in range(n_copies(kv_bytes))]
        q = torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.tensor([[st + i if st >= 0 else -1 for i in range(t)] for st in starts],
                           device=dev, dtype=torch.int32)
        if t > 1:
            pos[min(1, b - 1), -1] = -1                     # one padded row
        got = fa.flash_attention(q, *caches[0], pos, scale)
        ref = fa.attention_ref(q, *caches[0], pos, scale)
        label = f"T={t} B={b} S={s}"
        err, rel = compare(f"flash_attention {label}", got, ref, 8e-3)
        if (pos < 0).any() and got[pos < 0].float().abs().max().item() != 0.0:
            raise AssertionError(f"flash_attention {label}: a padded row must output 0")
        if s == 4096:
            if not torch.equal(got, fa.flash_attention(q, *caches[0], pos, scale)):
                raise AssertionError(f"flash_attention {label}: two launches differ")
            print(f"  flash_attention {label}: two launches bit-equal", flush=True)
        valid = pos[pos >= 0].to(torch.int64)
        pairs = int((valid + 1).sum().item()) * h          # unmasked (row, slot) pairs
        slots = sum(int(row.max().item()) + 1 for row in pos if row.max().item() >= 0)
        t_bytes = ms(2 * hkv * slots * d * 2 + 2 * b * t * h * d * 2 + b * t * 4)
        t_ops = 4 * d * pairs / bf16_peak * 1e3
        mask = (torch.arange(s, device=dev)[None, None, :] <= pos[:, :, None]) \
            & (pos[:, :, None] >= 0)
        reps = 40 if t == 1 else (10 if t <= 64 else 3)
        rep.add({"shape": f"{label} H={h} Hkv={hkv} D={d}" + (" lane 3 dead" if b > 1 else ""),
                 "max_abs_err": err, "rel_err": rel, "tol": 8e-3,
                 "ms": time_ms(lambda kc, vc: fa.flash_attention(q, kc, vc, pos, scale), caches,
                               reps),
                 "plain_ms": time_ms(lambda kc, vc: fa.attention_ref(q, kc, vc, pos, scale),
                                     caches, max(2, reps // 4)),
                 **sdpa_ms(q, caches[:4], mask[:, None], g, scale, reps),
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
                headline=headline)
        del caches, ref
    torch.cuda.empty_cache()
    return reports


# B3 and B6-B8 are one kernel template with a loader per cache codec
ATTN_SOURCE = "rrs_tpu_torch/csrc/attention_sm90.cuh"
# Attention over quantized caches: report key -> (kernel, TPU kernel it
# replaces, codec, source), B6-B8.
KVQ = {"fa_q8": ("flash_attention_q8", "rrs_tpu/ops/flash_attention.py:398", "q8", ATTN_SOURCE),
       "fa_q4hp": ("flash_attention_q4hp", "rrs_tpu/ops/flash_attention.py:519", "q4hp",
                   ATTN_SOURCE),
       "fa_q4": ("flash_attention_q4", "rrs_tpu/ops/flash_attention.py:457", "q4", ATTN_SOURCE)}


def kvq_caches(codec, b, hkv, s, d, gen):
    """Random K and V quantized on the card: (k codes, k scales, v codes, v
    scales) in the codec's layout (``q4`` is halves-packed at any head
    count)."""
    import torch

    from rrs_tpu_torch.runtime import kv_codec

    out = []
    for _ in range(2):
        x = torch.randn((b, hkv, s, d), generator=gen, device="cuda")
        codes, sc = kv_codec.quantize_rows(x, 127.0 if codec == "q8" else 7.0)
        if codec == "q4hp":
            codes = kv_codec.pack_hp(codes)
        elif codec == "q4":
            codes = kv_codec.pack4(codes)
        out += [codes.contiguous(), sc[:, :, None, :].contiguous()]
        del x
    return tuple(out)


def phase_parity_kvq(peaks, reports):
    """B6-B8 against their plain version (dequantize, then attention_ref) at
    the bf16 kernel's qwen3-4b shapes: generate's T = 1 and 64 over a
    1024-slot cache, a served decode step over 4 lanes of 4096 slots at
    3999 / 1500 / 299 with lane 3 dead, and a served prefill chunk of
    T = 1024 from 0 / 2048 / 3000 with lane 3 dead and one padded row;
    timed beside the byte bound of the codes and scales up to each lane's
    position (FLOPs at prefill), the plain version and SDPA over caches
    dequantized to bf16 beforehand (a yardstick the port never calls; the
    faster of its expanded and ``enable_gqa`` forms). Each must give the
    same bits on two launches at the served decode step and the prefill
    chunk (split-S partials merged in a fixed order)."""
    import torch

    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.runtime import kv_codec

    bw, bf16_peak, _, _ = peaks
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    ms = lambda b: b / bw * 1e3                             # noqa: E731
    h, hkv, d = 32, 8, 128
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    for key, (name, replaces, codec, source) in KVQ.items():
        rep = reports[key] = Report(name, source, replaces, "bytes")
        fn = getattr(fa, name)
        code_bytes = d if codec == "q8" else d // 2          # per kv head and slot
        for t, s, starts, headline in ((1, 1024, (1000,), False), (64, 1024, (900,), False),
                                       (1, 4096, (3999, 1500, 299, -1), True),
                                       (1024, 4096, (0, 2048, 3000, -1), False)):
            b = len(starts)
            kv_bytes = 2 * b * hkv * s * (code_bytes + 4)
            caches = [kvq_caches(codec, b, hkv, s, d, gen) for _ in range(n_copies(kv_bytes))]
            q = torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
            pos = torch.tensor([[st + i if st >= 0 else -1 for i in range(t)] for st in starts],
                               device="cuda", dtype=torch.int32)
            if t > 1:
                pos[0, -1] = -1                                 # one padded row
            got = fn(q, *caches[0], pos, scale)
            ref = fa.attention_kvq_ref(q, *caches[0], pos, scale)
            label = f"T={t} B={b} S={s}"
            err, rel = compare(f"{name} {label}", got, ref, 8e-3)
            if (pos < 0).any() and got[pos < 0].float().abs().max().item() != 0.0:
                raise AssertionError(f"{name} {label}: a padded row must output 0")
            if s == 4096:
                if not torch.equal(got, fn(q, *caches[0], pos, scale)):
                    raise AssertionError(f"{name} {label}: two launches differ")
                print(f"  {name} {label}: two launches bit-equal", flush=True)
            valid = pos[pos >= 0].to(torch.int64)
            pairs = int((valid + 1).sum().item()) * h
            slots = sum(int(row.max().item()) + 1 for row in pos if row.max().item() >= 0)
            t_bytes = ms(2 * hkv * slots * (code_bytes + 4) + 2 * b * t * h * d * 2 + b * t * 4)
            t_ops = 4 * d * pairs / bf16_peak * 1e3
            mask = (torch.arange(s, device="cuda")[None, None, :] <= pos[:, :, None]) \
                & (pos[:, :, None] >= 0)
            lib_sets = [(kv_codec.dequantize(kq, ks).to(torch.bfloat16),
                         kv_codec.dequantize(vq, vs).to(torch.bfloat16))
                        for kq, ks, vq, vs in caches[:2]]
            reps = 40 if t == 1 else (10 if t <= 64 else 3)
            rep.add({"shape": f"{label} H={h} Hkv={hkv} D={d}" + (" lane 3 dead" if b > 1 else ""),
                     "max_abs_err": err, "rel_err": rel, "tol": 8e-3,
                     "ms": time_ms(lambda *c: fn(q, *c, pos, scale), caches, reps),
                     "plain_ms": time_ms(lambda *c: fa.attention_kvq_ref(q, *c, pos, scale),
                                         caches, max(2, reps // 4)),
                     **sdpa_ms(q, lib_sets, mask[:, None], g, scale, reps),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
                    headline=headline)
            del caches, lib_sets, ref
    torch.cuda.empty_cache()


def phase_i8p(peaks, reports):
    """B5 at the prefill M of the serving and generate paths (n_lanes x
    bucket: 256 to 4096) for the four qwen3-4b projections: the kernel
    against its plain version (f32 output rel 1e-5; bf16 output, padded M
    >= 1024, 8e-3: one bf16 ulp where the sums round to either side; bit for
    bit where its plan takes one K slice), two launches bit-equal, and
    against the dequant path on the same quantized activations within the
    JAX bound 0.06 * mean|ref| + 0.02 (tests/test_tcq4_matmul.py:278-310),
    in f32; timed at M = 512 and 1024."""
    import torch

    from rrs_tpu_torch.formats.tcq4 import dequantize_activations_rrs
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    bw, bf16_peak, int8_peak, _ = peaks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    ms = lambda b: b / bw * 1e3                             # noqa: E731
    rep = reports["i8p"] = Report("tcq4_matmul_i8p", "rrs_tpu_torch/csrc/tcq4_i8p.cu",
                                  "rrs_tpu/ops/tcq4_matmul.py:1107", "operations")
    rep.entry["library_int_mm_ms"] = 0.0
    for lname, (k, n) in QWEN3_4B_LINEARS.items():
        pbytes = k // 2 * n + k // 32 * n + k // 256 * n * 4
        ws = [(torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
               (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                ).to(torch.bfloat16)) for _ in range(n_copies(pbytes))]
        packs = [tm.pack_i8p(q, e) for q, e in ws]
        for m in (256, 512, 1024, 4096):
            a_q = torch.randint(-7, 8, (m, k), generator=gen, device=dev, dtype=torch.int8)
            a_s = torch.rand((m, k // 256), generator=gen, device=dev) + 0.5
            a_sbi = tm.prep_a_sbi(a_q)
            got = tm.tcq4_matmul_i8p(a_sbi, a_s, *packs[0])
            tol = BF16_OUT_TOL if got.dtype == torch.bfloat16 else 1e-5
            plain = tm.tcq4_matmul_i8p_plain(a_sbi, a_s, *packs[0])
            err, rel = compare(f"i8p {lname} M={m}", got, plain, tol)
            # the slices are summed in a fixed order: two launches give the
            # same bits, and one slice gives the plain version's
            slices = tm.i8p_plan(m, k, n).slices
            if not torch.equal(tm.tcq4_matmul_i8p(a_sbi, a_s, *packs[0]), got):
                raise AssertionError(f"i8p {lname} M={m}: two launches differ")
            if slices == 1 and not torch.equal(got, plain):
                raise AssertionError(f"i8p {lname} M={m}: one K slice, not the plain version's "
                                     f"bits")
            # the requant error, held in f32: both kernels on 512-row slices
            # (their f32-output launches) against the JAX bound
            rows = range(0, m, 512)
            dq = torch.cat([tm.tcq4_matmul(dequantize_activations_rrs(a_q[r:r + 512],
                                                                      a_s[r:r + 512]), *ws[0])
                            for r in rows])
            i8 = torch.cat([tm.tcq4_matmul_i8p(a_sbi[r:r + 512], a_s[r:r + 512], *packs[0])
                            for r in rows])
            dev_dq = (i8 - dq).abs().max().item()
            limit = 0.06 * dq.abs().mean().item() + 0.02
            if dev_dq > limit:
                raise AssertionError(f"i8p {lname} M={m}: {dev_dq:.4f} from the dequant path "
                                     f"> 0.06 * mean|ref| + 0.02 = {limit:.4f}")
            shape = {"shape": f"{lname} M={m} K={k} N={n} ({slices} K slices; two launches "
                              f"bit-equal{', bit-equal to plain' if slices == 1 else ''})",
                     "max_abs_err": err, "rel_err": rel, "tol": tol, "dequant_dev": dev_dq,
                     "dequant_limit": limit}
            if m in (512, 1024):
                out_bytes = m * n * (2 if got.dtype == torch.bfloat16 else 4)
                t_bytes = ms(pbytes + m * k + m * k // 256 * 4 + out_bytes)
                t_ops = 2 * m * k * n / int8_peak * 1e3
                w16 = [tm.dequantize_w(q, e).to(torch.bfloat16) for q, e in ws[:2]]
                w8 = [tm.decode_w8(*pk[:2]).to(torch.int8).t().contiguous().t()
                      for pk in packs[:2]]
                a16 = dequantize_activations_rrs(a_q, a_s).to(torch.bfloat16)
                shape.update(
                    ms=time_ms(lambda pk: tm.tcq4_matmul_i8p(a_sbi, a_s, *pk),
                               [(pk,) for pk in packs], 20),
                    plain_ms=time_ms(lambda pk: tm.tcq4_matmul_i8p_plain(a_sbi, a_s, *pk),
                                     [(pk,) for pk in packs[:2]], 3),
                    library_ms=time_ms(torch.matmul, [(a16, w) for w in w16], 20),
                    library_int_mm_ms=time_ms(torch._int_mm, [(a_sbi, w) for w in w8], 20),
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
                del w16, w8
            rep.add(shape, headline=(m == 512))
        del ws, packs
    torch.cuda.empty_cache()


SMALL_TOL = {"tcq4_matmul_gx2": 1e-5, "tcq4_matmul_gx3": 1e-5, "tcq4_matmul": 1e-3,
             "tcq4_matmul_i8p": 1e-5,
             "q8_matmul": 1e-3, "flash_attention": 8e-3, "flash_attention_q8": 8e-3,
             "flash_attention_q4hp": 8e-3, "flash_attention_q4": 8e-3, "mxfp4_matmul": 1e-3,
             "mxfp4_matmul_experts_rows": 1e-3, "mxfp4_matmul_all_experts": 1e-3,
             "tcq4_matmul_experts_rows": 1e-3, "tcq4_matmul_all_experts": 1e-3}
MXFP4_KERNELS = {"mxfp4_matmul", "mxfp4_matmul_experts_rows", "mxfp4_matmul_all_experts"}
# the kernels of a step over a bf16 cache
BF16_PATH = {"tcq4_matmul_gx2", "tcq4_matmul", "tcq4_matmul_i8p", "q8_matmul",
             "flash_attention"}
# a bf16 output may land one ulp (2^-8 relative) off where the two sums
# round to either side of a bf16 step
BF16_OUT_TOL = 8e-3


@contextlib.contextmanager
def held_to_plain(label: str, expect):
    """While open, every launch of a kernel on the model's path also runs
    its plain version on the very inputs it got (teacher forcing) and must
    agree within SMALL_TOL (BF16_OUT_TOL where the kernel stores bf16).
    Yields {kernel: (max rel err, set of shapes seen)}; on leaving, every
    kernel in ``expect`` must have been launched."""
    import torch

    from rrs_tpu_torch.models import llama, moe
    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.ops import mxfp4_matmul as mx
    from rrs_tpu_torch.ops import q8_matmul as q8
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    hooked = [(moe, "mxfp4_matmul", mx.mxfp4_matmul_plain),
              (moe, "mxfp4_matmul_experts_rows", mx.mxfp4_matmul_experts_rows_plain),
              (moe, "mxfp4_matmul_all_experts", mx.mxfp4_matmul_all_experts_plain),
              (moe, "tcq4_matmul_experts_rows", tm.tcq4_matmul_experts_rows_plain),
              (moe, "tcq4_matmul_all_experts", tm.tcq4_matmul_all_experts_plain),
              (tm, "tcq4_matmul_gx2", tm.tcq4_matmul_gx2_plain),
              (tm, "tcq4_matmul_gx3", tm.tcq4_matmul_gx3_plain),
              (tm, "tcq4_matmul", tm.tcq4_matmul_plain),
              (tm, "tcq4_matmul_i8p", tm.tcq4_matmul_i8p_plain),
              (q8, "q8_matmul", q8.q8_matmul_plain),
              (llama, "flash_attention", fa.attention_ref),
              (llama, "flash_attention_q8", fa.attention_kvq_ref),
              (llama, "flash_attention_q4hp", fa.attention_kvq_ref),
              (llama, "flash_attention_q4", fa.attention_kvq_ref)]
    originals = [getattr(mod, name) for mod, name, _ in hooked]
    seen: dict = {}
    lock = threading.Lock()             # the shards of a mesh launch from threads

    def checked(name, kernel, plain):
        def run(*args, **kwargs):
            out = kernel(*args, **kwargs)
            ref = plain(*args, **kwargs)
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            tol = BF16_OUT_TOL if out.dtype == torch.bfloat16 else SMALL_TOL[name]
            # a matmul's (M, K, N); attention's (B, T, S)
            shape = tuple(args[0].shape) + (out.shape[-1],) \
                if not name.startswith("flash_attention") else \
                tuple(args[0].shape[:2]) + (args[1].shape[2],)
            if not torch.isfinite(out.float()).all() or rel > tol:
                raise AssertionError(f"{label}: {name} {shape} disagrees with its plain "
                                     f"version (rel {rel:.3e} > {tol:.0e})")
            with lock:
                worst, shapes = seen.get(name, (0.0, set()))
                seen[name] = (max(worst, rel), shapes | {shape})
            return out
        return run

    try:
        for (mod, name, plain), orig in zip(hooked, originals):
            setattr(mod, name, checked(name, orig, plain))
        yield seen
    finally:
        for (mod, name, _), orig in zip(hooked, originals):
            setattr(mod, name, orig)
    if set(expect) - set(seen):
        raise AssertionError(f"{label}: kernels not reached: {set(expect) - set(seen)}")


def phase_variants():
    """Each kernel's other instantiations against its plain version: gx2 at
    M = 2 and 8 and a ragged N, the prefill kernel with a bf16 output (padded
    M >= 1024) and a ragged N, and attention over bf16, q8, q4 head-pair and
    q4 halves caches at head dims 64 and 256, without grouping, over two
    lanes with one padded, and with each option (window over a ring cache,
    softcap, ALiBi, sinks), each at T = 9 and T = 1 (the prefill and split-S
    decode bodies of each codec)."""
    import torch

    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    done = []

    def weights(k, n):
        return (torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
                (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                 ).to(torch.bfloat16))

    for m, k, n in ((2, 2560, 6144), (8, 2560, 2560), (1, 512, 200)):
        qs, eff = weights(k, n)
        a = torch.randn((m, k), generator=gen, device=dev)
        compare(f"gx2 M={m} K={k} N={n}", tm.tcq4_matmul_gx2(a, qs, eff),
                tm.tcq4_matmul_gx2_plain(a, qs, eff), SMALL_TOL["tcq4_matmul_gx2"])
        done.append(f"gx2 M={m} N={n}")
    for m, k, n in ((1024, 2560, 2560), (40, 512, 200)):
        qs, eff = weights(k, n)
        a = torch.randn((m, k), generator=gen, device=dev)
        got = tm.tcq4_matmul(a, qs, eff)
        out_bf16 = m >= 1024
        if got.dtype != (torch.bfloat16 if out_bf16 else torch.float32):
            raise AssertionError(f"tcq4_matmul M={m}: output dtype {got.dtype}")
        compare(f"tcq4_matmul M={m} N={n}", got, tm.tcq4_matmul_plain(a, qs, eff),
                BF16_OUT_TOL if out_bf16 else SMALL_TOL["tcq4_matmul"])
        done.append(f"tcq4_matmul M={m} N={n} {str(got.dtype)[6:]}")
    cases = {"D=64": dict(d=64), "D=256": dict(d=256), "G=1": dict(h=8, hkv=8),
             "B=2 dead lane": dict(b=2), "window ring": dict(s=64, window=24, start=100),
             "softcap": dict(softcap=20.0), "alibi": dict(alibi=8.0), "sinks": dict(sinks=True)}
    for codec in ("bf16", "q8", "q4hp", "q4"):
        for (name, c), t in itertools.product(cases.items(), (9, 1)):
            b, h, hkv, d, s = c.get("b", 1), c.get("h", 8), c.get("hkv", 2), c.get("d", 128), \
                c.get("s", 160)
            start = c.get("start", 60)
            q = torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
            if codec == "bf16":
                caches = tuple(torch.randn((b, hkv, s, d), generator=gen, device=dev).to(
                    torch.bfloat16) for _ in range(2))
                kernel, plain = fa.flash_attention, fa.attention_ref
            else:
                caches = kvq_caches(codec, b, hkv, s, d, gen)
                kernel, plain = getattr(fa, KVQ["fa_" + codec][0]), fa.attention_kvq_ref
            pos = torch.arange(start, start + t, device=dev, dtype=torch.int32).repeat(b, 1)
            if t > 1:
                pos[0, -2:] = -1                            # two padded rows
            if b > 1:
                pos[1] = -1                                 # a lane with no token
            kw = dict(softcap=c.get("softcap", 0.0), window=c.get("window", 0),
                      alibi=c.get("alibi", 0.0))
            if c.get("sinks"):
                kw["sinks"] = torch.randn((h,), generator=gen, device=dev)
            scale = 1.0 / math.sqrt(d)
            got = kernel(q, *caches, pos, scale, **kw)
            compare(f"{kernel.__name__} {name} T={t}", got,
                    plain(q, *caches, pos, scale, **kw), 8e-3)
            if (pos < 0).any() and got[pos < 0].float().abs().max().item() != 0.0:
                raise AssertionError(f"{kernel.__name__} {name} T={t}: a padded row must "
                                     f"output 0")
            done.append(f"{codec} {name} T={t}")
    print(f"  variants agree with their plain versions: {', '.join(done)}", flush=True)


# Card-vs-CPU limit on the dense 2-layer model's logits (relative L2). bf16
# rounding alone stays far below it; on the CPU, storing K/V one slot late
# moves these logits by >= 0.22, dropping RoPE by >= 0.66 and halving the FFN
# output by >= 0.47.
GLUE_TOL = 0.05


def small_cfg():
    """Phase 3's 2-layer model: qwen3 at E = 1024, 16 / 8 heads x 128."""
    from rrs_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="qwen3", n_layers=2, n_embd=1024, n_heads=16, n_kv_heads=8,
                       head_dim=128, n_ff=3072, vocab_size=4096, context_length=4096,
                       rope_theta=1e6, qk_norm=True)


def phase_small_reference(reports):
    """A 2-layer model (E=1024, 16/8 heads x 128) through prefill and one
    decode step, on the card and on the CPU.

    With W4A4 weights every kernel launch is checked against its plain
    version on the very inputs it got (teacher forcing). Their end-to-end
    logits are only reported: the int4 activation quantizer turns last-bit
    differences into code flips, and on the CPU alone scaling rms_norm's
    input by (1 + 2^-20) moves them by a relative L2 of 0.18-0.29 and can
    change the argmax. The glue is held where no int4 step amplifies
    rounding: the same config with dense bf16 weights must give the CPU's
    logits within GLUE_TOL, and the W4A4 glue (rotation with a gather,
    activation quant) must give the CPU's values op by op.

    The dense model also runs over q8 and q4 (head-pair) KV caches: q8 is
    held within GLUE_TOL, q4 only reported (its int4 codes flip on ulp
    differences of K and V, as W4A4 codes do). Then the B8 path: a 2-layer
    model with 3 kv heads and a q4 cache, which takes the halves layout, runs
    ``generate`` on the card with every B8 launch held to its plain
    version, its launches counted from 0."""
    import torch

    from rrs_tpu_torch.formats.tcq4 import quantize_activations_rrs
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.linear import rotate_activations
    from rrs_tpu_torch.runtime.context import InferenceContext

    gen = torch.Generator().manual_seed(2)
    x = torch.randn((64, 2560), generator=gen).to(torch.bfloat16)
    gather = torch.cat([torch.randperm(256, generator=gen) for _ in range(10)])
    rot = rotate_activations(x.cuda(), gather.cuda())
    rot_ref = rotate_activations(x, gather)
    rel = ((rot.cpu() - rot_ref).abs().max() / rot_ref.abs().max()).item()
    if rel > 1e-6:
        raise AssertionError(f"rotation on the card vs the CPU: rel {rel:.3e} > 1e-6")
    (a_q, a_s), (r_q, r_s) = quantize_activations_rrs(rot), quantize_activations_rrs(rot.cpu())
    if not (torch.equal(a_q.cpu(), r_q) and torch.equal(a_s.cpu(), r_s)):
        raise AssertionError("activation quant on the card differs from the CPU's")
    print(f"  W4A4 glue, card vs CPU: rotation rel {rel:.2e} <= 1e-6, "
          "activation quant bit-exact", flush=True)

    cfg = small_cfg()
    dense = llama.random_weights(cfg, seed=1, device="cpu")
    models = {"W4A4": (llama.fabricated_tcq4_weights(cfg, seed=1, device="cpu"), "none"),
              "dense": (dense, "none"), "dense q8 KV": (dense, "q8"),
              "dense q4 KV": (dense, "q4")}
    prompt = list(range(7, 47))                              # 40 tokens -> bucket 64
    logits = {}
    # M = 64 < 256: the prefill takes tcq4_matmul, not i8p
    expect = (BF16_PATH - {"tcq4_matmul_i8p"}) | {"flash_attention_q8", "flash_attention_q4hp"}
    with held_to_plain("small model", expect) as seen:
        for kind, (w_cpu, quant) in models.items():
            for dev, w in (("cuda", llama.to_device(w_cpu, "cuda")), ("cpu", w_cpu)):
                ctx = InferenceContext(cfg, w, max_seq=256, kv_quant=quant, device=dev)
                seq = ctx.new_sequence()
                pre = ctx.prefill(seq, prompt)[-1]
                dec = ctx.decode({seq: 11})[seq]
                logits[kind, dev] = (pre.float().cpu(), dec.float().cpu())
    print("  small model, each launch vs its plain version on the same inputs (max rel): "
          + ", ".join(f"{k} {v[0]:.2e} <= {SMALL_TOL[k]:.0e}" for k, v in seen.items()),
          flush=True)
    for kind in models:
        for i, stage in enumerate(("prefill", "decode")):
            got, ref = logits[kind, "cuda"][i], logits[kind, "cpu"][i]
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"small {kind} model {stage}: bad logits {tuple(got.shape)}")
            rel = ((got - ref).norm() / ref.norm()).item()
            held = kind in ("dense", "dense q8 KV")
            print(f"  small {kind} model {stage} end to end, card vs CPU: rel L2 {rel:.4f}"
                  + (f" <= {GLUE_TOL}" if held else " (reported)")
                  + f", argmax {int(got.argmax())} vs {int(ref.argmax())}", flush=True)
            if held and rel > GLUE_TOL:
                raise AssertionError(f"small {kind} model {stage}: the card's logits differ "
                                     f"from the CPU's by rel L2 {rel:.4f} > {GLUE_TOL}")
    phase_halves_path(reports)


def phase_halves_path(reports):
    """The path that runs B8: a 2-layer model (E=1024, 12 heads on 3 kv heads
    x 128, dense weights) with a q4 cache, whose odd kv-head count takes the
    halves layout. ``generate`` (a 40-token prompt, 8 greedy tokens) on the
    card with its launch counts set to 0 before and read after, every B8
    launch held to its plain version on its inputs; the tokens are reported
    beside the CPU's."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg = ModelConfig(arch="qwen3", n_layers=2, n_embd=1024, n_heads=12, n_kv_heads=3,
                      head_dim=128, n_ff=3072, vocab_size=4096, context_length=4096,
                      rope_theta=1e6, qk_norm=True)
    w_cpu = llama.random_weights(cfg, seed=3, device="cpu")
    prompt = list(range(100, 140))
    cpu = InferenceContext(cfg, w_cpu, max_seq=256, kv_quant="q4", device="cpu")
    ref = cpu.generate(prompt, 8)
    ctx = InferenceContext(cfg, llama.to_device(w_cpu, "cuda"), max_seq=256, kv_quant="q4")
    if tuple(ctx.kv.k[0][0].shape) != (1, 3, 256, 64):
        raise AssertionError(f"odd-Hkv q4 cache: {tuple(ctx.kv.k[0][0].shape)}, not halves")
    torch.cuda.synchronize()
    kernels.reset_launches()
    with held_to_plain("halves path", {"flash_attention_q4"}) as seen:
        out = ctx.generate(prompt, 8)
        torch.cuda.synchronize()
    n = kernels.LAUNCHES["flash_attention_q4"]
    if len(out) != 8 or n == 0:
        raise AssertionError(f"halves path: {len(out)} tokens, {n} B8 launches")
    reports["fa_q4"].entry["launches"] = n
    print(f"  halves path (3 kv heads, q4 KV, generate 40 + 8): {n} flash_attention_q4 "
          f"launches, each within {SMALL_TOL['flash_attention_q4']:.0e} of its plain version "
          f"(max rel {seen['flash_attention_q4'][0]:.2e}; shapes "
          f"{sorted(seen['flash_attention_q4'][1])}); greedy tokens {out} vs the CPU's {ref} "
          f"(reported)", flush=True)


def phase_main_path(reports):
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import PRESETS
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.runtime.sampler import SamplerParams

    cfg = PRESETS["qwen3-4b"]
    t0 = time.perf_counter()
    weights = llama.fabricated_tcq4_weights(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  fabricated qwen3-4b weights in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in (5, 40, 300)]

    warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    warm.generate(prompts[0], 2)                              # first-call set-up
    del warm
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    outs = [ctx.generate(p, 32) for p in prompts]
    outs.append(ctx.generate(prompts[1], 32, SamplerParams(temperature=0.8, top_k=40, seed=0)))
    torch.cuda.synchronize()
    launches = {key: kernels.LAUNCHES[name] for key, name in COUNTERS.items()}
    for out in outs:
        if len(out) != 32 or not all(0 <= tok < cfg.vocab_size for tok in out):
            raise AssertionError(f"generate returned {len(out)} tokens: {out}")
    perf = ctx.perf()
    peak = torch.cuda.max_memory_allocated() / GB
    print(f"  requests: prompts 5/40/300 (+40 sampled) x 32 new tokens; "
          f"prefill {perf['n_p_eval']} tok @ {perf['pp_tok_per_s']:.1f} tok/s, "
          f"decode {perf['n_eval']} tok @ {perf['tg_tok_per_s']:.2f} tok/s "
          f"({perf['t_eval_ms'] / max(perf['n_eval'], 1):.3f} ms/token), "
          f"peak memory {peak:.2f} GB", flush=True)
    print(f"  greedy tokens (first request): {outs[0][:8]}...", flush=True)
    print(f"  launches on the main path: {launches}", flush=True)
    for key, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {key} was never launched on the main path")
        reports[key].entry["launches"] = n
    del ctx
    return cfg, weights


COUNTERS = {"gx2": "tcq4_matmul_gx2", "tcq4": "tcq4_matmul", "i8p": "tcq4_matmul_i8p",
            "q8": "q8_matmul", "fa": "flash_attention"}
# the gx kernels share one template, gx_sm90_kernel<prologue, eff type, row tiles>:
# 0 gx, 1 gx2, 2 gx3, 3 a8
GX_PROLOGUES = {"0": "tcq4_matmul_gx", "1": "tcq4_matmul_gx2", "2": "tcq4_matmul_gx3",
                "3": "tcq4_matmul_a8"}
# B2, B4, B11 and B18 share the two bodies of gemm_sm90.cuh,
# splitk_kernel<Loader, MT> and gemm_kernel<Loader, BM, OutT>; the loader
# (Q8<...>, TCQ4<...>, MXFP4<...> or PB) names the kernel
SM90_LOADERS = {"Q8": "q8_matmul", "TCQ4": "tcq4_matmul", "MXFP4": "mxfp4_matmul",
                "PB": "tcq4_matmul_pb"}
# B10 and B13 run the prefill body on its expert grid, experts_kernel<Loader,
# BM> (B19's launches, on the TCQ4 loader too, count as B10's)
SM90_EXPERTS = {"TCQ4": "tcq4_matmul_all_experts", "MXFP4": "mxfp4_matmul_all_experts"}
# B9 and B12 run the decode body with the selected rows on its grid,
# rows_kernel<Loader, MT>
SM90_ROWS = {"TCQ4": "tcq4_matmul_experts_rows", "MXFP4": "mxfp4_matmul_experts_rows"}
# B3 and B6-B8 share attention_kernel<D, codec, decode body>, with the codec
# ids of csrc/attention_sm90.cuh
ATTN_CODECS = {"0": "flash_attention_q8", "1": "flash_attention_q4hp", "2": "flash_attention_q4",
               "3": "flash_attention"}
KERNEL_NAMES = {"i8p_sm90_kernel": "tcq4_matmul_i8p", "rotate_kernel": "tcq4_matmul_fused"}


def phase_generate_kvq(cfg, weights, reports):
    """``generate`` at full qwen3-4b width over q8 and then q4 (head-pair) KV
    caches: prompts of 40 and 300 tokens, 32 greedy tokens each, the launch
    counts set to 0 before and read after each run; prefill and decode tok/s,
    the cache's resident bytes and the peak memory."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.runtime.context import InferenceContext

    rng = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in (40, 300)]
    for quant, key in (("q8", "fa_q8"), ("q4", "fa_q4hp")):
        name = KVQ[key][0]
        warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024, kv_quant=quant)
        warm.generate(prompts[0][:5], 2)                      # first-call set-up
        del warm
        ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024, kv_quant=quant)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        outs = [ctx.generate(p, 32) for p in prompts]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        for out in outs:
            if len(out) != 32 or not all(0 <= tok < cfg.vocab_size for tok in out):
                raise AssertionError(f"generate {quant} KV returned {len(out)} tokens: {out}")
        if launches[name] == 0 or launches["flash_attention"] != 0:
            raise AssertionError(f"generate {quant} KV: {name} launched {launches[name]} times, "
                                 f"bf16 attention {launches['flash_attention']}")
        reports[key].entry["launches"] = launches[name]
        perf = ctx.perf()
        print(f"  generate, {quant} KV: prompts 40/300 x 32 new tokens; prefill "
              f"{perf['n_p_eval']} tok @ {perf['pp_tok_per_s']:.1f} tok/s, decode "
              f"{perf['n_eval']} tok @ {perf['tg_tok_per_s']:.2f} tok/s "
              f"({perf['t_eval_ms'] / max(perf['n_eval'], 1):.3f} ms/token); KV resident "
              f"{ctx.kv.nbytes() / GB:.3f} GB (S=1024), peak memory "
              f"{torch.cuda.max_memory_allocated() / GB:.2f} GB; greedy tokens {outs[0][:8]}...; "
              f"launches {launches}", flush=True)
        del ctx


def host_top(prof, steps: int, n: int = 8) -> str:
    """The host ops with the most self CPU time, in ms per step, with their
    calls per step (CUDA runtime calls included: a synchronizing call shows
    here as its own row)."""
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:n]
    return ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / steps:.2f} "
                     f"(x{e.count / steps:.0f})" for e in rows)


# decode steps read under torch.profiler (its reading took 16-34 s for 8 steps)
PROFILE_STEPS = 2


def profile_decode(ctx, prompt, steps: int = 4, label: str = "qwen3-4b", prefill=None):
    """Where a decode step's time goes at full width: the wall time of
    ``steps`` eager decode steps, then torch.profiler over PROFILE_STEPS more
    (the profiler's reading costs seconds per step on the host). Prints the
    wall time per step, the device time per step (sum of kernel durations;
    one stream, so they do not overlap), the device's idle share, the kernels
    launched per step, and the device time of the port's kernels and of the
    rest. ``prefill(seq)``, where given, fills the new sequence in place of
    ``ctx.prefill(seq, prompt)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t_prof = time.perf_counter()
    seq = ctx.new_sequence()
    try:
        if prefill is None:
            ctx.prefill(seq, prompt)
        else:
            prefill(seq)
        for tok in (11, 12):                                  # warm-up steps
            ctx.decode({seq: tok})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            ctx.decode({seq: 13 + i})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(PROFILE_STEPS):
                ctx.decode({seq: 13 + steps + i})
            torch.cuda.synchronize()
    finally:
        ctx.kv.seq_rm(seq)
    kernels, by_name = device_ms_by_kernel(prof)
    if not kernels:
        print("  decode profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    n = PROFILE_STEPS
    dev_ms = sum(by_name.values()) / n
    split = ", ".join(f"{k} {v / n:.3f}" for k, v in sorted(by_name.items(),
                                                           key=lambda kv: -kv[1]))
    print(f"  decode profile ({steps} steps timed, {n} profiled, {label}, S={ctx.kv.max_seq}): "
          f"wall {wall_ms:.3f} ms/step, device {dev_ms:.3f} ms/step, idle share "
          f"{1 - dev_ms / wall_ms:.3f}, {len(kernels) / n:.0f} kernels/step; "
          f"device ms/step by kernel: {split}", flush=True)
    print(f"  decode profile, host ms/step by op: {host_top(prof, n)} "
          f"({time.perf_counter() - t_prof:.1f} s with the profiler's reading)", flush=True)
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "idle": 1 - dev_ms / wall_ms,
            "kernels": len(kernels) / n, "by_kernel": {k: v / n for k, v in by_name.items()}}


def device_ms_by_kernel(prof):
    """The device events of a torch.profiler run and their ms summed by port
    kernel (kernel_label)."""
    import torch

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        short = kernel_label(e.name)
        by_name[short] = by_name.get(short, 0.0) + e.time_range.elapsed_us() / 1e3
    return kernels, by_name


def profile_prefill(ctx, lengths, label: str, focus: str) -> dict:
    """Where a served prefill step's time goes: ``prefill_multi`` over fresh
    sequences of ``lengths`` tokens (one lane each), once to warm up, once
    on the host clock and once under torch.profiler. Prints the wall and
    device ms of the step, the idle share, and the device ms by kernel with
    ``focus`` (the kernel whose share is asked) first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kv = ctx.kv
    for seq in [s for s in kv.seq_ids if s is not None]:
        kv.seq_rm(seq)
    rng = torch.Generator().manual_seed(23)

    def step():
        seqs = [ctx.new_sequence() for _ in lengths]
        ctx.prefill_multi({seq: torch.randint(2, ctx.cfg.vocab_size, (n,),
                                              generator=rng).tolist()
                           for seq, n in zip(seqs, lengths)})
        torch.cuda.synchronize()
        for seq in seqs:
            kv.seq_rm(seq)

    step()
    t0 = time.perf_counter()
    step()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    kernels, by_name = device_ms_by_kernel(prof)
    if not kernels:
        print(f"  {label} prefill profile: the profiler recorded no device time (not measured)",
              flush=True)
        return {}
    dev_ms = sum(by_name.values())
    split = ", ".join(f"{k} {v:.3f}" for k, v in sorted(
        by_name.items(), key=lambda kv_: (kv_[0] != focus, -kv_[1])))
    print(f"  {label} prefill profile (one prefill_multi step, chunks {list(lengths)}): wall "
          f"{wall_ms:.2f} ms, device {dev_ms:.2f} ms, idle share {1 - dev_ms / wall_ms:.3f}, "
          f"{len(kernels)} kernels; {focus} {by_name.get(focus, 0.0):.3f} ms = "
          f"{by_name.get(focus, 0.0) / dev_ms:.3f} of the device time; device ms by kernel: "
          f"{split}", flush=True)
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "by_kernel": by_name}


def kernel_label(name: str) -> str:
    """The port kernel a profiler event belongs to, by its CUDA kernel name."""
    import re

    m = re.search(r"gx_sm90_kernel<[^,>]*?(\d)\s*,", name)
    if m:
        return GX_PROLOGUES[m.group(1)]
    m = re.search(r"sm90::(?:splitk|gemm)_kernel<[^<]*?\b(Q8|TCQ4|MXFP4|PB)\b", name)
    if m:
        return SM90_LOADERS[m.group(1)]
    m = re.search(r"sm90::experts_kernel<[^<]*?\b(TCQ4|MXFP4)<", name)
    if m:
        return SM90_EXPERTS[m.group(1)]
    m = re.search(r"sm90::rows_kernel<[^<]*?\b(TCQ4|MXFP4)<", name)
    if m:
        return SM90_ROWS[m.group(1)]
    m = re.search(r"attention_kernel<\d+, (\d), (true|false)>", name)
    if m:
        return f"{ATTN_CODECS[m.group(1)]} ({'decode' if m.group(2) == 'true' else 'prefill'})"
    return next((v for k, v in KERNEL_NAMES.items() if k in name), "other")


def synthetic_vocab(n: int, fim: bool = False):
    """The char-level gpt2 vocabulary of tests/test_server.py at the model's
    width: token i is a printable char, or <tok{i}> past U+02FF. ``fim``:
    the last three ids are the fill-in-the-middle tokens."""
    from rrs_tpu_torch.models.vocab import Vocab

    toks = [chr(33 + i) if 33 + i < 0x2FF else f"<tok{i}>" for i in range(n)]
    ids = dict(fim_pre_id=n - 3, fim_suf_id=n - 2, fim_mid_id=n - 1) if fim else {}
    return Vocab(model="gpt2", tokens=toks, scores=None, token_types=[1] * n, merges=[],
                 pre="gpt-2", bos_id=0, eos_id=1, add_bos=False, **ids)


def _http(port, method, path, body=None, timeout=900):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _union_seconds(intervals) -> float:
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


SERVE_LENGTHS = (40, 300, 1000, 2000)       # prompt tokens, two requests each
SERVE_NEW = 64
# new tokens a gpt-oss-20b / Qwen3-30B-A3B generate request
MOE_NEW = 32
# tokens of each speculative / lookup run of phase 10 (lookup twice as many)
SPEC_NEW = 24


def phase_serving(cfg, weights, reports):
    """The server in-process at qwen3-4b width: ``Engine`` over a 4-lane,
    4096-token context, ``ServerState`` with a synthetic vocabulary, and
    ``ThreadingHTTPServer`` on a free port, answering eleven concurrent
    requests and then one short one alone (its 16-token prefill bucket
    reaches the dequant kernel). Every response must be 200 and finish by
    length or stop with the right token count; /metrics and /slots must
    answer; every kernel and the device decode runs must be launched."""
    import torch
    from http.server import ThreadingHTTPServer

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.serving.engine import Engine
    from rrs_tpu_torch.serving.server import ServerState, make_handler

    ctx = InferenceContext(cfg, weights, n_lanes=4, max_seq=4096)
    engine = Engine(ctx)
    state = ServerState(cfg, synthetic_vocab(cfg.vocab_size), engine, {}, "qwen3-4b-fabricated")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    rng = torch.Generator().manual_seed(7)
    ids = lambda n: torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist()  # noqa: E731
    jobs = []
    for i, n in enumerate(SERVE_LENGTHS * 2):
        body = {"prompt": ids(n), "max_tokens": SERVE_NEW, "seed": i}
        if i < len(SERVE_LENGTHS):
            body["temperature"] = 0.0          # greedy; the rest take the server defaults
        jobs.append((f"completion {n} {'greedy' if i < 4 else 'sampled'}", "/v1/completions", body))
    jobs.append(("penalties", "/v1/completions", {"prompt": ids(120), "max_tokens": SERVE_NEW,
                                                  "repeat_penalty": 1.1,
                                                  "frequency_penalty": 0.5}))
    jobs.append(("logprobs 5", "/v1/completions", {"prompt": ids(60), "max_tokens": 32,
                                                   "temperature": 0.0, "logprobs": 5}))
    jobs.append(("chat stream", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Say something about GPUs."}],
        "max_tokens": 48, "stream": True}))
    results: dict = {}

    def run(job):
        name, path, body = job
        t0 = time.perf_counter()
        status, data = _http(port, "POST", path, body)
        results[name] = (status, data, t0, time.perf_counter(), body)

    runs0 = engine.n_decode_runs
    engine.start()
    server_thread.start()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t_start = time.perf_counter()
        threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in threads):
            raise AssertionError("serving: a request did not finish within 900 s")
        run(("short alone", "/v1/completions", {"prompt": ids(10), "max_tokens": 8,
                                                 "temperature": 0.0}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = {key: kernels.LAUNCHES[name] for key, name in COUNTERS.items()}
        peak = torch.cuda.max_memory_allocated() / GB
        m_status, metrics = _http(port, "GET", "/metrics")
        s_status, slots = _http(port, "GET", "/slots")
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    if engine._thread.is_alive():
        raise AssertionError("serving: the engine thread did not stop")
    if m_status != 200 or b"llamacpp:decode_runs_total" not in metrics or s_status != 200 \
            or len(json.loads(slots)) != 4:
        raise AssertionError(f"serving: /metrics {m_status}, /slots {s_status}")

    decode_spans, n_decode = [], 0
    for name, (status, data, t0, t1, body) in results.items():
        if status != 200:
            raise AssertionError(f"serving: {name} answered {status}: {data[:300]!r}")
        max_new = body["max_tokens"]
        if body.get("stream"):
            chunks = [json.loads(line[6:]) for line in data.decode().split("\n")
                      if line.startswith("data: {")]
            if not data.rstrip().endswith(b"data: [DONE]") or not chunks:
                raise AssertionError(f"serving: {name} stream did not end with [DONE]")
            reason = chunks[-1]["choices"][0]["finish_reason"]
            print(f"  {name}: {len(chunks) - 1} text chunks, finish {reason}, "
                  f"{(t1 - t0):.2f} s", flush=True)
        else:
            out = json.loads(data)
            reason = out["choices"][0]["finish_reason"]
            n_out = out["usage"]["completion_tokens"]
            if (reason == "length") != (n_out == max_new) or n_out > max_new:
                raise AssertionError(f"serving: {name} finished by {reason} with {n_out} "
                                     f"of {max_new} tokens")
            if "logprobs" in body:
                # top_logprobs maps decoded text to logprob, so two of the 5
                # alternatives that decode alike share one key
                lp = out["choices"][0]["logprobs"]
                if len(lp["token_logprobs"]) != n_out or not all(
                        t and all(v <= 0 for v in t.values()) for t in lp["top_logprobs"]):
                    raise AssertionError(f"serving: {name}: logprobs do not match the tokens")
            tm = out["timings"]
            start = t0 + tm["prompt_ms"] / 1e3
            decode_spans.append((start, start + tm["predicted_ms"] / 1e3))
            n_decode += max(n_out - 1, 0)
            print(f"  {name}: prompt {len(body['prompt'])} tok, {n_out} tokens ({reason}), "
                  f"time to first token {tm['prompt_ms']:.1f} ms, decode "
                  f"{(n_out - 1) / max(tm['predicted_ms'] / 1e3, 1e-9):.2f} tok/s", flush=True)
        if reason not in ("length", "stop"):
            raise AssertionError(f"serving: {name} finished with {reason!r}")
    runs = engine.n_decode_runs - runs0
    busy = _union_seconds(decode_spans)
    print(f"  served {len(results)} requests in {wall:.1f} s; decode tok/s summed over the "
          f"4 slots {n_decode / busy:.2f} ({n_decode} tokens over {busy:.1f} s with a slot "
          f"decoding); {runs} device decode runs; peak memory {peak:.2f} GB", flush=True)
    print(f"  launches on the serving path: {launches}", flush=True)
    if runs == 0:
        raise AssertionError("serving: no device decode run was launched")
    for key, n in launches.items():
        if n == 0:
            raise AssertionError(f"serving: kernel {key} was never launched")
        reports[key].entry["launches_serve"] = n
    return ctx


def phase_served_steps_held(ctx):
    """A served prefill step and a served decode step at qwen3-4b width on
    the 4-lane, 4096-slot context, every kernel launch held to its plain
    version on the very inputs it got: three sequences' chunks of 1000, 700
    and 40 tokens in one ``prefill_multi`` step (T = 1024: i8p at M = 4096,
    lane 3 dead), then one decode step of those three lanes (M = 4: gx2,
    and tcq4_matmul for the down projection)."""
    import torch

    kv = ctx.kv
    for seq in [s for s in kv.seq_ids if s is not None]:
        kv.seq_rm(seq)
    rng = torch.Generator().manual_seed(5)
    seqs = [ctx.new_sequence() for _ in range(3)]
    chunks = {seq: torch.randint(2, ctx.cfg.vocab_size, (n,), generator=rng).tolist()
              for seq, n in zip(seqs, (1000, 700, 40))}
    t0 = time.perf_counter()
    with held_to_plain("served steps", BF16_PATH) as seen:
        last = ctx.prefill_multi(chunks)
        out = ctx.decode({seq: int(last[seq].argmax()) for seq in seqs})
        torch.cuda.synchronize()
    for seq in seqs:
        if not torch.isfinite(out[seq]).all():
            raise AssertionError(f"served steps: non-finite decode logits for seq {seq}")
        kv.seq_rm(seq)
    for name, (worst, shapes) in seen.items():
        tol = SMALL_TOL[name] if name != "tcq4_matmul_i8p" else BF16_OUT_TOL
        print(f"  served steps, {name}: every launch within {tol:.0e} of its plain version "
              f"(max rel {worst:.2e}); shapes {sorted(shapes)}", flush=True)
    print(f"  served prefill + decode step held to the plain versions in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the same chunks' shape unheld, under the profiler: B5's share of the step
    profile_prefill(ctx, (1000, 700, 40), "qwen3-4b served", "tcq4_matmul_i8p")


def phase_decode_run_check(ctx):
    """One greedy device decode run of DECODE_RUN_STEPS steps on the 4-lane
    context, then the same tokens fed through ctx.decode one step at a
    time from the same start lengths: both use the same kernels at the same
    M on the same card, so only a bookkeeping error can make the tokens
    differ."""
    import torch

    from rrs_tpu_torch.runtime.sampler import SamplerParams, topk_candidates

    kv = ctx.kv
    seqs, first, lengths = prefill_four(ctx)
    n = ctx.DECODE_RUN_STEPS
    greedy = SamplerParams(temperature=0.0)
    toks, _ = ctx.decode_run(first, {s: torch.Generator(device=ctx.device).manual_seed(s)
                                     for s in seqs}, {s: greedy for s in seqs}, n)
    for seq in seqs:
        kv.seq_rm(seq, p0=lengths[seq])
    feed = dict(first)
    t0 = time.perf_counter()
    for i in range(n):
        out = ctx.decode(feed)
        top = topk_candidates(torch.stack([out[s] for s in seqs]))[1][:, 0].tolist()
        for seq, t in zip(seqs, top):
            if t != int(toks[seq][i]):
                raise AssertionError(f"decode run: lane of seq {seq} step {i}: run token "
                                     f"{int(toks[seq][i])}, step-by-step {t}")
        feed = {s: int(toks[s][i]) for s in seqs}
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"  decode_run ({n} steps, 4 lanes, prompts 40/300/1000/100) gives exactly the "
          f"tokens of step-by-step ctx.decode ({step_ms:.1f} ms per eager step with its "
          f"readback)", flush=True)
    profile_decode_run(ctx, seqs, first, lengths)
    for seq in seqs:
        kv.seq_rm(seq)


def prefill_four(ctx):
    """The 4-lane context emptied, then four prompts (40 / 300 / 1000 / 100
    tokens) prefilled one by one: (sequences, each one's first token, each
    one's length)."""
    import torch

    kv = ctx.kv
    for seq in [s for s in kv.seq_ids if s is not None]:
        kv.seq_rm(seq)
    rng = torch.Generator().manual_seed(11)
    seqs, first, lengths = [], {}, {}
    for n in (40, 300, 1000, 100):
        seq = ctx.new_sequence()
        logits = ctx.prefill(seq, torch.randint(2, ctx.cfg.vocab_size, (n,),
                                                generator=rng).tolist(), all_logits=False)
        seqs.append(seq)
        first[seq] = int(logits[-1].argmax())
        lengths[seq] = kv.lengths[kv.lane_of(seq)]
    return seqs, first, lengths


def profile_decode_run(ctx, seqs, first, lengths, label: str = "bf16 KV"):
    """Where a served decode step's time goes: one sampled 4-lane device run
    (the server's default chain) timed by the host clock to its readback,
    then a PROFILE_STEPS-step one under torch.profiler. The runs are 4 and
    2 steps, not the server's 24: per step they cost the same, and the
    profiler's reading of a 24-step run's ~150,000 kernel events took over a
    minute of host time (an 8-step run's 16-34 s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rrs_tpu_torch.runtime.sampler import SamplerParams

    t_prof = time.perf_counter()
    n = min(4, ctx.DECODE_RUN_STEPS)
    params = SamplerParams(temperature=0.8, top_k=40, top_p=0.95, min_p=0.05)

    def run(steps):
        for seq in seqs:
            ctx.kv.seq_rm(seq, p0=lengths[seq])
        gens = {s: torch.Generator(device=ctx.device).manual_seed(s) for s in seqs}
        h = ctx.decode_run_start(first, gens, {s: params for s in seqs}, steps)
        return h["toks"].cpu()

    run(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(PROFILE_STEPS)
        torch.cuda.synchronize()
    events, by_name = device_ms_by_kernel(prof)
    if not events:
        print("  decode-run profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    p = PROFILE_STEPS
    dev_ms = sum(by_name.values()) / p
    split = ", ".join(f"{k} {v / p:.3f}" for k, v in sorted(by_name.items(),
                                                           key=lambda kv: -kv[1]))
    print(f"  decode-run profile, {label} ({n} steps timed, {p} profiled, 4 lanes, "
          f"S={ctx.kv.max_seq}, sampled): wall {wall_ms:.3f} ms/step, device {dev_ms:.3f} "
          f"ms/step, idle share {1 - dev_ms / wall_ms:.3f}, {len(events) / p:.0f} kernels/step; "
          f"device ms/step by kernel: {split}", flush=True)
    print(f"  decode-run profile, {label}, host ms/step by op: {host_top(prof, p)} "
          f"({time.perf_counter() - t_prof:.1f} s with the profiler's reading)", flush=True)
    return {"wall_ms": wall_ms, "device_ms": dev_ms}


@contextlib.contextmanager
def store_held(label: str):
    """While open, every K/V store of the model into a quantized cache on the
    card is checked against the plain store on the CPU of the same new rows:
    the codes and scales it wrote must be bit-equal (a division by a CPU
    scalar on the card rounds once more than on the CPU, and flips them).
    Yields {"stores": n, "rows": rows written}."""
    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.runtime import kv_codec

    orig = llama._store_cache
    seen = {"stores": 0, "rows": 0}

    def checked(cache, new, starts):
        orig(cache, new, starts)
        if not isinstance(cache, tuple):
            return
        arr, sc = cache
        t = new.shape[2]
        q, s_new = kv_codec.quantize_rows(new.cpu(), kv_codec.kv_qmax(arr))
        q = kv_codec.pack_like(q, arr, sc)
        for lane, st in enumerate(starts):
            if st is None:
                continue
            idx = torch.arange(st, st + t) % arr.shape[2]             # a ring's run wraps
            if not (torch.equal(arr[lane][:, idx].cpu(), q[lane])
                    and torch.equal(sc[lane, :, 0][:, idx].cpu(), s_new[lane])):
                raise AssertionError(f"{label}: the card's {arr.dtype} store of lane {lane} "
                                     f"(T={t}) differs from the CPU's")
        seen["stores"] += 1
        seen["rows"] += new.shape[0] * new.shape[1] * t

    llama._store_cache = checked
    try:
        yield seen
    finally:
        llama._store_cache = orig


def phase_served_steps_kvq(cfg, weights):
    """The served prefill step (chunks of 1000 / 700 / 40 tokens in one
    T = 1024 step, lane 3 dead) and one 4-lane decode step at qwen3-4b width
    over q8 and q4 (head-pair) caches of 4 x 4096 slots: every kernel launch
    held to its plain version on its inputs, every K/V store held bit for
    bit to the CPU's."""
    import torch

    from rrs_tpu_torch.runtime.context import InferenceContext

    rng = torch.Generator().manual_seed(5)
    for quant, name in (("q8", "flash_attention_q8"), ("q4", "flash_attention_q4hp")):
        ctx = InferenceContext(cfg, weights, n_lanes=4, max_seq=4096, kv_quant=quant)
        seqs = [ctx.new_sequence() for _ in range(3)]
        chunks = {seq: torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist()
                  for seq, n in zip(seqs, (1000, 700, 40))}
        t0 = time.perf_counter()
        with held_to_plain(f"served steps {quant} KV", BF16_PATH - {"flash_attention"} | {name}) \
                as seen, store_held(f"served steps {quant} KV") as stores:
            last = ctx.prefill_multi(chunks)
            out = ctx.decode({seq: int(last[seq].argmax()) for seq in seqs})
            torch.cuda.synchronize()
        for seq in seqs:
            if not torch.isfinite(out[seq]).all():
                raise AssertionError(f"served steps {quant} KV: non-finite decode logits")
        worst, shapes = seen[name]
        print(f"  served steps, {quant} KV: {name} within {SMALL_TOL[name]:.0e} of its plain "
              f"version (max rel {worst:.2e}, shapes {sorted(shapes)}); "
              + ", ".join(f"{k} {v[0]:.2e}" for k, v in seen.items() if k != name)
              + f"; {stores['stores']} K/V stores ({stores['rows']} rows) bit-equal to the "
              f"CPU's; {time.perf_counter() - t0:.1f} s", flush=True)
        del ctx


SERVE_Q4_LENGTHS = (1000, 2000, 1000, 2000)     # two greedy, then two sampled


# phase 7's q4 server runs the first 12 of qwen3-4b's 36 layers (all 36 until
# phase 21 needed the room)
SERVE_Q4_LAYERS = 12


def phase_serving_q4(cfg, weights, reports):
    """The server in-process at qwen3-4b width with ``--cache-type q4``, its
    first SERVE_Q4_LAYERS layers in phase 7: 4
    slots, ctx 4096, a slot save path in a temporary directory. Four
    concurrent completions (1000 / 2000 tokens, SERVE_NEW new; two greedy, two
    sampled), then over HTTP: save slot 0, erase it, restore it (the lane's
    codes must equal the saved lane's, its scales within 1e-6 relative), and
    a greedy continuation that reuses the restored prefix. Returns the
    context for the context-shift check."""
    import torch
    from http.server import ThreadingHTTPServer

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.runtime.kv_cache import KVCache
    from rrs_tpu_torch.serving.engine import Engine
    from rrs_tpu_torch.serving.server import ServerState, make_handler

    resident = {q: KVCache.create(cfg, 4, 4096, device="meta", quant=q).nbytes() / GB
                for q in ("none", "q8", "q4")}
    print(f"  resident KV at 4 slots x 4096, {cfg.n_layers} layers: "
          + ", ".join(f"{'bf16' if q == 'none' else q} {v:.3f} GB" for q, v in resident.items()),
          flush=True)
    ctx = InferenceContext(cfg, weights, n_lanes=4, max_seq=4096, kv_quant="q4")
    engine = Engine(ctx)
    state = ServerState(cfg, synthetic_vocab(cfg.vocab_size), engine, {}, "qwen3-4b-fabricated")
    tmp = tempfile.TemporaryDirectory()
    state.slot_save_path = tmp.name
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    rng = torch.Generator().manual_seed(9)
    ids = lambda n: torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist()  # noqa: E731
    jobs = []
    for i, n in enumerate(SERVE_Q4_LENGTHS):
        body = {"prompt": ids(n), "max_tokens": SERVE_NEW, "seed": i}
        if i < 2:
            body["temperature"] = 0.0
        jobs.append((f"q4 completion {n} {'greedy' if i < 2 else 'sampled'} #{i}", body))
    results: dict = {}

    def run(job):
        name, body = job
        t0 = time.perf_counter()
        status, data = _http(port, "POST", "/v1/completions", body)
        results[name] = (status, data, t0, time.perf_counter(), body)

    engine.start()
    server_thread.start()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t_start = time.perf_counter()
        threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in threads):
            raise AssertionError("q4 serving: a request did not finish within 900 s")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / GB
        round_trip = slot_round_trip(port, engine, ids)
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        tmp.cleanup()
    if engine._thread.is_alive():
        raise AssertionError("q4 serving: the engine thread did not stop")
    decode_spans, n_decode = [], 0
    for name, (status, data, t0, t1, body) in results.items():
        if status != 200:
            raise AssertionError(f"q4 serving: {name} answered {status}: {data[:300]!r}")
        out = json.loads(data)
        reason = out["choices"][0]["finish_reason"]
        n_out = out["usage"]["completion_tokens"]
        if reason not in ("length", "stop") or (reason == "length") != (n_out == SERVE_NEW) \
                or n_out > SERVE_NEW:
            raise AssertionError(f"q4 serving: {name} finished by {reason} with {n_out} tokens")
        tm = out["timings"]
        start = t0 + tm["prompt_ms"] / 1e3
        decode_spans.append((start, start + tm["predicted_ms"] / 1e3))
        n_decode += max(n_out - 1, 0)
        print(f"  {name}: {n_out} tokens ({reason}), time to first token {tm['prompt_ms']:.1f} "
              f"ms, decode {(n_out - 1) / max(tm['predicted_ms'] / 1e3, 1e-9):.2f} tok/s",
              flush=True)
    busy = _union_seconds(decode_spans)
    print(f"  q4 KV served {len(results)} requests in {wall:.1f} s; decode tok/s summed over the "
          f"4 slots {n_decode / busy:.2f} ({n_decode} tokens over {busy:.1f} s); KV resident "
          f"{ctx.kv.nbytes() / GB:.3f} GB; peak memory {peak:.2f} GB; launches {launches}",
          flush=True)
    print(f"  {round_trip}", flush=True)
    n = launches["flash_attention_q4hp"]
    if n == 0 or launches["flash_attention"] != 0:
        raise AssertionError(f"q4 serving: flash_attention_q4hp launched {n} times, bf16 "
                             f"attention {launches['flash_attention']}")
    reports["fa_q4hp"].entry["launches_serve"] = n
    return ctx


def slot_round_trip(port, engine, ids) -> str:
    """Save slot 0's retained sequence, erase it and restore it over HTTP;
    the restored lane must hold the saved codes (scales within 1e-6
    relative); then a greedy continuation of its tokens must reuse the
    restored prefix and finish with its token count."""
    import torch

    kv = engine.ctx.kv
    slot = engine.slots[0]

    def snapshot():
        lane = kv.lane_of(slot.retained_seq)
        n = kv.lengths[lane]
        return n, [(c[0][lane, :, :n].clone(), c[1][lane, :, 0, :n].clone())
                   for c in kv.k + kv.v]

    n, before = engine.call(snapshot)
    status, data = _http(port, "POST", "/slots/0?action=save", {"filename": "slot0.rrsstate"})
    if status != 200 or json.loads(data)["n_saved"] != n:
        raise AssertionError(f"slot save: {status} {data[:300]!r}")
    n_bytes = json.loads(data)["n_written"]
    status, data = _http(port, "POST", "/slots/0?action=erase", {})
    if status != 200 or slot.retained_seq >= 0:
        raise AssertionError(f"slot erase: {status} {data[:300]!r}")
    status, data = _http(port, "POST", "/slots/0?action=restore", {"filename": "slot0.rrsstate"})
    if status != 200 or json.loads(data)["n_restored"] != n:
        raise AssertionError(f"slot restore: {status} {data[:300]!r}")
    n2, after = engine.call(snapshot)
    worst = 0.0
    for (c0, s0), (c1, s1) in zip(before, after):
        if not torch.equal(c0, c1):
            raise AssertionError("slot restore: the restored codes differ from the saved lane's")
        worst = max(worst, ((s1 - s0).abs() / s0).max().item())
    if n2 != n or worst > 1e-6:
        raise AssertionError(f"slot restore: {n2} of {n} slots, scales rel {worst:.2e} > 1e-6")
    prompt = list(slot.cache_tokens) + ids(5)
    status, data = _http(port, "POST", "/v1/completions",
                         {"prompt": prompt, "max_tokens": 16, "temperature": 0.0})
    out = json.loads(data) if status == 200 else {}
    if status != 200 or out["usage"]["completion_tokens"] != 16 \
            or out["choices"][0]["finish_reason"] != "length" or slot.n_reused != n:
        raise AssertionError(f"continuation from the restored slot: {status} {data[:300]!r}, "
                             f"reused {slot.n_reused} of {n}")
    return (f"slot 0 round trip: saved {n} slots ({n_bytes / 1e6:.1f} MB file), erased, "
            f"restored with equal codes and scales within rel {worst:.1e}; a greedy "
            f"continuation reused {slot.n_reused} cached tokens and gave 16 tokens")


def phase_q4_decode_profile(ctx):
    """Where a q4 served decode step's time goes: the q4 server's 4-lane
    context, four prompts prefilled, then ``profile_decode_run`` as phase 5
    runs it over bf16 KV; the run's attention must be B7 alone."""
    from rrs_tpu_torch import kernels

    seqs, first, lengths = prefill_four(ctx)
    kernels.reset_launches()
    profile_decode_run(ctx, seqs, first, lengths, label="q4 KV")
    if kernels.LAUNCHES["flash_attention_q4hp"] == 0 or kernels.LAUNCHES["flash_attention"]:
        raise AssertionError(f"q4 decode run: attention launches {kernels.LAUNCHES}")
    for seq in seqs:
        ctx.kv.seq_rm(seq)


def shift_held(ctx, label: str) -> None:
    """One context shift of the longest lane of a quantized cache on the card
    (keep 1, drop half), held to the CPU's shift of a copy of that lane:
    dequantized K within one quantization step per element, V codes and
    scales equal (an MLA row rotates only its leading rope dims)."""
    import torch

    from rrs_tpu_torch.runtime import kv_codec
    from rrs_tpu_torch.runtime.kv_cache import KVCache

    kv, cfg = ctx.kv, ctx.cfg
    seq = max((s for s in kv.seq_ids if s is not None), key=lambda s: kv.lengths[kv.lane_of(s)])
    lane = kv.lane_of(seq)
    n = kv.lengths[lane]
    quant = "q8" if kv.k[0][0].dtype == torch.int8 else "q4"
    cpu = KVCache.create(cfg, 1, kv.max_seq, device="cpu", quant=quant)
    for dst, src in zip(cpu.k + cpu.v, kv.k + kv.v):
        for d_t, s_t in zip(dst, src):
            d_t[0].copy_(s_t[lane].cpu())
    cpu.seq_new(seq)
    cpu.lengths[0] = n
    t0 = time.perf_counter()
    kv.seq_shift(cfg, seq, 1, n // 2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cpu.seq_shift(cfg, seq, 1, n // 2)
    worst = 0.0
    for (ka, ks), (ca, cs) in zip(kv.k, cpu.k):
        got = kv_codec.dequantize(ka[lane].cpu(), ks[lane].cpu())
        ref = kv_codec.dequantize(ca[0], cs[0])
        step = torch.maximum(ks[lane].cpu(), cs[0]).transpose(-1, -2)
        worst = max(worst, ((got - ref).abs() / step).max().item())
    if worst > 1.0001:
        raise AssertionError(f"{label} context shift: K {worst:.3f} quantization steps from the "
                             f"CPU's")
    for (va, vs), (ca, cs) in zip(kv.v, cpu.v):
        if not (torch.equal(va[lane].cpu(), ca[0]) and torch.equal(vs[lane].cpu(), cs[0])):
            raise AssertionError(f"{label} context shift: V codes or scales differ from the "
                                 f"CPU's")
    if kv.lengths[lane] != cpu.lengths[0] or kv.lengths[lane] != n - n // 2:
        raise AssertionError(f"{label} context shift: lengths {kv.lengths[lane]} / "
                             f"{cpu.lengths[0]}")
    print(f"  context shift of a {label} {quant} lane on the card (keep 1, drop {n // 2} of "
          f"{n}, {dt * 1e3:.0f} ms): K within {worst:.3f} quantization steps of the CPU's, V "
          f"codes and scales equal", flush=True)


# ---------------------------------------------------------------------------
# The integer decode kernels (B14 gx, B15 gx3, B16 a8), the RRS_GX3 A/B and
# the measuring verbs (bench, batched-bench, perplexity), at qwen3-4b width
# ---------------------------------------------------------------------------

# report key -> (kernel, source, TPU kernel it replaces)
INT = {"gx3": ("tcq4_matmul_gx3", "rrs_tpu_torch/csrc/tcq4_gx2.cu",
               "rrs_tpu/ops/tcq4_matmul.py:1394"),
       "gx": ("tcq4_matmul_gx", "rrs_tpu_torch/csrc/tcq4_gx2.cu", "rrs_tpu/ops/tcq4_matmul.py:272"),
       "a8": ("tcq4_matmul_a8", "rrs_tpu_torch/csrc/tcq4_gx2.cu", "rrs_tpu/ops/tcq4_matmul.py:89")}
INT_TOL = 1e-5          # the reference's limit for the integer kernels (tests/test_tcq4_matmul.py)
# qwen3-4b's TCQ4 decode linears a step: 36 layers x (qkv, o, gate-up, down)
QWEN3_4B_TCQ4_PER_STEP = 144
# the RRS_GX3 A/B generates run the first 12 of the 36 layers (all 36 until
# phase 21 needed the room; B1 / B15 then took 144 linears a step)
GX3_AB_LAYERS = 12


def phase_parity_int(peaks, reports):
    """B15 against its plain version at M = 1 and 4 (bf16 x, as the model
    passes it), B14 against the integer oracle ``tcq4_matmul_ref`` and bit-equal
    to B1 given B1's own codes, B16 against the oracle and its plain version
    at M = 1, 8 and 32, bit-equal across two launches and to
    ``tcq4_matmul_a8_splitk_plain`` (its order of sums under ``a8_plan``);
    each at the four qwen3-4b projections the route sends to it, timed
    beside its bound, its plain version and ``torch.matmul`` on weights
    dequantized to bf16 beforehand, as many bf16 copies as pass 2 x L2.
    Headline: M = 1 summed over the projections, as B1's row."""
    import torch

    from rrs_tpu_torch.formats.tcq4 import dequantize_activations_rrs, quantize_activations_rrs
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    bw, _, int8_peak, _ = peaks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for key, (name, source, replaces) in INT.items():
        reports[key] = Report(name, source, replaces, "bytes")
    hold_s = 0.0

    def bound(nbytes, m, k, n):
        t_bytes, t_ops = nbytes / bw * 1e3, 2 * m * k * n / int8_peak * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    for lname, (k, n) in QWEN3_4B_LINEARS.items():
        wbytes = k // 2 * n + k // 32 * n * 2
        ws = [(torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
               (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                ).to(torch.bfloat16)) for _ in range(n_copies(wbytes))]
        ws32 = [(q, e.float()) for q, e in ws[:n_copies(wbytes + k // 32 * n * 2)]]
        wl = [tm.dequantize_w(q, e).to(torch.bfloat16) for q, e in ws[:n_copies(2 * k * n)]]
        for m in (1, 4):
            if not tm.gx_viable(m, k, n):
                continue
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            got = tm.tcq4_matmul_gx3(x, *ws[0])
            err, rel = compare(f"gx3 {lname} M={m}", got, tm.tcq4_matmul_gx3_plain(x, *ws[0]),
                               INT_TOL)
            t_hold = time.perf_counter()
            if not torch.equal(got, tm.tcq4_matmul_gx3(x, *ws[0])):
                raise AssertionError(f"gx3 {lname} M={m}: two launches differ")
            # B15 is B14 on B15's own codes (the plain rotation's, bit for bit)
            if not torch.equal(got, tm.tcq4_matmul_gx(*quantize_activations_rrs(tm.fwht256(x)),
                                                      *ws[0])):
                raise AssertionError(f"gx3 {lname} M={m}: not bit-equal to gx on its codes")
            hold_s += time.perf_counter() - t_hold
            reports["gx3"].add({
                "shape": f"{lname} M={m} K={k} N={n} bf16 x (two launches bit-equal, bit-equal "
                         f"to gx on its codes)", "max_abs_err": err, "rel_err": rel,
                "tol": INT_TOL, "ms": time_ms(tm.tcq4_matmul_gx3, [(x, q, e) for q, e in ws], 40),
                "plain_ms": time_ms(tm.tcq4_matmul_gx3_plain, [(x, q, e) for q, e in ws[:2]], 5),
                "library_ms": time_ms(torch.matmul, [(x, w) for w in wl], 40),
                **bound(wbytes + m * k * 2 + m * n * 4, m, k, n)}, headline=(m == 1))
            # B14 on B1's codes of the same (rotated) activations
            a_rot = tm.fwht256(x)
            a_q, a_s = quantize_activations_rrs(a_rot)
            got = tm.tcq4_matmul_gx(a_q, a_s, *ws[0])
            if not torch.equal(got, tm.tcq4_matmul_gx2(a_rot, *ws[0])):
                raise AssertionError(f"gx {lname} M={m}: not bit-equal to gx2 on gx2's codes")
            t_hold = time.perf_counter()
            if not torch.equal(got, tm.tcq4_matmul_gx(a_q, a_s, *ws[0])):
                raise AssertionError(f"gx {lname} M={m}: two launches differ")
            hold_s += time.perf_counter() - t_hold
            ref = tm.tcq4_matmul_ref(a_q, a_s, ws[0][0], ws[0][1].float())
            err, rel = compare(f"gx {lname} M={m}", got.cpu(), ref, INT_TOL)
            a16 = dequantize_activations_rrs(a_q, a_s).to(torch.bfloat16)
            reports["gx"].add({
                "shape": f"{lname} M={m} K={k} N={n} (bit-equal to gx2; two launches bit-equal)",
                "max_abs_err": err,
                "rel_err": rel, "tol": INT_TOL,
                "ms": time_ms(tm.tcq4_matmul_gx, [(a_q, a_s, q, e) for q, e in ws], 40),
                "plain_ms": time_ms(tm.tcq4_matmul_gx_plain, [(a_q, a_s, q, e) for q, e in ws[:2]],
                                    5),
                "library_ms": time_ms(torch.matmul, [(a16, w) for w in wl], 40),
                **bound(wbytes + m * k + m * (k // 256) * 4 + m * n * 4, m, k, n)},
                headline=(m == 1))
        for m in (1, 8, 32):
            a_q = torch.randint(-7, 8, (m, k), generator=gen, device=dev, dtype=torch.int8)
            a_s = torch.rand((m, k // 256), generator=gen, device=dev) + 0.5
            got = tm.tcq4_matmul_a8(a_q, a_s, *ws32[0])
            compare(f"a8 {lname} M={m} vs plain", got, tm.tcq4_matmul_a8_plain(a_q, a_s, *ws32[0]),
                    INT_TOL)
            err, rel = compare(f"a8 {lname} M={m}", got.cpu(),
                               tm.tcq4_matmul_ref(a_q, a_s, *ws32[0]), INT_TOL)
            t_hold = time.perf_counter()
            if not torch.equal(got, tm.tcq4_matmul_a8(a_q, a_s, *ws32[0])):
                raise AssertionError(f"a8 {lname} M={m}: two launches differ")
            if not torch.equal(got, tm.tcq4_matmul_a8_splitk_plain(a_q, a_s, *ws32[0],
                                                                   tm.a8_plan(m, k, n))):
                raise AssertionError(f"a8 {lname} M={m}: not its order of sums bit for bit")
            hold_s += time.perf_counter() - t_hold
            a16 = dequantize_activations_rrs(a_q, a_s).to(torch.bfloat16)
            reports["a8"].add({
                "shape": f"{lname} M={m} K={k} N={n} f32 eff (two launches bit-equal, bit-equal "
                         f"to its order of sums)", "max_abs_err": err, "rel_err": rel,
                "tol": INT_TOL,
                "ms": time_ms(tm.tcq4_matmul_a8, [(a_q, a_s, q, e) for q, e in ws32], 20),
                "plain_ms": time_ms(tm.tcq4_matmul_a8_plain, [(a_q, a_s, *ws32[0])], 3),
                "library_ms": time_ms(torch.matmul, [(a16, w) for w in wl], 20),
                **bound(k // 2 * n + k // 32 * n * 4 + m * k + m * (k // 256) * 4 + m * n * 4,
                        m, k, n)}, headline=(m == 1))
        del ws, ws32, wl
    torch.cuda.empty_cache()
    print(f"  gx3 / gx / a8 holds beyond the plain version (two launches, gx3 on gx, a8 on its "
          f"order of sums): {hold_s:.2f} s", flush=True)


@contextlib.contextmanager
def gx3_oracles(label: str):
    """While open, every B15 launch is also held to the integer kernels on the
    codes of the plain rotation (``fwht256`` + the activation quantizer):
    B14 must give its output bit for bit (the same product on the same
    codes), B16 within INT_TOL. It also counts the codes that differ from
    those of B1's route (the f32 rotation matmul), which sums in another
    order: the knife edge of ROADMAP queue C, reported. Yields the counts."""
    import torch

    from rrs_tpu_torch.formats.tcq4 import quantize_activations_rrs
    from rrs_tpu_torch.models.linear import rotate_activations
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    orig = tm.tcq4_matmul_gx3
    held = {"n": 0, "a8_rel": 0.0, "flips": 0, "codes": 0}

    def run(x, qs, eff):
        out = orig(x, qs, eff)
        a_q, a_s = quantize_activations_rrs(tm.fwht256(x))
        if not torch.equal(tm.tcq4_matmul_gx(a_q, a_s, qs, eff), out):
            raise AssertionError(f"{label}: B15 {tuple(x.shape)} differs from B14 on its codes")
        _, rel = compare(f"{label}: B16 on B15's codes", tm.tcq4_matmul_a8(a_q, a_s, qs,
                                                                          eff.float()), out,
                         INT_TOL)
        held["n"] += 1
        held["a8_rel"] = max(held["a8_rel"], rel)
        r_q, _ = quantize_activations_rrs(rotate_activations(x, None))
        held["flips"] += int((r_q != a_q).sum())
        held["codes"] += a_q.numel()
        return out

    tm.tcq4_matmul_gx3 = run
    try:
        yield held
    finally:
        tm.tcq4_matmul_gx3 = orig


@contextlib.contextmanager
def gx3_flag(on: bool):
    import os

    old = os.environ.get("RRS_GX3")
    os.environ["RRS_GX3"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("RRS_GX3")
        else:
            os.environ["RRS_GX3"] = old


def phase_gx3_ab(cfg, weights, reports):
    """``generate`` at qwen3-4b width, its first GX3_AB_LAYERS layers (three
    greedy prompts of 5, 40 and 300 tokens, 32 new tokens each) without and
    with ``RRS_GX3``, the launch counts set to 0 before each run: without the
    flag B1 takes all 4 x n_layers TCQ4 decode linears of a step and B15
    none, with it the reverse (the
    fabricated weights carry no channel permutation). A decode profile of
    each, the greedy tokens of the two runs compared (reported: the rotation
    sums in another order, and an int4 code at a half-way point may flip);
    the bench verb's own decode (``run_one``, tg16) counted the same way; then
    one teacher-forced decode step under the flag with every launch held to
    its plain version and every B15 launch to B14 and B16 on its codes."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.tools.bench_sweep import run_one

    per_step = 4 * cfg.n_layers             # TCQ4 linears of a decode step
    rng = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in (5, 40, 300)]
    outs, profiles = {}, {}
    for on in (False, True):
        tag = f"RRS_GX3={int(on)}"
        with gx3_flag(on):
            warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
            warm.generate(prompts[0], 2)
            del warm
            ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
            torch.cuda.synchronize()
            kernels.reset_launches()
            outs[on] = [ctx.generate(p, 32) for p in prompts]
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            perf = ctx.perf()
            steps = perf["n_eval"]
            b1, b15 = launches["tcq4_matmul_gx2"], launches["tcq4_matmul_gx3"]
            want = (0, per_step * steps) if on else \
                (per_step * steps, 0)
            if (b1, b15) != want:
                raise AssertionError(f"generate {tag}: B1 / B15 launched {b1} / {b15} times over "
                                     f"{steps} decode steps, expected {want}")
            if on:
                reports["gx3"].entry["launches"] = b15
            print(f"  generate {tag}: prompts 5/40/300 x 32 new tokens; decode {steps} steps @ "
                  f"{perf['tg_tok_per_s']:.2f} tok/s ({perf['t_eval_ms'] / steps:.3f} ms/token), "
                  f"prefill {perf['pp_tok_per_s']:.1f} tok/s; B1 {b1 / steps:.0f} and B15 "
                  f"{b15 / steps:.0f} launches a decode step; launches {launches}", flush=True)
            profiles[on] = profile_decode(ctx, prompts[1], label=f"qwen3-4b {tag}")
            del ctx
            kernels.reset_launches()
            row = run_one(cfg, weights, torch.device("cuda"), 1, "bf16", "bf16", 0, 16, 0, 1)
            n15 = kernels.LAUNCHES["tcq4_matmul_gx3"] / 32          # warm-up + 1 rep of tg16
            n1 = kernels.LAUNCHES["tcq4_matmul_gx2"] / 32
            if (n1, n15) != ((0, per_step) if on else (per_step, 0)):
                raise AssertionError(f"bench decode {tag}: B1 / B15 {n1} / {n15} a step")
            print(f"  bench decode (run_one tg16) {tag}: {row['avg_ts']} tok/s, B1 {n1:.0f} and "
                  f"B15 {n15:.0f} launches a step", flush=True)
    same = [sum(a == b for a, b in zip(x, y)) for x, y in zip(outs[False], outs[True])]
    first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
             for x, y in zip(outs[False], outs[True])]
    print(f"  greedy tokens with and without RRS_GX3 (reported, not required): equal at "
          f"{same} of 32 positions; first difference at {first}", flush=True)
    if all(profiles.values()):
        a, b = profiles[False], profiles[True]
        print(f"  RRS_GX3 A/B decode step: kernels {a['kernels']:.0f} -> {b['kernels']:.0f}, "
              f"device {a['device_ms']:.3f} -> {b['device_ms']:.3f} ms, wall "
              f"{a['wall_ms']:.3f} -> {b['wall_ms']:.3f} ms, idle share {a['idle']:.3f} -> "
              f"{b['idle']:.3f}", flush=True)

    with gx3_flag(True):
        ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
        seq = ctx.new_sequence()
        ctx.prefill(seq, prompts[1])
        expect = {"tcq4_matmul_gx3", "q8_matmul", "flash_attention"}
        with held_to_plain("gx3 decode step", expect) as seen, \
                gx3_oracles("gx3 decode step") as held:
            logits = ctx.decode({seq: 11})[seq]
            torch.cuda.synchronize()
        if not torch.isfinite(logits).all() or held["n"] != per_step:
            raise AssertionError(f"gx3 decode step: {held['n']} B15 launches held")
        print(f"  teacher-forced decode step with RRS_GX3=1: {held['n']} B15 launches, each "
              f"within {seen['tcq4_matmul_gx3'][0]:.2e} of its plain version, bit-equal to B14 "
              f"on its codes, and within {held['a8_rel']:.2e} of B16; shapes "
              f"{sorted(seen['tcq4_matmul_gx3'][1])}; int4 codes that differ from the rotation "
              f"matmul's (reported): {held['flips']} of {held['codes']}", flush=True)
        reports["gx"].entry["held_launches"] = held["n"]
        reports["a8"].entry["held_launches"] = held["n"]
        del ctx


# the verb processes started and not yet waited for; main() stops any left
_CHILDREN: list = []


def _verb_start(argv, env=None):
    """Start ``python -m rrs_tpu_torch <argv>`` from the repository root as a
    user does; returns a handle for ``_verb_wait``."""
    import os
    from pathlib import Path

    argv = [str(a) for a in argv]
    proc = subprocess.Popen([sys.executable, "-m", "rrs_tpu_torch", *argv],
                            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env={**os.environ, **(env or {})})
    _CHILDREN.append(proc)
    return proc, argv, env, time.perf_counter()


def _verb_wait(handle, timeout=600) -> str:
    """Wait for a verb started by ``_verb_start``; fail on a non-zero exit.
    Prints its command line and seconds; returns its stdout."""
    proc, argv, env, t0 = handle
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        _CHILDREN.remove(proc)
    if proc.returncode != 0:
        raise AssertionError(f"rrs_tpu_torch {' '.join(argv)}: exit {proc.returncode}\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    print(f"  $ {' '.join(f'{k}={v}' for k, v in (env or {}).items())} python -m rrs_tpu_torch "
          f"{' '.join(argv)}  ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def _verb(argv, env=None, timeout=600) -> str:
    """Run ``python -m rrs_tpu_torch <argv>`` to its end; returns its stdout."""
    return _verb_wait(_verb_start(argv, env), timeout)


def stop_children() -> None:
    for proc in list(_CHILDREN):
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
        _CHILDREN.remove(proc)


def phase_verbs(name: str):
    """The measuring verbs as a user runs them, each its own process on the
    card: ``bench`` at qwen3-4b (pp512 and tg64, two reps) over bf16 and q8
    caches in one process and with RRS_GX3 in another, every jsonl row
    parsed and checked;
    ``batched-bench`` at qwen3-4b (PP 128, TG 32, B 1 and 4; with the flag,
    so that the 4-lane decode runs B15 at M = 4); ``perplexity`` on a 2-layer
    GGUF written by the port's exporter."""
    import math

    from rrs_tpu_torch.tools.bench_sweep import FIELDS

    for env, ctk in (({}, ["bf16", "q8_0"]), ({"RRS_GX3": "1"}, ["bf16"])):
        out = _verb(["bench", "--preset", "qwen3-4b", "-p", "512", "-n", "64", "-r", "2", "-o",
                     "jsonl", "--ctk", *ctk], env)
        rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
        if [(r["n_prompt"], r["n_gen"]) for r in rows] != [(512, 0), (0, 64)] * len(ctk):
            raise AssertionError(f"bench rows: {rows}")
        for r in rows:
            if (list(r) != FIELDS or r["backends"] != "CUDA" or r["gpu_info"] != name
                    or not (math.isfinite(r["avg_ts"]) and r["avg_ts"] > 0)):
                raise AssertionError(f"bench row: {r}")
            print(f"    {r['model_type']} {r['type_k']} {'pp' if r['n_prompt'] else 'tg'}"
                  f"{r['n_prompt'] or r['n_gen']}: {r['avg_ts']} ± {r['stddev_ts']} tok/s "
                  f"(avg {r['avg_ns'] / 1e6:.1f} ms)", flush=True)
    out = _verb(["batched-bench", "--preset", "qwen3-4b", "--pp", "128", "--tg", "32", "--pl",
                 "1", "4", "--json"], {"RRS_GX3": "1"})
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    if [(r["PP"], r["TG"], r["B"]) for r in rows] != [(128, 32, 1), (128, 32, 4)] or \
            not all(r["S_PP t/s"] > 0 and r["S_TG t/s"] > 0 for r in rows):
        raise AssertionError(f"batched-bench rows: {rows}")
    for r in rows:
        print(f"    batched-bench {r}", flush=True)
    from pathlib import Path

    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.models.export import export_random_gguf

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        cfg = ModelConfig(arch="qwen3", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
                          head_dim=64, n_ff=512, vocab_size=256, context_length=512,
                          qk_norm=True)
        vocab = [chr(33 + i) if 33 + i < 0x2FF else f"<tok{i}>" for i in range(256)]
        gguf = export_random_gguf(cfg, Path(tmp) / "tiny.gguf", seed=0, vocab_tokens=vocab)
        text = Path(tmp) / "text.txt"
        text.write_text("the quick brown fox jumps over the lazy dog; " * 12)
        out = _verb(["perplexity", "-m", str(gguf), "-f", str(text), "--n-ctx", "128",
                     "--max-chunks", "4"])
        final = [line for line in out.splitlines() if line.startswith("Final PPL")]
        ppl = float(final[0].split("=")[1].split()[0]) if final else float("nan")
        if not (math.isfinite(ppl) and ppl > 1):
            raise AssertionError(f"perplexity verb: {out[-500:]}")
        print(f"    {final[0]}", flush=True)


def phase_perplexity(cfg4b, weights4b):
    """The evaluators in process. A 2-layer model with dense bf16 weights
    (E=1024, 16/8 heads x 128, vocab 4096), on the card and on the CPU, over
    512 random tokens in chunks of 256: the card's device-NLL perplexity
    against the CPU's, within the bound that GLUE_TOL sets (a log-prob moves
    by at most twice its row's largest logit move, so the mean NLL by at most
    2 * GLUE_TOL * ||L||_F / sqrt(T) of the CPU's logits L); the card's
    device-NLL branch against its host float64 branch (1e-5 a token); the
    model's KL divergence against its own logits saved as f16 (as the verb
    saves them), below 1e-4. Then qwen3-4b at full width with the i8p packs
    dropped (the verb loads with RRS_PREFILL_I8=0): two 512-token chunks,
    whose prefill must take B4 and not B5."""
    import dataclasses

    import numpy as np
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.models.linear import TCQ4Linear
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.tools import perplexity as ppl

    cfg = ModelConfig(arch="qwen3", n_layers=2, n_embd=1024, n_heads=16, n_kv_heads=8,
                      head_dim=128, n_ff=3072, vocab_size=4096, context_length=4096,
                      rope_theta=1e6, qk_norm=True)
    w_cpu = llama.random_weights(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (512,), generator=torch.Generator().manual_seed(3)
                           ).tolist()
    card = InferenceContext(cfg, llama.to_device(w_cpu, "cuda"), max_seq=256)
    cpu = InferenceContext(cfg, w_cpu, max_seq=256, device="cpu")
    got = ppl.compute_perplexity(card, tokens, n_ctx=256)
    host = ppl.compute_perplexity(card, tokens, n_ctx=256, device_nll=False)
    ref = ppl.compute_perplexity(cpu, tokens, n_ctx=256)
    first = 128
    rows = np.concatenate([ppl.host_logits(cpu, tokens[c * 256:(c + 1) * 256])[first:255]
                           for c in range(2)])
    limit = 2 * GLUE_TOL * float(np.linalg.norm(rows)) / math.sqrt(rows.shape[0])
    d_mean = abs(got.nll_sum - ref.nll_sum) / ref.n_tokens
    d_branch = abs(got.nll_sum - host.nll_sum) / got.n_tokens
    if got.n_tokens != ref.n_tokens or d_mean > limit or d_branch > 1e-5:
        raise AssertionError(f"perplexity: card {got.ppl:.4f} vs CPU {ref.ppl:.4f} (mean NLL "
                             f"{d_mean:.2e} > {limit:.2e}?), host branch {host.ppl:.4f} "
                             f"({d_branch:.2e} > 1e-5?)")
    own = ppl.host_logits(card, tokens[:256]).astype(np.float16)
    kl = ppl.kl_divergence(card, own, tokens[:256])
    if kl["mean_kl"] > 1e-4 or kl["same_top_rate"] < 1.0:
        raise AssertionError(f"KL against its own logits: {kl}")
    print(f"  perplexity, 2-layer dense model: card {got.ppl:.4f} vs CPU {ref.ppl:.4f} over "
          f"{got.n_tokens} tokens (mean NLL {d_mean:.2e} <= {limit:.2e}); host f64 branch "
          f"{host.ppl:.4f} ({d_branch:.2e} a token <= 1e-5); KL against its own f16 logits "
          f"mean {kl['mean_kl']:.2e} max {kl['max_kl']:.2e}, same top "
          f"{kl['same_top_rate']:.2%}", flush=True)
    del card, cpu

    layers = [dataclasses.replace(lw, **{f: dataclasses.replace(getattr(lw, f), i8p=None)
                                         for f in ("wqkv", "wo", "w_gateup", "w_down")
                                         if isinstance(getattr(lw, f), TCQ4Linear)})
              for lw in weights4b.layers]
    ctx = InferenceContext(cfg4b, dataclasses.replace(weights4b, layers=layers), max_seq=512)
    toks = torch.randint(0, cfg4b.vocab_size, (1024,), generator=torch.Generator().manual_seed(4)
                         ).tolist()
    ppl.compute_perplexity(ctx, toks[:512], n_ctx=512)                 # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = ppl.compute_perplexity(ctx, toks, n_ctx=512)
    dt = time.perf_counter() - t0
    n4, n5 = kernels.LAUNCHES["tcq4_matmul"], kernels.LAUNCHES["tcq4_matmul_i8p"]
    if not math.isfinite(res.ppl) or n4 == 0 or n5 != 0:
        raise AssertionError(f"qwen3-4b perplexity: ppl {res.ppl}, B4 {n4}, B5 {n5} launches")
    print(f"  perplexity at qwen3-4b width without packs: PPL {res.ppl:.1f} (random weights) "
          f"over {res.n_tokens} scored tokens of 2 x 512, {1024 / dt:.0f} tok/s; B4 {n4} and B5 "
          f"{n5} launches", flush=True)
    del ctx


# ---------------------------------------------------------------------------
# The last three TCQ4 kernels (B17 fused, B18 paired-bias, B19 selected
# experts), which no model path calls, in either package
# ---------------------------------------------------------------------------

EXTRA = {"fused": ("tcq4_matmul_fused", "rrs_tpu_torch/csrc/tcq4_fused.cu",
                   "rrs_tpu/ops/tcq4_matmul.py:732"),
         "pb": ("tcq4_matmul_pb", "rrs_tpu_torch/csrc/tcq4_pb.cu", "rrs_tpu/ops/tcq4_matmul.py:453")}
EXTRA_TOL = 1e-3        # bf16 operands, f32 sums in another order
PB_JAX_TOL = 2e-2       # B18 against the oracle and the dequant path (tests/test_tcq4_matmul.py)
def phase_parity_extra(peaks, reports):
    """B17 and B18 at the four qwen3-4b projections, M = 1 and 512 (bf16 x,
    as the model passes it): each against its plain version within
    EXTRA_TOL; B17 bit-equal to B4 on B17-plain's dequantized activations;
    B18 on those activations within PB_JAX_TOL of B4, and on random codes at
    M = 1, 4 and 16 within PB_JAX_TOL of the integer oracle. Each timed
    beside its bound, its plain version and ``torch.matmul`` in bf16 on
    weights dequantized beforehand. Headline: M = 512 summed over the four
    projections, as B4's row; B18 also held bit-equal across two launches.
    The library call reads as many bf16 weight copies as pass 2 x L2. B17's
    bound counts its rotation once per row and superblock (2 M K 256 f32
    FLOPs on the CUDA cores, though the kernel redoes it for every 64-column
    tile) on top of the dot's 2 M K N bf16 FLOPs on the tensor cores; B18's
    adds its 2G-deep bias dot to the dot."""
    import torch

    from rrs_tpu_torch.formats.tcq4 import dequantize_activations_rrs
    from rrs_tpu_torch.models.linear import _hadamard_f32
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    bw, bf16_peak, _, f32_peak = peaks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    had = _hadamard_f32(dev)
    for key, (name, source, replaces) in EXTRA.items():
        reports[key] = Report(name, source, replaces, "operations")
    hold_s = 0.0

    def bound(nbytes, t_ops):
        t_bytes = nbytes / bw * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    for lname, (k, n) in QWEN3_4B_LINEARS.items():
        g = k // 32
        wbytes = k // 2 * n + g * n * 2
        ws = [(torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
               (torch.rand((g, n), generator=gen, device=dev) * 0.01 + 0.001
                ).to(torch.bfloat16)) for _ in range(n_copies(wbytes))]
        gis = [(tm.pack_gi(q), e) for q, e in ws]
        wl = [tm.dequantize_w(q, e).to(torch.bfloat16) for q, e in ws[:n_copies(2 * k * n)]]
        for m in (1, 512):
            reps = 40 if m == 1 else 5
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            got = tm.tcq4_matmul_fused(x, had, *ws[0])
            err, rel = compare(f"fused {lname} M={m}", got,
                               tm.tcq4_matmul_fused_plain(x, had, *ws[0]), EXTRA_TOL)
            a = tm.fused_activations(x, had)
            b4 = tm.tcq4_matmul(a, *ws[0])
            if not torch.equal(got, b4):
                raise AssertionError(f"fused {lname} M={m}: not bit-equal to B4 on its "
                                     f"activations")
            t_ops = 2 * m * k * n / bf16_peak * 1e3 + 2 * m * k * 256 / f32_peak * 1e3
            reports["fused"].add({
                "shape": f"{lname} M={m} K={k} N={n} bf16 x (bit-equal to B4)",
                "max_abs_err": err, "rel_err": rel, "tol": EXTRA_TOL,
                "ms": time_ms(tm.tcq4_matmul_fused, [(x, had, q, e) for q, e in ws], reps),
                "plain_ms": time_ms(tm.tcq4_matmul_fused_plain, [(x, had, *ws[0])], 2),
                "library_ms": time_ms(torch.matmul, [(x, w) for w in wl], reps),
                **bound(wbytes + 256 * 256 * 4 + m * k * 2 + m * n * 4, t_ops)},
                headline=(m == 512))
            a_gi, ag24 = tm.pb_prepare(a)
            got = tm.tcq4_matmul_pb(a_gi, ag24, *gis[0])
            err, rel = compare(f"pb {lname} M={m}", got,
                               tm.tcq4_matmul_pb_plain(a_gi, ag24, *gis[0]), EXTRA_TOL)
            _, rel_b4 = compare(f"pb {lname} M={m} against B4", got, b4, PB_JAX_TOL)
            t_hold = time.perf_counter()
            if not torch.equal(got, tm.tcq4_matmul_pb(a_gi, ag24, *gis[0])):
                raise AssertionError(f"pb {lname} M={m}: two launches differ")
            hold_s += time.perf_counter() - t_hold
            a16 = a.to(torch.bfloat16)
            t_ops = (2 * m * k * n + 2 * m * 2 * g * n) / bf16_peak * 1e3
            reports["pb"].add({
                "shape": f"{lname} M={m} K={k} N={n} (B4 rel {rel_b4:.1e}; two launches "
                         f"bit-equal)",
                "max_abs_err": err, "rel_err": rel, "tol": EXTRA_TOL,
                "ms": time_ms(tm.tcq4_matmul_pb, [(a_gi, ag24, q, e) for q, e in gis], reps),
                "plain_ms": time_ms(tm.tcq4_matmul_pb_plain, [(a_gi, ag24, *gis[0])], 2),
                "library_ms": time_ms(torch.matmul, [(a16, w) for w in wl], reps),
                **bound(wbytes + m * k * 2 + m * 2 * g * 2 + m * n * 4, t_ops)},
                headline=(m == 512))
        worst = 0.0
        for m in (1, 4, 16):
            a_q = torch.randint(-7, 8, (m, k), generator=gen, device=dev, dtype=torch.int8)
            a_s = torch.rand((m, k // 256), generator=gen, device=dev) + 0.5
            a_gi, ag24 = tm.pb_prepare(dequantize_activations_rrs(a_q, a_s))
            got = tm.tcq4_matmul_pb(a_gi, ag24, *gis[0])
            _, rel = compare(f"pb {lname} M={m} against the oracle", got.cpu(),
                             tm.tcq4_matmul_ref(a_q, a_s, ws[0][0], ws[0][1].float()), PB_JAX_TOL)
            worst = max(worst, rel)
        print(f"  pb {lname}: within {worst:.2e} of tcq4_matmul_ref at M = 1, 4, 16 "
              f"(<= {PB_JAX_TOL:.0e})", flush=True)
        del ws, gis, wl
    torch.cuda.empty_cache()
    print(f"  pb holds beyond the plain version (two launches): {hold_s:.2f} s", flush=True)


@contextlib.contextmanager
def extra_oracles(label: str):
    """While open, every TCQ4 linear without a gather that the model applies
    also runs B17 from its own unrotated input (had: the port's f32
    Hadamard), held within EXTRA_TOL of its plain version and bit for bit to
    B4 on B17-plain's dequantized activations; and B18 on those activations
    (its weights packed by ``pack_gi`` once, as each linear runs once a
    chunk), within EXTRA_TOL of its plain version and PB_JAX_TOL of B4. It
    counts the int4 codes that differ from the model's own route (the
    rotation matmul, then the activation quantizer), which sums in another
    order: the knife edge of ROADMAP queue C, reported. Yields the counts."""
    import torch

    from rrs_tpu_torch.formats.tcq4 import quantize_activations_rrs
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.linear import TCQ4Linear, _hadamard_f32, rotate_activations
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    orig = llama.linear_apply
    held = {"n": 0, "fused_rel": 0.0, "pb_rel": 0.0, "pb_b4_rel": 0.0, "flips": 0, "codes": 0,
            "shapes": set()}

    def run(layer, x, reduce_axis=None):
        y = orig(layer, x, reduce_axis=reduce_axis)
        if not isinstance(layer, TCQ4Linear) or layer.gather is not None:
            return y
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        had = _hadamard_f32(x.device)
        shape = (x2.shape[0], *layer.shape)
        out = tm.tcq4_matmul_fused(x2, had, layer.qs, layer.eff)
        _, rel = compare(f"{label}: B17 {shape}", out,
                         tm.tcq4_matmul_fused_plain(x2, had, layer.qs, layer.eff), EXTRA_TOL)
        held["fused_rel"] = max(held["fused_rel"], rel)
        a = tm.fused_activations(x2, had)
        b4 = tm.tcq4_matmul(a, layer.qs, layer.eff)
        if not torch.equal(out, b4):
            raise AssertionError(f"{label}: B17 {shape} differs from B4 on its activations")
        a_gi, ag24 = tm.pb_prepare(a)
        qs_gi = tm.pack_gi(layer.qs)
        pb = tm.tcq4_matmul_pb(a_gi, ag24, qs_gi, layer.eff)
        _, rel = compare(f"{label}: B18 {shape}", pb,
                         tm.tcq4_matmul_pb_plain(a_gi, ag24, qs_gi, layer.eff), EXTRA_TOL)
        held["pb_rel"] = max(held["pb_rel"], rel)
        _, rel = compare(f"{label}: B18 {shape} against B4", pb, b4, PB_JAX_TOL)
        held["pb_b4_rel"] = max(held["pb_b4_rel"], rel)
        q, _ = tm.fused_codes(x2, had)
        r_q, _ = quantize_activations_rrs(rotate_activations(x2, None))
        held["flips"] += int((r_q.to(torch.float32) != q).sum())
        held["codes"] += q.numel()
        held["n"] += 1
        held["shapes"].add(shape)
        return y

    llama.linear_apply = run
    try:
        yield held
    finally:
        llama.linear_apply = orig


def phase_prefill_extra(cfg, weights, reports):
    """One teacher-forced 512-token prefill chunk of qwen3-4b at full width
    (36 layers) under ``extra_oracles``, the launch counts set to 0 just
    before it: every one of the 144 TCQ4 linears (qkv, o, gate-up, down; no
    gather in the fabricated weights) runs B17 and B18 on its own
    activations, held as that context says."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.runtime.context import InferenceContext

    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    seq = ctx.new_sequence()
    tokens = torch.randint(0, cfg.vocab_size, (512,), generator=torch.Generator().manual_seed(9)
                           ).tolist()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    with extra_oracles("qwen3-4b prefill chunk") as held:
        logits = ctx.prefill(seq, tokens, all_logits=False)
        torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in ("tcq4_matmul_fused", "tcq4_matmul_pb")}
    want = QWEN3_4B_TCQ4_PER_STEP
    if not torch.isfinite(logits).all() or held["n"] != want \
            or set(launches.values()) != {want}:
        raise AssertionError(f"qwen3-4b prefill chunk: {held['n']} linears held, launches "
                             f"{launches}, expected {want} each")
    for key, (name, _, _) in EXTRA.items():
        reports[key].entry["held_launches"] = launches[name]
    print(f"  teacher-forced 512-token prefill chunk, 36 layers, in "
          f"{time.perf_counter() - t0:.1f} s: {held['n']} TCQ4 linears, each running B17 (within "
          f"{held['fused_rel']:.2e} of its plain version, bit-equal to B4 on its activations) "
          f"and B18 (within {held['pb_rel']:.2e} of plain, {held['pb_b4_rel']:.2e} of B4); "
          f"launches {launches}; shapes {sorted(held['shapes'])}; int4 codes that differ "
          f"from the rotation matmul's (reported): {held['flips']} of {held['codes']}",
          flush=True)
    del ctx


# ---------------------------------------------------------------------------
# gpt-oss-20b: MXFP4 experts (B11-B13), sliding-window rings with sinks, YaRN
# ---------------------------------------------------------------------------

MX = {"mx_rows": ("mxfp4_matmul_experts_rows", "rrs_tpu/ops/mxfp4_matmul.py:222", "bytes"),
      "mx_all": ("mxfp4_matmul_all_experts", "rrs_tpu/ops/mxfp4_matmul.py:279", "bytes"),
      "mx_mm": ("mxfp4_matmul", "rrs_tpu/ops/mxfp4_matmul.py:157", "operations")}
# (K, N) of the Q8_0 projections of gpt-oss-20b (K padded 2880 -> 3072, N
# padded as the loader pads it)
GPTOSS_Q8 = {"qkv": (3072, 5120, 5120), "o": (4096, 2944, 2880), "lm_head": (3072, 202752, 201088)}
GPTOSS_TOL = 1e-3


def held_rows(label, kernel, plain, a, qs_all, scales, ids, n_exp, tol):
    """B9's or B12's holds beyond the plain version: two launches bit-equal,
    and ids outside [0, E) (one past the end, one negative) beside a repeated
    one, which the kernel clamps: held to the plain version on the clamped
    ids. Returns the first launch's output."""
    import torch

    got = kernel(a, qs_all, scales, ids)
    if not torch.equal(kernel(a, qs_all, scales, ids), got):
        raise AssertionError(f"{label}: two launches differ")
    odd = ids.clone()
    odd[0], odd[-1] = n_exp + 7, -5
    if odd.numel() > 3:
        odd[1] = odd[2]
    compare(f"{label}, ids outside [0, E)", kernel(a, qs_all, scales, odd),
            plain(a, qs_all, scales, odd.clamp(0, n_exp - 1)), tol)
    return got


def phase_parity_gptoss(peaks, reports):
    """B11-B13 against their plain versions at gpt-oss-20b shapes (E = 32
    experts of 2880 x 2880, N padded to 2944): the rows kernel at n_sel = 4
    and 16 (one and four decode lanes, top-4; four K slices and one), also
    with ids outside [0, E) that it clamps, every expert over shared
    activations at T = 64 and over per-expert activations [32, 128, 2880]
    (one 512-token chunk's capacity), each bit-equal across two launches,
    the plain matmul on one expert's gate
    and down projections at M = 300 (and at M = 2048 and 4, untimed at 4);
    B2 at the three Q8 shapes at M = 1
    (qkv and o also at M = 4 and 2048); B3 and B6-B8 at D = 64, G = 8 with
    window 128 over a 640-slot ring and sinks. Each held within GPTOSS_TOL
    (attention 8e-3: its output is bf16) and timed beside its bound, its
    plain version and one PyTorch call on weights dequantized to bf16
    beforehand (torch.matmul / torch.bmm)."""
    import torch

    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.ops import mxfp4_matmul as mx
    from rrs_tpu_torch.ops import q8_matmul as q8
    from rrs_tpu_torch.tools.gemm_ab import rotating_ids

    bw, bf16_peak, _, _ = peaks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    ms = lambda b: b / bw * 1e3                             # noqa: E731
    bound = lambda t_bytes, t_ops: {"bound_ms": max(t_bytes, t_ops),            # noqa: E731
                                    "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    for key, (name, replaces, by) in MX.items():
        reports[key] = Report(name, "rrs_tpu_torch/csrc/mxfp4_matmul.cu", replaces, by)
    e_n, k, n = 32, 2880, 2944
    exp_bytes = k // 2 * n + k // 32 * n                     # one expert's packed weight
    stacks = [(torch.randint(0, 256, (e_n, k // 2, n), generator=gen, device=dev,
                             dtype=torch.uint8),
               torch.randint(118, 123, (e_n, k // 32, n), generator=gen, device=dev,
                             dtype=torch.uint8)) for _ in range(2)]
    w16 = mx.dequant_mxfp4(*stacks[0]).to(torch.bfloat16)   # [32, K, N], 0.54 GB

    # -- B12: decode rows; the id sets take every expert in turn, so the
    # timed launches read their tiles from device memory, not L2
    rep = reports["mx_rows"]
    for n_sel in (4, 16):
        a = torch.randn((n_sel, k), generator=gen, device=dev).to(torch.bfloat16)
        id_sets = rotating_ids(e_n, n_sel // 4, 4, n_copies(n_sel * exp_bytes), gen)
        ids = id_sets[0]
        slices = mx.rows_plan(n_sel, k, n).slices
        got = held_rows(f"mxfp4 rows n_sel={n_sel} ({slices} K slices)",
                        mx.mxfp4_matmul_experts_rows, mx.mxfp4_matmul_experts_rows_plain, a,
                        *stacks[0], ids, e_n, GPTOSS_TOL)
        err, rel = compare(f"mxfp4 rows n_sel={n_sel}", got,
                           mx.mxfp4_matmul_experts_rows_plain(a, *stacks[0], ids), GPTOSS_TOL)
        distinct = int(torch.unique(ids).numel())
        t_bytes = ms(distinct * exp_bytes + n_sel * k * 2 + n_sel * n * 4)
        t_ops = 2 * n_sel * k * n / bf16_peak * 1e3
        sel16 = [w16[i.long()] for i in id_sets[:2]]
        rep.add({"shape": f"n_sel={n_sel} K={k} N={n} E={e_n} ({distinct} experts, {slices} K "
                          f"slices; two launches bit-equal, ids outside [0, E) clamped)",
                 "max_abs_err": err, "rel_err": rel, "tol": GPTOSS_TOL,
                 "ms": time_ms(lambda i: mx.mxfp4_matmul_experts_rows(a, *stacks[0], i),
                               [(i,) for i in id_sets], 40),
                 "plain_ms": time_ms(lambda i: mx.mxfp4_matmul_experts_rows_plain(
                     a, *stacks[0], i), [(i,) for i in id_sets[:2]], 3),
                 "library_ms": time_ms(lambda w: torch.bmm(a[:, None, :], w), [(w,) for w in sel16],
                                       40),
                 **bound(t_bytes, t_ops)}, headline=(n_sel == 4))
        del sel16

    # -- B13: shared T = 64 (batched decode) and per-expert [32, 128, K]
    rep = reports["mx_all"]
    for label, shape in (("shared T=64", (64, k)), ("per-expert C=128", (e_n, 128, k))):
        a = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        got = mx.mxfp4_matmul_all_experts(a, *stacks[0])
        err, rel = compare(f"mxfp4 all experts {label}", got,
                           mx.mxfp4_matmul_all_experts_plain(a, *stacks[0]), GPTOSS_TOL)
        if not torch.equal(mx.mxfp4_matmul_all_experts(a, *stacks[0]), got):
            raise AssertionError(f"mxfp4 all experts {label}: two launches differ")
        t = shape[-2]
        t_bytes = ms(e_n * exp_bytes + a.numel() * 2 + e_n * t * n * 4)
        t_ops = 2 * e_n * t * k * n / bf16_peak * 1e3
        lib = (lambda w: torch.matmul(a, w)) if a.dim() == 2 else (lambda w: torch.bmm(a, w))
        rep.add({"shape": f"{label} K={k} N={n} E={e_n} (two launches bit-equal)",
                 "max_abs_err": err, "rel_err": rel, "tol": GPTOSS_TOL,
                 "ms": time_ms(lambda q, s_: mx.mxfp4_matmul_all_experts(a, q, s_), stacks, 10),
                 "plain_ms": time_ms(lambda q, s_: mx.mxfp4_matmul_all_experts_plain(a, q, s_),
                                     stacks, 2),
                 "library_ms": time_ms(lib, [(w16,)], 10),
                 **bound(t_bytes, t_ops)}, headline=(label.startswith("shared")))

    # -- B11: the overflow scan's per-expert matmul at a 300-token prompt's M,
    # a served 4 x 512 prefill chunk's and a decode step's (the split-K
    # stream), each held to plain and across two launches (bit-equal: the K
    # slices are summed in a fixed order); timed at M = 300 and 2048
    rep = reports["mx_mm"]
    for label, ei, m in (("gate", 3, 300), ("down", 17, 300), ("gate", 5, 2048),
                         ("down", 9, 4)):
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        qs, sx = stacks[0][0][ei], stacks[0][1][ei]
        got = mx.mxfp4_matmul(a, qs, sx)
        err, rel = compare(f"mxfp4_matmul {label} M={m}", got, mx.mxfp4_matmul_plain(a, qs, sx),
                           GPTOSS_TOL)
        if not torch.equal(mx.mxfp4_matmul(a, qs, sx), got):
            raise AssertionError(f"mxfp4_matmul {label} M={m}: two launches differ")
        shape = {"shape": f"one expert's {label} M={m} K={k} N={n} "
                          f"({mx.splitk_plan(m, k, n).slices} K slices; two launches bit-equal)",
                 "max_abs_err": err, "rel_err": rel, "tol": GPTOSS_TOL}
        if m != 4:
            t_bytes = ms(exp_bytes + m * k * 2 + m * n * 4)
            t_ops = 2 * m * k * n / bf16_peak * 1e3
            reps = 32 if m < 2048 else 8
            shape.update(
                ms=time_ms(lambda e_: mx.mxfp4_matmul(a, stacks[0][0][e_], stacks[0][1][e_]),
                           [(e_,) for e_ in range(e_n)], reps),
                plain_ms=time_ms(lambda e_: mx.mxfp4_matmul_plain(
                    a, stacks[0][0][e_], stacks[0][1][e_]), [(e_,) for e_ in range(4)], 4),
                library_ms=time_ms(lambda e_: torch.matmul(a, w16[e_]),
                                   [(e_,) for e_ in range(e_n)], reps),
                **bound(t_bytes, t_ops))
        rep.add(shape, headline=(label == "gate" and m == 300))
    del stacks, w16
    torch.cuda.empty_cache()

    # -- B2 at the gpt-oss Q8 shapes: decode M = 1, a served decode step's
    # M = 4 and a served prefill chunk's M = 2048 (the lm_head at M = 1); the
    # library call reads as many bf16 copies as the kernel reads int8 ones
    rep = reports["q8"]
    for lname, (kq, nq, n_log) in GPTOSS_Q8.items():
        qw = torch.randint(-127, 128, (kq, nq), generator=gen, device=dev, dtype=torch.int8)
        qsc = 2.0 ** torch.randint(-11, -9, (kq // 32, nq), generator=gen, device=dev).float()
        wl = (qw.float().reshape(kq // 32, 32, nq) * qsc[:, None]).reshape(kq, nq).to(
            torch.bfloat16)
        copies = [(qw, qsc)] + [(qw.clone(), qsc.clone()) for _ in range(n_copies(kq * nq) - 1)]
        wls = [wl] + [wl.clone() for _ in range(n_copies(2 * kq * nq) - 1)]
        for m in ((1,) if lname == "lm_head" else (1, 4, 2048)):
            a = torch.randn((m, kq), generator=gen, device=dev).to(torch.bfloat16)
            err, rel = compare(f"q8_matmul gpt-oss {lname} M={m}", q8.q8_matmul(a, qw, qsc),
                               q8.q8_matmul_plain(a, qw, qsc), GPTOSS_TOL)
            t_bytes = ms(kq * nq + kq // 32 * nq * 4 + m * kq * 2 + m * nq * 4)
            reps = 20 if m < 2048 else 5
            rep.add({"shape": f"gpt-oss {lname} M={m} K={kq} N={nq}", "max_abs_err": err,
                     "rel_err": rel, "tol": GPTOSS_TOL,
                     "ms": time_ms(lambda q_, s_: q8.q8_matmul(a, q_, s_), copies, reps),
                     "plain_ms": time_ms(lambda q_, s_: q8.q8_matmul_plain(a, q_, s_),
                                         copies[:1], 3),
                     "library_ms": time_ms(lambda w: torch.matmul(a, w), [(w,) for w in wls],
                                           reps),
                     **bound(t_bytes, 2 * m * kq * nq / bf16_peak * 1e3)}, headline=False)
        del qw, qsc, wl, wls, copies

    # -- B3, B6-B8: one decode row per lane over a 640-slot ring (window 128,
    # sinks), 2 lanes at positions 1000 and 700 (the rings have wrapped)
    h, hkv, d, s, win = 64, 8, 64, 640, 128
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    starts = (1000, 700)
    pos = torch.tensor([[st] for st in starts], device=dev, dtype=torch.int32)
    sinks = torch.randn((h,), generator=gen, device=dev)
    kv_pos = torch.arange(s, device=dev)
    off = torch.remainder(pos[:, :, None] - kv_pos, s)
    mask = (pos[:, :, None] - off > pos[:, :, None] - win)[:, None]          # [B, 1, 1, S]
    q = torch.randn((2, 1, h, d), generator=gen, device=dev).to(torch.bfloat16)
    for key, codec in (("fa", "bf16"), ("fa_q8", "q8"), ("fa_q4hp", "q4hp"), ("fa_q4", "q4")):
        if codec == "bf16":
            caches = [tuple(torch.randn((2, hkv, s, d), generator=gen, device=dev).to(
                torch.bfloat16) for _ in range(2)) for _ in range(4)]
            kern, plain = fa.flash_attention, fa.attention_ref
            code_bytes = 2 * d
            lib_sets = [(c[0], c[1]) for c in caches[:2]]
        else:
            caches = [kvq_caches(codec, 2, hkv, s, d, gen) for _ in range(4)]
            kern, plain = getattr(fa, KVQ[key][0]), fa.attention_kvq_ref
            code_bytes = (d if codec == "q8" else d // 2) + 4
            from rrs_tpu_torch.runtime import kv_codec

            lib_sets = [(kv_codec.dequantize(c[0], c[1]).to(torch.bfloat16),
                         kv_codec.dequantize(c[2], c[3]).to(torch.bfloat16)) for c in caches[:2]]
        kw = dict(window=win, sinks=sinks)
        got = kern(q, *caches[0], pos, scale, **kw)
        err, rel = compare(f"{kern.__name__} gpt-oss ring", got, plain(q, *caches[0], pos, scale,
                                                                        **kw), 8e-3)
        # the bound reads the window's rows only
        t_bytes = ms(2 * 2 * hkv * win * code_bytes + 2 * 2 * h * d * 2)
        t_ops = 4 * d * 2 * h * win / bf16_peak * 1e3
        # SDPA has no sinks: the yardstick attends the same window without them
        reports[key].add({"shape": f"gpt-oss ring T=1 B=2 S={s} window {win} sinks H={h} "
                                   f"Hkv={hkv} D={d}",
                          "max_abs_err": err, "rel_err": rel, "tol": 8e-3,
                          "ms": time_ms(lambda *c: kern(q, *c, pos, scale, **kw), caches, 40),
                          "plain_ms": time_ms(lambda *c: plain(q, *c, pos, scale, **kw),
                                              caches[:2], 5),
                          **sdpa_ms(q, lib_sets, mask, g, scale, 40),
                          **bound(t_bytes, t_ops)}, headline=False)
        del caches, lib_sets
    torch.cuda.empty_cache()


def gptoss_small_cfg():
    """gpt-oss at reduced widths (E = 1024, 32 heads on 4 kv heads x 64, 32
    experts of 1024 top-4, 2 layers: one sliding with window 128, YaRN),
    every K and N a multiple of 64 so that MXFP4 applies."""
    from rrs_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="gpt-oss", n_layers=2, n_embd=1024, n_heads=32, n_kv_heads=4,
                       head_dim=64, n_ff=1024, vocab_size=4096, context_length=4096,
                       rope_theta=150000.0, rope_scaling_type="yarn", rope_scale_factor=32.0,
                       rope_orig_context=4096, n_experts=32, n_experts_used=4, n_ff_exp=1024,
                       swa_window=128, swa_pattern=2, attn_bias=True,
                       expert_softmax_weight=True, moe_act="swiglu_oai")


@contextlib.contextmanager
def moe_branches():
    """While open, counts the moe_ffn branches taken: rows (three B12 or B9
    calls), all experts (B13 twice over shared activations, then once
    per-expert), the capacity dispatch and its overflow scan. Yields the
    counts, filled in on leaving."""
    from rrs_tpu_torch.models import moe

    names = ("mxfp4_matmul_experts_rows", "mxfp4_matmul_all_experts",
             "tcq4_matmul_experts_rows", "tcq4_matmul_all_experts", "_capacity_dispatch")
    originals = {name: getattr(moe, name) for name in names}
    n = {"rows": 0, "shared": 0, "dispatch": 0, "fallback": 0}

    def rows(orig):
        def run(*args):
            n["rows"] += 1
            return orig(*args)
        return run

    def all_experts(orig):
        def run(a, *args):
            n["shared"] += a.dim() == 2
            return orig(a, *args)
        return run

    def dispatch(*args, **kwargs):
        n["dispatch"] += 1
        *head, fallback = args

        def counted_fallback():
            n["fallback"] += 1
            return fallback()
        return originals["_capacity_dispatch"](*head, counted_fallback, **kwargs)

    branches: dict = {}
    for name in names[:4]:
        setattr(moe, name, (rows if "rows" in name else all_experts)(originals[name]))
    moe._capacity_dispatch = dispatch
    try:
        yield branches
    finally:
        for name, orig in originals.items():
            setattr(moe, name, orig)
        branches.update(rows=n["rows"] // 3, all_experts=n["shared"] // 2,
                        capacity=n["dispatch"] - n["fallback"], fallback=n["fallback"])


@contextlib.contextmanager
def routes_replayed(recorded: list):
    """While open, moe.route returns, call by call, the expert ids (and
    weights) recorded from another run wherever its own ids differ; yields
    {"calls", "flipped": selections that differed}."""
    import torch

    from rrs_tpu_torch.models import moe

    orig = moe.route
    seen = {"calls": 0, "flipped": 0}

    def replay(cfg, mw, x2):
        ti, tv = orig(cfg, mw, x2)
        ri, rv = recorded[seen["calls"]]
        seen["calls"] += 1
        diff = int((ti.cpu() != ri).sum())
        if diff:
            seen["flipped"] += diff
            return ri.to(ti.device), rv.to(tv.device)
        return ti, tv

    moe.route = replay
    try:
        yield seen
    finally:
        moe.route = orig


def _states(ctx, lane: int) -> list:
    """A recurrent or hybrid context's per-lane states (conv / token shift
    and ssm / wkv), on the host in f32; [] for a KV cache."""
    kv = ctx.kv
    return [t[lane].float().cpu() for t in getattr(kv, "conv", []) + getattr(kv, "ssm", [])
            if t is not None]


def card_vs_cpu(label, cfg, w_cpu, prompts, expect, held_logits: bool, kv_quant="none"):
    """The same weights and prompts on the CPU and on the card (each prompt's
    last prefill logits and one decode step's), through the context
    ``make_context`` picks, the card's expert ids replayed where they differ
    from the CPU's, every kernel launch held to its plain version; the
    logits within GLUE_TOL (``held_logits``) or their drift reported; a
    recurrent context's states after each prefill reported (rel L2 of all
    its layers' states). Returns the rel L2 by prompt and stage."""
    import torch

    from rrs_tpu_torch.models import llama, moe
    from rrs_tpu_torch.runtime.recurrent import make_context

    orig = moe.route
    recorded, logits = [], {}

    def record(c, mw, x2):
        ti, tv = orig(c, mw, x2)
        recorded.append((ti.clone(), tv.clone()))
        return ti, tv

    moe.route = record
    states = {}
    try:
        cpu = make_context(cfg, w_cpu, max_seq=1024, device="cpu", kv_quant=kv_quant)
        for name, p in prompts.items():
            seq = cpu.new_sequence()
            last = cpu.prefill(seq, p)[-1].float()
            states[name, "cpu"] = _states(cpu, cpu.kv.lane_of(seq))
            logits[name, "cpu"] = (last, cpu.decode({seq: 11})[seq].float())
            cpu.kv.seq_rm(seq)
    finally:
        moe.route = orig
    ctx = make_context(cfg, llama.to_device(w_cpu, "cuda"), max_seq=1024, kv_quant=kv_quant)
    with held_to_plain(label, expect) as seen, routes_replayed(recorded) as replay:
        for name, p in prompts.items():
            seq = ctx.new_sequence()
            last = ctx.prefill(seq, p)[-1].float().cpu()
            states[name, "cuda"] = _states(ctx, ctx.kv.lane_of(seq))
            logits[name, "cuda"] = (last, ctx.decode({seq: 11})[seq].float().cpu())
            ctx.kv.seq_rm(seq)
        torch.cuda.synchronize()
    rels = {}
    for name in prompts:
        for i, stage in enumerate(("prefill", "decode")):
            got, ref = logits[name, "cuda"][i], logits[name, "cpu"][i]
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{label} {name} {stage}: bad logits")
            rels[f"{name} {stage}"] = rel = ((got - ref).norm() / ref.norm()).item()
            if held_logits and rel > GLUE_TOL:
                raise AssertionError(f"{label} {name} {stage}: card vs CPU rel L2 {rel:.4f} > "
                                     f"{GLUE_TOL}")
    print(f"  {label}: each launch vs its plain version (max rel): "
          + (", ".join(f"{k} {v[0]:.2e} <= {SMALL_TOL[k]:.0e}" for k, v in seen.items()) or "none")
          + f"; {replay['flipped']} expert selections replayed over {replay['calls']} routing "
          f"calls; logits card vs CPU, rel L2 " + ("<= " + str(GLUE_TOL) if held_logits
                                                   else "(reported)") + ": "
          + ", ".join(f"{k} {v:.4f}" for k, v in rels.items()), flush=True)
    if any(states.values()):
        st_rel = {}
        for name in prompts:
            got, ref = states[name, "cuda"], states[name, "cpu"]
            num = sum(float((g - r).norm()) ** 2 for g, r in zip(got, ref)) ** 0.5
            den = sum(float(r.norm()) ** 2 for r in ref) ** 0.5
            if not all(torch.isfinite(g).all() for g in got):
                raise AssertionError(f"{label} {name}: non-finite recurrent states")
            st_rel[name] = num / max(den, 1e-30)
        print(f"  {label}: recurrent states after prefill, card vs CPU (rel L2 over "
              f"{len(ref)} state tensors, reported): "
              + ", ".join(f"{k} {v:.4f}" for k, v in st_rel.items()), flush=True)
    del ctx
    return rels


def phase_gptoss_small_reference():
    """A 2-layer gpt-oss model (gptoss_small_cfg, fabricated weights drawn on
    the CPU) on the card against the same weights on the CPU: prompts of 40
    tokens (B13 over shared activations), 300 random ones (capacity
    dispatch) and 300 copies of one token (overflow: the B11 scan), each
    with one decode step (B12). The card replays the CPU's expert ids where
    its own differ (a flipped expert is no tolerance question; the flips are
    counted) and every kernel launch is held to its plain version on its
    inputs; the logits are held within GLUE_TOL relative L2."""
    import torch

    from rrs_tpu_torch.models import llama

    cfg = gptoss_small_cfg()
    w_cpu = llama.fabricated_gptoss_weights(cfg, seed=1, device="cpu")
    rng = torch.Generator().manual_seed(3)
    prompts = {"40": torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist(),
               "300 random": torch.randint(0, cfg.vocab_size, (300,), generator=rng).tolist(),
               "300 copies": [77] * 300}
    with moe_branches() as paths:
        card_vs_cpu("small gpt-oss (2 layers, E=1024, 32 experts top-4)", cfg, w_cpu, prompts,
                    MXFP4_KERNELS | {"q8_matmul", "flash_attention"}, held_logits=True)
    print(f"  MoE paths taken on the CPU and the card together: {paths}", flush=True)


GPTOSS_COUNTERS = {"q8": "q8_matmul", "fa": "flash_attention", "mx_rows": MX["mx_rows"][0],
                   "mx_all": MX["mx_all"][0], "mx_mm": MX["mx_mm"][0]}


# the layers of gpt-oss-20b's full-width runs (24 published), cut so that the
# script fits its time limit beside phases 18 and 19: three sliding and three
# full layers (12 before phase 19 came)
GPTOSS_LAYERS = 6


def phase_gptoss_generate(reports):
    """``generate`` at full gpt-oss-20b width, cut to GPTOSS_LAYERS of its 24
    layers (fabricated weights, bf16 KV over 640-slot rings on the sliding
    half): greedy prompts of
    5 (the rows kernel in prefill), 40 (all experts, shared activations),
    300 random and 300 copies of one token (the overflow scan: the 212
    padding rows of the 512 bucket, all token 0, route alike and overflow the
    capacity, as in the JAX package), and 512 random ones (the capacity
    dispatch, B13 over per-expert activations), MOE_NEW new tokens each; every
    kernel's launches counted from 0 and the MoE branches taken; the 512-token
    prefill run twice and held bit-equal; a decode profile; then ``generate``
    over q8 rings. Returns (cfg, weights)."""
    import dataclasses

    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import PRESETS
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg = dataclasses.replace(PRESETS["gpt-oss-20b"], n_layers=GPTOSS_LAYERS)
    t0 = time.perf_counter()
    weights = llama.fabricated_gptoss_weights(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(weights))
    print(f"  fabricated gpt-oss-20b weights ({w_bytes / GB:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator().manual_seed(0)
    prompts = {"5": torch.randint(0, cfg.vocab_size, (5,), generator=rng).tolist(),
               "40": torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist(),
               "300 random": torch.randint(0, cfg.vocab_size, (300,), generator=rng).tolist(),
               "300 copies": [1234] * 300,
               "512 random": torch.randint(0, cfg.vocab_size, (512,), generator=rng).tolist()}
    warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    warm.generate(prompts["5"], 2)                            # first-call set-up
    del warm
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    outs = {}
    with moe_branches() as branches:
        for name, p in prompts.items():
            seq = ctx.new_sequence()
            first = ctx.prefill(seq, p)[-1]
            ctx.kv.seq_rm(seq)
            if not torch.isfinite(first).all():
                raise AssertionError(f"gpt-oss generate: non-finite prefill logits, prompt "
                                     f"{name}")
            outs[name] = ctx.generate(p, MOE_NEW)
        torch.cuda.synchronize()
    launches = {key: kernels.LAUNCHES[n] for key, n in GPTOSS_COUNTERS.items()}
    for name, out in outs.items():
        if len(out) != MOE_NEW or not all(0 <= tok < cfg.vocab_size for tok in out):
            raise AssertionError(f"gpt-oss generate {name}: {len(out)} tokens: {out}")
    perf = ctx.perf()
    print(f"  requests: prompts 5/40/300 random/300 copies/512 random x {MOE_NEW} new tokens "
          f"(each prompt "
          f"prefilled once more first, its logits checked finite); prefill {perf['n_p_eval']} "
          f"tok @ {perf['pp_tok_per_s']:.1f} tok/s, decode {perf['n_eval']} tok @ "
          f"{perf['tg_tok_per_s']:.2f} tok/s ({perf['t_eval_ms'] / max(perf['n_eval'], 1):.3f} "
          f"ms/token); KV resident {ctx.kv.nbytes() / GB:.4f} GB (rings {ctx.kv.sizes[0]} "
          f"slots, full layers {ctx.kv.sizes[1]}); peak memory "
          f"{torch.cuda.max_memory_allocated() / GB:.2f} GB", flush=True)
    print(f"  greedy tokens: " + "; ".join(f"{k}: {v[:6]}..." for k, v in outs.items()),
          flush=True)
    print(f"  MoE branches: {branches}; launches on the gpt-oss path: {launches}",
          flush=True)
    for key, n in launches.items():
        if n == 0:
            raise AssertionError(f"gpt-oss generate: kernel {key} was never launched")
        reports[key].entry["launches" if key.startswith("mx") else "launches_gptoss"] = n
    capacity_repeat(ctx, prompts["512 random"], "gpt-oss-20b")
    profile_decode(ctx, prompts["40"], label="gpt-oss-20b")
    profile_expert_prefill(ctx, "gpt-oss-20b", "mxfp4_matmul_all_experts")
    del ctx

    warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024, kv_quant="q8")
    warm.generate(prompts["5"], 2)
    del warm
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024, kv_quant="q8")
    torch.cuda.synchronize()
    kernels.reset_launches()
    q8_outs = [ctx.generate(prompts[n], MOE_NEW) for n in ("40", "300 random")]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if any(len(o) != MOE_NEW for o in q8_outs) or launches["flash_attention_q8"] == 0 \
            or launches["flash_attention"] != 0:
        raise AssertionError(f"gpt-oss generate, q8 KV: {[len(o) for o in q8_outs]} tokens, "
                             f"launches {launches}")
    reports["fa_q8"].entry["launches_gptoss"] = launches["flash_attention_q8"]
    perf = ctx.perf()
    print(f"  generate, q8 KV over the rings: prompts 40/300 x {MOE_NEW} new tokens; prefill "
          f"{perf['pp_tok_per_s']:.1f} tok/s, decode {perf['tg_tok_per_s']:.2f} tok/s; KV "
          f"resident {ctx.kv.nbytes() / GB:.4f} GB; greedy tokens {q8_outs[0][:6]}... (bf16 KV: "
          f"{outs['40'][:6]}...); launches {launches}", flush=True)
    del ctx
    return cfg, weights


def _tensors(obj):
    """Every tensor of a weights tree."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


SERVE_MOE_LENGTHS = (1000, 2000, 1000, 2000)     # two greedy, then two sampled


def serve_four(cfg, weights, label, counters):
    """The server in-process: 4 slots, ctx 4096, bf16 KV (rings on sliding
    layers). Four concurrent completions (SERVE_MOE_LENGTHS tokens, two
    greedy, two sampled, SERVE_NEW new tokens each) must finish by length with
    SERVE_NEW tokens; the device decode runs must be used; a model with sliding layers
    frees its lanes on release (the others keep them as a prompt cache).
    Returns (the context, launches by report key, MoE branches)."""
    import torch
    from http.server import ThreadingHTTPServer

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.serving.engine import Engine
    from rrs_tpu_torch.serving.server import ServerState, make_handler

    ctx = InferenceContext(cfg, weights, n_lanes=4, max_seq=4096)
    engine = Engine(ctx)
    state = ServerState(cfg, synthetic_vocab(cfg.vocab_size), engine, {}, f"{label}-fabricated")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    rng = torch.Generator().manual_seed(13)
    jobs = []
    for i, n in enumerate(SERVE_MOE_LENGTHS):
        body = {"prompt": torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist(),
                "max_tokens": SERVE_NEW, "seed": i}
        if i < 2:
            body["temperature"] = 0.0
        jobs.append((f"{label} completion {n} {'greedy' if i < 2 else 'sampled'} #{i}", body))
    results: dict = {}

    def run(job):
        name, body = job
        t0 = time.perf_counter()
        status, data = _http(port, "POST", "/v1/completions", body)
        results[name] = (status, data, t0, time.perf_counter(), body)

    runs0 = engine.n_decode_runs
    engine.start()
    server_thread.start()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t_start = time.perf_counter()
        threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
        with moe_branches() as branches:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"{label} serving: a request did not finish within 900 s")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = {key: kernels.LAUNCHES[n] for key, n in counters.items()}
        peak = torch.cuda.max_memory_allocated() / GB
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    if engine._thread.is_alive():
        raise AssertionError(f"{label} serving: the engine thread did not stop")
    decode_spans, n_decode = [], 0
    for name, (status, data, t0, t1, body) in results.items():
        if status != 200:
            raise AssertionError(f"{label} serving: {name} answered {status}: {data[:300]!r}")
        out = json.loads(data)
        reason = out["choices"][0]["finish_reason"]
        n_out = out["usage"]["completion_tokens"]
        if reason != "length" or n_out != SERVE_NEW:
            raise AssertionError(f"{label} serving: {name} finished by {reason} with {n_out} "
                                 f"tokens")
        tm = out["timings"]
        start = t0 + tm["prompt_ms"] / 1e3
        decode_spans.append((start, start + tm["predicted_ms"] / 1e3))
        n_decode += n_out - 1
        print(f"  {name}: {n_out} tokens ({reason}), time to first token {tm['prompt_ms']:.1f} "
              f"ms, decode {(n_out - 1) / max(tm['predicted_ms'] / 1e3, 1e-9):.2f} tok/s",
              flush=True)
    runs = engine.n_decode_runs - runs0
    busy = _union_seconds(decode_spans)
    print(f"  {label} served {len(results)} requests in {wall:.1f} s; prompt tokens "
          f"{sum(SERVE_MOE_LENGTHS)}; decode tok/s summed over the 4 slots "
          f"{n_decode / busy:.2f} ({n_decode} tokens over {busy:.1f} s); {runs} device decode "
          f"runs; KV resident {ctx.kv.nbytes() / GB:.3f} GB; peak memory {peak:.2f} GB; MoE "
          f"branches {branches}; launches {launches}", flush=True)
    if runs == 0:
        raise AssertionError(f"{label} serving: no device decode run was launched")
    if cfg.any_swa and any(s is not None for s in ctx.kv.seq_ids):
        raise AssertionError(f"{label} serving: lanes not freed: {ctx.kv.seq_ids}")
    return ctx, launches, branches


def phase_serving_gptoss(cfg, weights, reports):
    """``serve_four`` at gpt-oss-20b width; every kernel of the path launched
    (B11 or B13 in the prefill). Returns the context."""
    ctx, launches, _ = serve_four(cfg, weights, "gpt-oss", GPTOSS_COUNTERS)
    for key in ("q8", "fa", "mx_rows"):
        if launches[key] == 0:
            raise AssertionError(f"gpt-oss serving: kernel {key} was never launched")
    if launches["mx_all"] + launches["mx_mm"] == 0:
        raise AssertionError("gpt-oss serving: no prefill MoE kernel (B11 / B13) was launched")
    for key, n in launches.items():
        reports[key].entry["launches_serve_gptoss" if not key.startswith("mx")
                           else "launches_serve"] = n
    return ctx


def served_steps_held(ctx, label, expect):
    """One teacher-forced 4-lane prefill chunk (three sequences of 500, 300
    and 40 tokens in one T = 512 step, lane 3 dead) and one 4-lane decode
    step, every kernel launch held to its plain version on the very inputs
    it got; ``expect``: the kernels that must be reached. Returns what was
    held."""
    import torch

    kv = ctx.kv
    for seq in [s for s in kv.seq_ids if s is not None]:
        kv.seq_rm(seq)
    rng = torch.Generator().manual_seed(17)
    seqs = [ctx.new_sequence() for _ in range(3)]
    chunks = {seq: torch.randint(2, ctx.cfg.vocab_size, (n,), generator=rng).tolist()
              for seq, n in zip(seqs, (500, 300, 40))}
    t0 = time.perf_counter()
    with held_to_plain(f"{label} served steps", expect) as seen, moe_branches() as branches:
        last = ctx.prefill_multi(chunks)
        out = ctx.decode({seq: int(last[seq].argmax()) for seq in seqs})
        torch.cuda.synchronize()
    for seq in seqs:
        if not torch.isfinite(out[seq]).all():
            raise AssertionError(f"{label} served steps: non-finite decode logits for {seq}")
        kv.seq_rm(seq)
    for name, (worst, shapes) in seen.items():
        tol = SMALL_TOL[name] if name != "tcq4_matmul_i8p" else BF16_OUT_TOL
        print(f"  {label} served steps, {name}: every launch within {tol:.0e} of its plain "
              f"version (max rel {worst:.2e}); shapes {sorted(shapes)[:6]}", flush=True)
    print(f"  {label} served prefill + decode step held to the plain versions in "
          f"{time.perf_counter() - t0:.1f} s; MoE branches {branches}", flush=True)
    return seen


def phase_gptoss_served_steps(ctx):
    """``served_steps_held`` at gpt-oss-20b width; the prefill must launch B11
    or B13."""
    seen = served_steps_held(ctx, "gpt-oss",
                             {"q8_matmul", "flash_attention", "mxfp4_matmul_experts_rows"})
    if not seen.keys() & {"mxfp4_matmul", "mxfp4_matmul_all_experts"}:
        raise AssertionError("gpt-oss served steps: the prefill launched neither B11 nor B13")
    # unheld, under the profiler: B11's share of an overflow-scan prefill step
    profile_prefill(ctx, (500, 300, 40), "gpt-oss-20b served", "mxfp4_matmul")


def profile_expert_prefill(ctx, label: str, focus: str):
    """A one-lane prefill step of a 40-token prompt under torch.profiler (its
    64-token bucket takes every expert at once: B13 over shared rows on
    gpt-oss, the capacity dispatch through B10 on Qwen3-30B-A3B): the
    all-experts kernel's share of the step. Fails if the step did not launch
    it."""
    with moe_branches() as branches:
        prof = profile_prefill(ctx, (40,), f"{label} 40-token", focus)
    if prof and not prof["by_kernel"].get(focus):
        raise AssertionError(f"{label} 40-token prefill profile: no {focus} device time "
                             f"(MoE branches {branches})")


def capacity_repeat(ctx, prompt, label):
    """One prefill of ``prompt`` run twice on a fresh sequence: every MoE layer
    must take the capacity dispatch (no overflow scan), and the logits of the
    two runs must be equal bit for bit (the combine sums each token's k rows
    in a fixed order; the all-experts kernels use no atomics)."""
    import torch

    outs = []
    with moe_branches() as branches:
        for _ in range(2):
            seq = ctx.new_sequence()
            outs.append(ctx.prefill(seq, prompt).clone())
            ctx.kv.seq_rm(seq)
        torch.cuda.synchronize()
    if branches["capacity"] == 0 or branches["fallback"]:
        raise AssertionError(f"{label} capacity repeat: branches {branches}, not the capacity "
                             f"dispatch alone")
    if not torch.equal(outs[0], outs[1]):
        diff = (outs[0].float() - outs[1].float()).abs().max().item()
        raise AssertionError(f"{label}: a capacity-path prefill run twice differs by {diff:.3e}")
    print(f"  {label}: a {len(prompt)}-token capacity-path prefill run twice gives bit-equal "
          f"logits ({tuple(outs[0].shape)}; MoE branches {branches})", flush=True)


# -- Qwen3-30B-A3B ---------------------------------------------------------------

# the layers of Qwen3-30B-A3B's and Qwen2-57B-A14B's full-width runs (48
# and 28 published): cut so that the script fits its time limit (24 and 14
# until phase 17 came, when the script took 953 s without it on an H100
# 80GB HBM3 at 700 W; Qwen3-30B-A3B 12 until phase 19 came, when it took
# 926 s without it)
QWEN3MOE_LAYERS = 6
QWEN2MOE_LAYERS = 7
# The GGUF metadata of Qwen3-30B-A3B as its published config.json gives it
# (Hugging Face Qwen/Qwen3-30B-A3B; llama.cpp's converter writes these keys)
QWEN3_30B_A3B_GGUF = {
    "general.architecture": "qwen3moe", "qwen3moe.block_count": 48,
    "qwen3moe.context_length": 40960, "qwen3moe.embedding_length": 2048,
    "qwen3moe.feed_forward_length": 6144, "qwen3moe.attention.head_count": 32,
    "qwen3moe.attention.head_count_kv": 4, "qwen3moe.attention.key_length": 128,
    "qwen3moe.attention.value_length": 128,
    "qwen3moe.attention.layer_norm_rms_epsilon": 1e-6, "qwen3moe.rope.freq_base": 1e6,
    "qwen3moe.expert_count": 128, "qwen3moe.expert_used_count": 8,
    "qwen3moe.expert_feed_forward_length": 768, "qwen3moe.norm_topk_prob": True,
    "qwen3moe.vocab_size": 151936}
# report key -> (kernel, TPU kernel it replaces)
TQ = {"tq_rows": ("tcq4_matmul_experts_rows", "rrs_tpu/ops/tcq4_matmul.py:654"),
      "tq_all": ("tcq4_matmul_all_experts", "rrs_tpu/ops/tcq4_matmul.py:595"),
      "tq_sel": ("tcq4_matmul_experts", "rrs_tpu/ops/tcq4_matmul.py:536")}
QWEN3MOE_TOL = 1e-3


def phase_parity_qwen3moe(peaks, reports):
    """B9, B10 and B19 against their plain versions at the Qwen3-30B-A3B
    shapes (E = 128 experts; gate / up K 2048 -> N 768, down K 768 -> N
    2048): the rows kernel at n_sel = 8 and 32 (one and four decode lanes,
    top-8; eight, three, two and one K slices), also with ids outside [0, E)
    that it clamps, every expert over per-expert activations [128, 64, K] (a
    512-token chunk's capacity; bf16 rows, then f32 ones), [128, 40, K] (a
    capacity below the 64-row tile) and over shared activations at T = 64,
    each held bit-equal across two launches, and
    the selected-experts kernel (no model path calls it) at n_sel = 8 over
    shared rows at M = 1 and 40 with bf16 and f32 eff, bit-equal to B10 on
    the same experts where eff is bf16. Held within QWEN3MOE_TOL relative and
    timed beside the bound, the plain version and ``torch.bmm`` /
    ``torch.matmul`` on experts dequantized to bf16 (and, for B9 and B19,
    gathered) beforehand. The id sets take every expert in turn and a stack
    (113 MB) exceeds L2, so the timed launches read from device memory; the
    gathered bf16 copies rotate past 2 x L2 too."""
    import torch

    from rrs_tpu_torch.ops import tcq4_matmul as tm
    from rrs_tpu_torch.tools.gemm_ab import rotating_ids

    bw, bf16_peak, _, _ = peaks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    ms = lambda b: b / bw * 1e3                             # noqa: E731
    bound = lambda t_bytes, t_ops: {"bound_ms": max(t_bytes, t_ops),            # noqa: E731
                                    "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    for key, (name, replaces) in TQ.items():
        reports[key] = Report(name, "rrs_tpu_torch/csrc/tcq4_experts.cu", replaces, "bytes")
    e_n = 128
    for proj, (k, n) in (("gate_up", (2048, 768)), ("down", (768, 2048))):
        exp_bytes = k // 2 * n + k // 32 * n * 2
        qs = torch.randint(0, 256, (e_n, k // 2, n), generator=gen, device=dev, dtype=torch.uint8)
        eff = (torch.rand((e_n, k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
               ).to(torch.bfloat16)
        w16 = torch.stack([tm.dequantize_w(qs[e], eff[e]).to(torch.bfloat16)
                           for e in range(e_n)])             # [128, K, N]

        rep = reports["tq_rows"]
        for n_sel in (8, 32):
            a = torch.randn((n_sel, k), generator=gen, device=dev).to(torch.bfloat16)
            # one lane's 8 distinct experts, four lanes' 32; the sets take every
            # expert in turn, and the gathered bf16 copies pass 2 x L2 too
            id_sets = rotating_ids(e_n, n_sel // 8, 8, n_copies(n_sel * exp_bytes), gen)
            ids = id_sets[0]
            slices = tm.rows_plan(n_sel, k, n).slices
            got = held_rows(f"tcq4 rows {proj} n_sel={n_sel} ({slices} K slices)",
                            tm.tcq4_matmul_experts_rows, tm.tcq4_matmul_experts_rows_plain,
                            a, qs, eff, ids, e_n, QWEN3MOE_TOL)
            err, rel = compare(f"tcq4 rows {proj} n_sel={n_sel}", got,
                               tm.tcq4_matmul_experts_rows_plain(a, qs, eff, ids), QWEN3MOE_TOL)
            distinct = int(torch.unique(ids).numel())
            t_bytes = ms(distinct * exp_bytes + n_sel * k * 2 + n_sel * 4 + n_sel * n * 4)
            t_ops = 2 * n_sel * k * n / bf16_peak * 1e3
            sel16 = [w16[i.long()] for i in id_sets[:n_copies(n_sel * k * n * 2)]]
            rep.add({"shape": f"{proj} n_sel={n_sel} K={k} N={n} E={e_n} ({distinct} experts, "
                              f"{slices} K slices; two launches bit-equal, ids outside [0, E) "
                              f"clamped)",
                     "max_abs_err": err, "rel_err": rel, "tol": QWEN3MOE_TOL,
                     "ms": time_ms(lambda i: tm.tcq4_matmul_experts_rows(a, qs, eff, i),
                                   [(i,) for i in id_sets], 40),
                     "plain_ms": time_ms(lambda i: tm.tcq4_matmul_experts_rows_plain(
                         a, qs, eff, i), [(i,) for i in id_sets[:2]], 3),
                     "library_ms": time_ms(lambda w: torch.bmm(a[:, None, :], w),
                                           [(w,) for w in sel16], 40),
                     **bound(t_bytes, t_ops)}, headline=(n_sel == 8))
            del sel16

        rep = reports["tq_all"]
        # per-expert C = 40 is not a multiple of the 64-row tile; the f32 rows
        # are rounded to bf16 by the wrapper, as the kernel would round them
        for label, shape, dtype in (("per-expert C=64", (e_n, 64, k), torch.bfloat16),
                                    ("shared T=64", (64, k), torch.bfloat16),
                                    ("per-expert C=64, f32 a", (e_n, 64, k), torch.float32),
                                    ("per-expert C=40", (e_n, 40, k), torch.bfloat16)):
            a = torch.randn(shape, generator=gen, device=dev).to(dtype)
            got = tm.tcq4_matmul_all_experts(a, qs, eff)
            err, rel = compare(f"tcq4 all experts {proj} {label}", got,
                               tm.tcq4_matmul_all_experts_plain(a, qs, eff), QWEN3MOE_TOL)
            if not torch.equal(tm.tcq4_matmul_all_experts(a, qs, eff), got):
                raise AssertionError(f"tcq4 all experts {proj} {label}: two launches differ")
            t = shape[-2]
            t_bytes = ms(e_n * exp_bytes + a.numel() * a.element_size() + e_n * t * n * 4)
            t_ops = 2 * e_n * t * k * n / bf16_peak * 1e3
            a16 = a.to(torch.bfloat16)
            lib = (lambda w: torch.matmul(a16, w)) if a.dim() == 2 else \
                (lambda w: torch.bmm(a16, w))
            rep.add({"shape": f"{proj} {label} K={k} N={n} E={e_n} (two launches bit-equal)",
                     "max_abs_err": err, "rel_err": rel, "tol": QWEN3MOE_TOL,
                     "ms": time_ms(lambda: tm.tcq4_matmul_all_experts(a, qs, eff), [()], 10),
                     "plain_ms": time_ms(lambda: tm.tcq4_matmul_all_experts_plain(a, qs, eff),
                                         [()], 2),
                     "library_ms": time_ms(lib, [(w16,)], 10),
                     **bound(t_bytes, t_ops)},
                    headline=(proj == "gate_up" and label == "per-expert C=64"))

        rep = reports["tq_sel"]
        eff32 = eff.float()
        for m in (1, 40):
            for eff_kind, e_ in (("bf16", eff), ("f32", eff32)):
                # the model's rows are bf16; the JAX test's f32: one of each
                a = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16 if m == 1 else torch.float32)
                id_sets = [torch.randperm(e_n, generator=gen, device=dev)[:8] for _ in range(8)]
                ids = id_sets[0]
                got = tm.tcq4_matmul_experts(a, qs, e_, ids)
                err, rel = compare(f"tcq4 experts {proj} M={m} {eff_kind} eff", got,
                                   tm.tcq4_matmul_experts_plain(a, qs, e_, ids), QWEN3MOE_TOL)
                if eff_kind == "bf16" and not torch.equal(
                        got, tm.tcq4_matmul_all_experts(a, qs, eff)[ids.long()]):
                    raise AssertionError(f"tcq4 experts {proj} M={m}: not bit-equal to B10")
                e_bytes = k // 2 * n + k // 32 * n * e_.element_size()
                t_bytes = ms(8 * e_bytes + a.numel() * a.element_size() + 8 * m * n * 4)
                t_ops = 2 * 8 * m * k * n / bf16_peak * 1e3
                a16 = a.to(torch.bfloat16).expand(8, m, k)
                sel16 = [w16[i] for i in id_sets[:n_copies(8 * k * n * 2)]]
                rep.add({"shape": f"{proj} n_sel=8 M={m} K={k} N={n} E={e_n} {a.dtype} a, "
                                  f"{eff_kind} eff" + (" (bit-equal to B10)"
                                                       if eff_kind == "bf16" else ""),
                         "max_abs_err": err, "rel_err": rel, "tol": QWEN3MOE_TOL,
                         "ms": time_ms(lambda i: tm.tcq4_matmul_experts(a, qs, e_, i),
                                       [(i,) for i in id_sets], 40),
                         "plain_ms": time_ms(lambda i: tm.tcq4_matmul_experts_plain(
                             a, qs, e_, i), [(i,) for i in id_sets[:2]], 2),
                         "library_ms": time_ms(lambda w: torch.bmm(a16, w),
                                               [(w,) for w in sel16], 40),
                         **bound(t_bytes, t_ops)}, headline=(m == 1 and eff_kind == "bf16"))
                del sel16
        del eff32
        del qs, eff, w16
    torch.cuda.empty_cache()


def qwen3moe_small_cfg():
    """qwen3moe at reduced widths: 2 layers, E = 1024, 16 heads on 4 kv heads
    x 64, 32 experts of 512 top-8 with norm_topk_prob; every expert dim a
    multiple of 256, so TCQ4 applies."""
    from rrs_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="qwen3moe", n_layers=2, n_embd=1024, n_heads=16, n_kv_heads=4,
                       head_dim=64, n_ff=3072, vocab_size=4096, context_length=4096,
                       rope_theta=1e6, qk_norm=True, n_experts=32, n_experts_used=8,
                       n_ff_exp=512, norm_topk_prob=True)


def phase_qwen3moe_small_reference():
    """A 2-layer qwen3moe model (qwen3moe_small_cfg) on the card against the
    same weights on the CPU: prompts of 40 tokens (the capacity dispatch,
    which always covers a 64-row bucket), 300 random ones and 300 copies of
    one token (the overflow: the scan, or the dense all-experts fallback),
    each with one decode step (the rows kernel, or the dense gather). Twice:
    with dense bf16 weights throughout (``random_weights``), whose logits
    must stay within GLUE_TOL relative L2, and with fabricated TCQ4 weights
    and experts (``fabricated_tcq4_moe_weights``, drawn on the CPU), whose
    every kernel launch is held to its plain version on its inputs and whose
    end-to-end drift is reported (W4A4's int4 activation codes flip on
    last-bit differences; see phase 3). The card replays the CPU's expert
    ids where its own differ (a near-tie is no tolerance question; the flips
    are counted)."""
    import torch

    from rrs_tpu_torch.models import llama

    cfg = qwen3moe_small_cfg()
    rng = torch.Generator().manual_seed(5)
    prompts = {"40": torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist(),
               "300 random": torch.randint(0, cfg.vocab_size, (300,), generator=rng).tolist(),
               "300 copies": [77] * 300}
    models = {"dense": (llama.random_weights(cfg, seed=1, device="cpu"), {"flash_attention"}),
              "TCQ4": (llama.fabricated_tcq4_moe_weights(cfg, seed=1, device="cpu"),
                       {"tcq4_matmul_gx2", "tcq4_matmul", "tcq4_matmul_i8p", "q8_matmul",
                        "flash_attention", "tcq4_matmul_experts_rows",
                        "tcq4_matmul_all_experts"})}
    for kind, (w_cpu, expect) in models.items():
        with moe_branches() as paths:
            card_vs_cpu(f"small qwen3moe, {kind} (2 layers, E=1024, 32 experts of 512 top-8)",
                        cfg, w_cpu, prompts, expect, held_logits=kind == "dense")
        print(f"  MoE paths taken on the CPU and the card together: {paths}", flush=True)


QWEN3MOE_COUNTERS = {"gx2": "tcq4_matmul_gx2", "tcq4": "tcq4_matmul", "i8p": "tcq4_matmul_i8p",
                     "q8": "q8_matmul", "fa": "flash_attention",
                     "tq_rows": TQ["tq_rows"][0], "tq_all": TQ["tq_all"][0]}


def phase_qwen3moe_generate(reports):
    """``generate`` at full Qwen3-30B-A3B width, cut to QWEN3MOE_LAYERS of its
    48 layers (the config from ``ModelConfig.from_gguf`` on the published
    metadata, weights fabricated on the card): greedy prompts of 5 (the rows
    kernel in prefill), 40 (the capacity dispatch, B10 over per-expert
    activations), 300 random and 300 copies of one token (the overflow scan:
    the 212 padding rows of the 512 bucket route alike and overflow the
    capacity of 64, as in the JAX package) and 512 random ones, MOE_NEW new
    tokens each; every kernel's launches counted from 0 and the MoE branches
    taken; the 40-token prefill run twice
    and held bit-equal; a decode profile; then ``generate`` over q8 KV.
    Returns (cfg, weights)."""
    import dataclasses

    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg = dataclasses.replace(ModelConfig.from_gguf(QWEN3_30B_A3B_GGUF),
                              n_layers=QWEN3MOE_LAYERS)
    t0 = time.perf_counter()
    weights = llama.fabricated_tcq4_moe_weights(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(weights))
    exp_bytes = sum(t.numel() * t.element_size() for lw in weights.layers
                    for t in _tensors(lw.moe) if t.dim() == 3)
    print(f"  Qwen3-30B-A3B config: {cfg.n_layers} of its 48 layers, E={cfg.n_embd}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, {cfg.n_experts} experts of "
          f"{cfg.n_ff_exp} top-{cfg.n_experts_used}, norm_topk_prob {cfg.norm_topk_prob}; "
          f"fabricated weights {w_bytes / GB:.2f} GB (expert stacks {exp_bytes / GB:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator().manual_seed(0)
    prompts = {"5": torch.randint(0, cfg.vocab_size, (5,), generator=rng).tolist(),
               "40": torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist(),
               "300 random": torch.randint(0, cfg.vocab_size, (300,), generator=rng).tolist(),
               "300 copies": [1234] * 300,
               "512 random": torch.randint(0, cfg.vocab_size, (512,), generator=rng).tolist()}
    warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    warm.generate(prompts["5"], 2)                            # first-call set-up
    del warm
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    outs, per_prompt = {}, {}
    for name, p in prompts.items():
        with moe_branches() as branches:
            outs[name] = ctx.generate(p, MOE_NEW)
        per_prompt[name] = branches
    torch.cuda.synchronize()
    launches = {key: kernels.LAUNCHES[n] for key, n in QWEN3MOE_COUNTERS.items()}
    for name, out in outs.items():
        if len(out) != MOE_NEW or not all(0 <= tok < cfg.vocab_size for tok in out):
            raise AssertionError(f"qwen3moe generate {name}: {len(out)} tokens: {out}")
    perf = ctx.perf()
    peak = torch.cuda.max_memory_allocated() / GB
    print(f"  requests: prompts 5/40/300 random/300 copies/512 random x {MOE_NEW} new tokens; "
          f"prefill "
          f"{perf['n_p_eval']} tok @ {perf['pp_tok_per_s']:.1f} tok/s, decode {perf['n_eval']} "
          f"tok @ {perf['tg_tok_per_s']:.2f} tok/s "
          f"({perf['t_eval_ms'] / max(perf['n_eval'], 1):.3f} ms/token); KV resident "
          f"{ctx.kv.nbytes() / GB:.4f} GB (S=1024); peak memory {peak:.2f} GB", flush=True)
    print("  greedy tokens: " + "; ".join(f"{k}: {v[:6]}..." for k, v in outs.items()),
          flush=True)
    print(f"  MoE branches by prompt (prefill and decode): {per_prompt}; launches on the "
          f"Qwen3-30B-A3B path: {launches}", flush=True)
    if not per_prompt["300 copies"]["fallback"] or not per_prompt["40"]["capacity"] \
            or not per_prompt["5"]["rows"]:
        raise AssertionError(f"qwen3moe generate: the rows, capacity and scan branches were not "
                             f"all reached: {per_prompt}")
    for key, n in launches.items():
        if n == 0:
            raise AssertionError(f"qwen3moe generate: kernel {key} was never launched")
        reports[key].entry["launches" if key.startswith("tq") else "launches_qwen3moe"] = n
    capacity_repeat(ctx, prompts["40"], "Qwen3-30B-A3B")
    profile_decode(ctx, prompts["40"], label="Qwen3-30B-A3B")
    profile_expert_prefill(ctx, "Qwen3-30B-A3B", "tcq4_matmul_all_experts")
    del ctx

    warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024, kv_quant="q8")
    warm.generate(prompts["5"], 2)
    del warm
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024, kv_quant="q8")
    torch.cuda.synchronize()
    kernels.reset_launches()
    q8_outs = [ctx.generate(prompts[n], MOE_NEW) for n in ("40", "300 random")]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if any(len(o) != MOE_NEW for o in q8_outs) or launches["flash_attention_q8"] == 0 \
            or launches["flash_attention"] != 0:
        raise AssertionError(f"qwen3moe generate, q8 KV: {[len(o) for o in q8_outs]} tokens, "
                             f"launches {launches}")
    reports["fa_q8"].entry["launches_qwen3moe"] = launches["flash_attention_q8"]
    perf = ctx.perf()
    print(f"  generate, q8 KV: prompts 40/300 x {MOE_NEW} new tokens; prefill "
          f"{perf['pp_tok_per_s']:.1f} tok/s, decode {perf['tg_tok_per_s']:.2f} tok/s; KV "
          f"resident {ctx.kv.nbytes() / GB:.4f} GB; greedy tokens {q8_outs[0][:6]}... (bf16 KV: "
          f"{outs['40'][:6]}...); launches {launches}", flush=True)
    del ctx
    return cfg, weights


@contextlib.contextmanager
def b19_diagonal(label: str):
    """While open, every B9 launch also runs B19 on the same rows, shared
    (M = n_sel), and the same ids: B19's out[i, i] is the product B9 gives
    for row i, held within QWEN3MOE_TOL. Yields the counts."""
    import torch

    from rrs_tpu_torch.models import moe
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    orig = moe.tcq4_matmul_experts_rows
    held = {"n": 0, "rel": 0.0, "shapes": set()}

    def run(a, qs_all, eff_all, expert_ids):
        out = orig(a, qs_all, eff_all, expert_ids)
        sel = tm.tcq4_matmul_experts(a, qs_all, eff_all, expert_ids)
        i = torch.arange(a.shape[0], device=a.device)
        _, rel = compare(f"{label}: B19 diagonal {tuple(sel.shape)}", sel[i, i], out,
                         QWEN3MOE_TOL)
        held["n"] += 1
        held["rel"] = max(held["rel"], rel)
        held["shapes"].add(tuple(sel.shape))
        return out

    moe.tcq4_matmul_experts_rows = run
    try:
        yield held
    finally:
        moe.tcq4_matmul_experts_rows = orig


def phase_serving_qwen3moe(cfg, weights, reports):
    """``serve_four`` at Qwen3-30B-A3B width; the attention kernels, B2 and
    B9 must be launched. Returns the context."""
    ctx, launches, _ = serve_four(cfg, weights, "Qwen3-30B-A3B", QWEN3MOE_COUNTERS)
    for key in ("gx2", "i8p", "q8", "fa", "tq_rows"):
        if launches[key] == 0:
            raise AssertionError(f"qwen3moe serving: kernel {key} was never launched")
    for key, n in launches.items():
        reports[key].entry["launches_serve" if key.startswith("tq")
                           else "launches_serve_qwen3moe"] = n
    return ctx


# ---------------------------------------------------------------------------
# The GGUF pipeline at qwen3-4b widths: export, imatrix on the card, quantize
# (TCQ4 under imatrix permutations; Q4_K_M), gguf-split, generate, perplexity
# ---------------------------------------------------------------------------

# Card-vs-CPU limit on each tensor's imatrix (relative L2 of the mean
# squares). Each entry is a mean of squares of bf16 activations; the card's
# bf16 matmuls and the CPU's f32 ones round some of them one bf16 step (2^-8)
# apart, which moves a mean over 512 tokens by ~1e-3 (3.5e-3 between the two
# packages on the CPU, tests/test_torch_imatrix.py); a skipped norm, a wrong
# layer's input or a lost chunk moves it by order one.
IMATRIX_TOL = 1e-2
PIPELINE_PROMPT = "the quick brown fox jumps over the lazy dog"


def encoder_speeds(name: str) -> dict:
    """ns per element of the host encoders on one 256 x 4096 f32 matrix, on
    this machine's host (one thread; NumPy, or the native codec)."""
    import numpy as np

    from rrs_tpu_torch.formats import kquants
    from rrs_tpu_torch.formats.tcq4 import quantize_tcq4

    x = (np.random.default_rng(0).standard_normal((256, 4096)) * 0.05).astype(np.float32)
    out = {}
    for label, fn in (("Q4_K", kquants.quantize_q4_k), ("IQ4_XS", kquants.quantize_iq4_xs),
                      ("Q3_K", kquants.quantize_q3_k), ("Q6_K", kquants.quantize_q6_k),
                      ("Q8_0", kquants.quantize_q8_0), ("TCQ4 native", quantize_tcq4),
                      ("TCQ4 NumPy", lambda a: quantize_tcq4(a, use_native=False)),
                      ("TCQ4 search", lambda a: quantize_tcq4(a, search=True))):
        t0 = time.perf_counter()
        fn(x)
        out[label] = (time.perf_counter() - t0) * 1e9 / x.size
    print(f"  host encoders on a 256 x 4096 f32 matrix, ns per element (this machine's host, "
          f"beside {name}): " + ", ".join(f"{k} {v:.1f}" for k, v in out.items()), flush=True)
    return out


def _rel(got, ref) -> float:
    import numpy as np

    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def card_vs_cpu_step(path, prompt, label: str, expect, held: bool):
    """Load the GGUF at ``path`` on the card and on the CPU; a prefill of
    ``prompt`` and one decode step (token 11, teacher-forced) on each, the
    card's under ``held_to_plain`` (every launch of ``expect`` held to its
    plain version). Returns ({kernel: launches}, [(stage, rel L2, argmax
    card, argmax CPU)]); with ``held`` the logits must agree within
    GLUE_TOL, else the drift is only reported."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.runtime.context import InferenceContext

    t0 = time.perf_counter()
    cfg, w_cpu, _ = load_model(path, device="cpu")
    cpu = InferenceContext(cfg, w_cpu, max_seq=256, device="cpu")
    seq = cpu.new_sequence()
    ref = (cpu.prefill(seq, prompt)[-1].float(), cpu.decode({seq: 11})[seq].float())
    del cpu, w_cpu
    _, w_card, _ = load_model(path, device="cuda")
    ctx = InferenceContext(cfg, w_card, max_seq=256)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with held_to_plain(label, expect) as seen:
        seq = ctx.new_sequence()
        got = (ctx.prefill(seq, prompt)[-1].float().cpu(), ctx.decode({seq: 11})[seq].float().cpu())
        torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    rows = []
    for stage, g, r in zip(("prefill", "decode"), got, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label} {stage}: bad logits {tuple(g.shape)}")
        rel = ((g - r).norm() / r.norm()).item()
        rows.append((stage, rel, int(g.argmax()), int(r.argmax())))
        if held and rel > GLUE_TOL:
            raise AssertionError(f"{label} {stage}: card vs CPU rel L2 {rel:.4f} > {GLUE_TOL}")
    print(f"  {label}: each launch vs its plain version (max rel): "
          + (", ".join(f"{k} {v[0]:.2e} <= {SMALL_TOL[k]:.0e}" for k, v in seen.items())
             or "no port kernel on this path")
          + "; logits card vs CPU: " + ", ".join(
              f"{st} rel L2 {rel:.4f}" + (f" <= {GLUE_TOL}" if held else " (reported)")
              + f", argmax {a} vs {b}" for st, rel, a, b in rows)
          + f"; launches {launches} ({time.perf_counter() - t0:.1f} s with both loads)",
          flush=True)
    del ctx, w_card
    return launches, rows


def phase_gguf_pipeline(name: str, reports, tmp):
    """The GGUF pipeline as a user runs it, each verb its own process, at
    qwen3-4b's widths (``PRESETS["qwen3-4b"]``) cut to 2 layers, its files in
    the directory ``tmp``: the port's exporter writes an F16 GGUF (and a
    1-layer one with the vocabulary cut to 4,096 tokens, for Q4_K's host
    encoder); ``imatrix`` on the card over a text made here, its mean squares
    held per tensor to the CPU port's on the same chunks (IMATRIX_TOL) and
    the permutation entries that differ counted; ``quantize --imatrix`` to
    TCQ4 under the permutations (native encoder), ``gguf-split --split 2``,
    then ``generate`` from the first shard and from the unsplit file at once,
    greedy tokens identical; a teacher-forced prefill and decode step from
    the TCQ4 file on the card against the CPU port's (every launch held to
    its plain version, the logits drift reported).

    ``quantize --type q4_k_m --imatrix`` starts in the background beside the
    TCQ4 steps and is left running (Q4_K's host encoder takes about two
    minutes), so that phase 14 drives the card meanwhile; returns its handle
    and the prompt for ``phase_gguf_q4km``, which finishes the pipeline."""
    import dataclasses

    import numpy as np
    import torch

    from rrs_tpu_torch import native
    from rrs_tpu_torch.models.config import PRESETS
    from rrs_tpu_torch.models.export import export_random_gguf
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.quantize.imatrix import collect_imatrix, derive_tcq4_perms, load_imatrix

    if not native.available():
        raise AssertionError("the native host codec (rrs_tpu_torch/csrc/rrs_core.cpp) did not "
                             "build on this machine")
    print(f"  native host codec: {native.library_path().name}", flush=True)
    encoder_speeds(name)
    cfg2 = dataclasses.replace(PRESETS["qwen3-4b"], n_layers=2)
    cfg1 = dataclasses.replace(cfg2, n_layers=1, vocab_size=4096)
    vocab = [chr(33 + i) if 33 + i < 0x2FF else f"<tok{i}>" for i in range(cfg2.vocab_size)]
    t0 = time.perf_counter()
    f16 = export_random_gguf(cfg2, tmp / "f16.gguf", seed=0, dtype=np.float16,
                             vocab_tokens=vocab)
    f16_small = export_random_gguf(cfg1, tmp / "f16_1layer_v4096.gguf", seed=1,
                                   dtype=np.float16, vocab_tokens=vocab[:4096])
    print(f"  exported F16 GGUFs (qwen3-4b widths): 2 layers {f16.stat().st_size / GB:.2f} "
          f"GB and 1 layer with 4,096 tokens {f16_small.stat().st_size / GB:.3f} GB in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(12)
    words = ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, rng.integers(2, 9)))
             for _ in range(160)]
    text = " ".join(words)
    calib = tmp / "calib.txt"
    calib.write_text(text, encoding="utf-8")
    imat = tmp / "imatrix.gguf"

    # the card's imatrix in its own process, the CPU port's here meanwhile
    card_im = _verb_start(["imatrix", "-m", f16, "-f", calib, "-o", imat, "--chunk-len",
                           "256", "--max-chunks", "2"])
    t0 = time.perf_counter()
    cfg_c, w_c, md = load_model(f16, device="cpu")
    toks = Vocab.from_gguf(md).encode(text, add_special=False)
    chunks = [toks[i:i + 256] for i in range(0, len(toks), 256)][:2]
    acc = collect_imatrix(cfg_c, w_c, chunks, chunk_len=256)
    del w_c
    t_cpu = time.perf_counter() - t0
    out = _verb_wait(card_im)
    if "saved imatrix for 14 tensors" not in out:
        raise AssertionError(f"imatrix verb: {out[-500:]}")
    card = load_imatrix(imat)
    cpu = {k: s / max(n, 1) for k, (s, n) in acc.items()}
    if sorted(card) != sorted(cpu):
        raise AssertionError(f"imatrix tensors: card {sorted(card)} vs CPU {sorted(cpu)}")
    rels = {k: _rel(card[k], cpu[k]) for k in cpu}
    worst = max(rels, key=rels.get)
    if rels[worst] > IMATRIX_TOL:
        raise AssertionError(f"imatrix {worst}: card vs CPU rel L2 {rels[worst]:.2e} > "
                             f"{IMATRIX_TOL}")
    p_card, p_cpu = derive_tcq4_perms(card), derive_tcq4_perms(cpu)
    differ = {k: int((p_card[k] != p_cpu[k]).sum()) for k in p_cpu}
    print(f"  imatrix over {len(chunks)} chunks ({sum(map(len, chunks))} tokens): card vs "
          f"CPU (CPU {t_cpu:.1f} s, in this process) worst rel L2 {rels[worst]:.2e} "
          f"({worst}) <= {IMATRIX_TOL}; permutation entries that differ: "
          f"{sum(differ.values())} of {sum(p.size for p in p_cpu.values())} "
          f"({ {k: v for k, v in differ.items() if v} })", flush=True)

    q4 = tmp / "q4_k_m.gguf"
    q4_run = _verb_start(["quantize", f16_small, q4, "--type", "q4_k_m", "--imatrix", imat])
    tcq4 = tmp / "tcq4.gguf"
    out = _verb(["quantize", f16, tcq4, "--imatrix", imat])
    stats = [line for line in out.splitlines() if line.startswith("quantized:")]
    if "derived 14 channel permutations" not in out or not stats:
        raise AssertionError(f"quantize --imatrix: {out[-800:]}")
    print(f"    {stats[0]}", flush=True)
    out = _verb(["gguf-split", "--split", "2", tcq4, tmp / "tcq4"])
    first = tmp / "tcq4-00001-of-00002.gguf"
    if not first.exists() or not (tmp / "tcq4-00002-of-00002.gguf").exists():
        raise AssertionError(f"gguf-split: {out}")
    runs = [_verb_start(["generate", "-m", m, "-p", PIPELINE_PROMPT, "-n", "16"])
            for m in (first, tcq4)]
    texts = [_verb_wait(r).rstrip("\n") for r in runs]
    if texts[0] != texts[1] or len(texts[0]) == 0:
        raise AssertionError(f"generate: first shard {texts[0]!r} vs unsplit {texts[1]!r}")
    print(f"    greedy text from the first shard = from the unsplit file: {texts[0]!r}",
          flush=True)
    prompt = toks[:40]
    launches, _ = card_vs_cpu_step(first, prompt, "TCQ4 GGUF (imatrix perms), 2 layers",
                                   {"tcq4_matmul_gx2", "tcq4_matmul", "flash_attention"},
                                   held=False)
    for key, kname in (("gx2", "tcq4_matmul_gx2"), ("tcq4", "tcq4_matmul"),
                       ("fa", "flash_attention")):
        reports[key].entry["launches_gguf_tcq4"] = launches.get(kname, 0)
    torch.cuda.empty_cache()
    print(f"  phase 13 leaves the Q4_K_M quantization running "
          f"({time.perf_counter() - q4_run[3]:.1f} s in)", flush=True)
    return q4_run, prompt


def phase_gguf_q4km(q4_run, prompt, tmp):
    """The rest of phase 13: wait for the Q4_K_M quantization that
    ``phase_gguf_pipeline`` left running in ``tmp``, then ``generate`` and
    ``perplexity`` on its file, its mix stats printed, and its logits on the
    card within GLUE_TOL of the CPU port's."""

    q4, calib = tmp / "q4_k_m.gguf", tmp / "calib.txt"
    t0 = time.perf_counter()
    out = _verb_wait(q4_run)
    print(f"  waited {time.perf_counter() - t0:.1f} s for it", flush=True)
    stats = [line for line in out.splitlines() if line.startswith("quantized:")]
    if not stats or "'mix'" not in stats[0]:
        raise AssertionError(f"quantize --type q4_k_m: {out[-800:]}")
    print(f"    {stats[0]}", flush=True)
    runs = [_verb_start(["generate", "-m", q4, "-p", PIPELINE_PROMPT, "-n", "16"]),
            _verb_start(["perplexity", "-m", q4, "-f", calib, "--n-ctx", "128",
                         "--max-chunks", "2"])]
    out = _verb_wait(runs[0])
    if not out.strip():
        raise AssertionError("generate on the Q4_K_M file printed nothing")
    out = _verb_wait(runs[1])
    final = [line for line in out.splitlines() if line.startswith("Final PPL")]
    ppl = float(final[0].split("=")[1].split()[0]) if final else float("nan")
    if not (math.isfinite(ppl) and ppl > 1):
        raise AssertionError(f"perplexity on the Q4_K_M file: {out[-500:]}")
    print(f"    {final[0]}", flush=True)
    card_vs_cpu_step(q4, [t % 4096 for t in prompt], "Q4_K_M GGUF, 1 layer, 4096 tokens",
                     {"flash_attention"}, held=True)


# -- Qwen2-57B-A14B ----------------------------------------------------------------

# The GGUF metadata of Qwen2-57B-A14B as its published config.json gives it
# (Hugging Face Qwen/Qwen2-57B-A14B; llama.cpp's converter writes these keys)
QWEN2_57B_A14B_GGUF = {
    "general.architecture": "qwen2moe", "qwen2moe.block_count": 28,
    "qwen2moe.context_length": 65536, "qwen2moe.embedding_length": 3584,
    "qwen2moe.feed_forward_length": 18944, "qwen2moe.attention.head_count": 28,
    "qwen2moe.attention.head_count_kv": 4,
    "qwen2moe.attention.layer_norm_rms_epsilon": 1e-6, "qwen2moe.rope.freq_base": 1e6,
    "qwen2moe.expert_count": 64, "qwen2moe.expert_used_count": 8,
    "qwen2moe.expert_feed_forward_length": 2560,
    "qwen2moe.expert_shared_feed_forward_length": 20480, "qwen2moe.vocab_size": 151936}
QWEN2MOE_SHARED_FF = 20480


def with_shared_experts(w, n_ff_shared: int, seed: int, device):
    """qwen2moe's extra weights on a qwen3moe-shaped tree: per layer a dense
    bf16 shared expert N(0, 0.01) of width ``n_ff_shared`` (the loader's
    form of ``ffn_*_shexp``) and f32 q / k / v biases N(0, 0.02)."""
    import dataclasses

    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = lambda shape, scl, dt=torch.bfloat16: (torch.randn(   # noqa: E731
        shape, generator=gen, device=device) * scl).to(dt)
    layers = []
    for lw in w.layers:
        e = lw.attn_norm.shape[0]
        moe = dataclasses.replace(lw.moe, shared_gate=normal((e, n_ff_shared), 0.01),
                                  shared_up=normal((e, n_ff_shared), 0.01),
                                  shared_down=normal((n_ff_shared, e), 0.01))
        lins = {f: dataclasses.replace(getattr(lw, f), bias=normal(
                    (getattr(lw, f).shape[1],), 0.02, torch.float32))
                for f in ("wqkv", "wq", "wk", "wv") if getattr(lw, f) is not None}
        layers.append(dataclasses.replace(lw, moe=moe, q_norm=None, k_norm=None, **lins))
    return dataclasses.replace(w, layers=layers)


def qwen2moe_small_cfg():
    """qwen2moe at reduced widths, as phase 12 cuts qwen3moe: 2 layers, E =
    1024, 16 heads on 4 kv heads x 64, 32 experts of 512 top-8, qkv biases;
    the shared expert (4,096 wide, eight experts' width as in Qwen2-57B-A14B)
    is added by ``with_shared_experts``."""
    from rrs_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="qwen2moe", n_layers=2, n_embd=1024, n_heads=16, n_kv_heads=4,
                       head_dim=64, n_ff=3072, vocab_size=4096, context_length=4096,
                       rope_theta=1e6, attn_bias=True, n_experts=32, n_experts_used=8,
                       n_ff_exp=512)


def phase_qwen2moe_small_reference():
    """A 2-layer qwen2moe model (qwen2moe_small_cfg) on the card against the
    same weights on the CPU, as phase 12 runs qwen3moe's: prompts of 40
    tokens (capacity), 300 random ones and 300 copies of one token (the
    overflow), each with one decode step (rows), with dense bf16 experts
    (logits within GLUE_TOL) and with fabricated TCQ4 attention and experts
    (every launch held to its plain version, drift reported); both with the
    dense shared expert. The card replays the CPU's expert ids where its
    own differ."""
    import torch

    from rrs_tpu_torch.models import llama

    cfg = qwen2moe_small_cfg()
    rng = torch.Generator().manual_seed(6)
    prompts = {"40": torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist(),
               "300 random": torch.randint(0, cfg.vocab_size, (300,), generator=rng).tolist(),
               "300 copies": [77] * 300}
    models = {"dense": (llama.random_weights(cfg, seed=2, device="cpu"), {"flash_attention"}),
              "TCQ4": (llama.fabricated_tcq4_moe_weights(cfg, seed=2, device="cpu"),
                       {"tcq4_matmul_gx2", "tcq4_matmul", "tcq4_matmul_i8p", "q8_matmul",
                        "flash_attention", "tcq4_matmul_experts_rows",
                        "tcq4_matmul_all_experts"})}
    for kind, (w_base, expect) in models.items():
        w_cpu = with_shared_experts(w_base, 8 * cfg.n_ff_exp, seed=3, device="cpu")
        card_vs_cpu(f"small qwen2moe, {kind} (2 layers, E=1024, 32 experts of 512 top-8, "
                    f"shared expert 4096)", cfg, w_cpu, prompts, expect,
                    held_logits=kind == "dense")


def phase_qwen2moe_generate(reports):
    """``generate`` at Qwen2-57B-A14B's published widths (the config from
    ``ModelConfig.from_gguf`` on its metadata, cut to QWEN2MOE_LAYERS of its
    28 layers), weights
    fabricated on the card: TCQ4 attention (with q / k / v biases) and
    experts, a dense bf16 shared expert 20,480 wide per layer, a Q8_0
    lm_head. Greedy prompts of 5 (rows), 40 (capacity) and 300 copies of one
    token (the overflow scan), 16 new tokens each; every kernel's launches
    counted from 0 and the MoE branches taken. Returns what the held steps
    and the decode profiles that follow run on."""
    import dataclasses

    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg = dataclasses.replace(ModelConfig.from_gguf(QWEN2_57B_A14B_GGUF),
                              n_layers=QWEN2MOE_LAYERS)
    t0 = time.perf_counter()
    weights = with_shared_experts(llama.fabricated_tcq4_moe_weights(cfg, seed=0, device="cuda"),
                                  QWEN2MOE_SHARED_FF, seed=1, device="cuda")
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(weights))
    exp_bytes = sum(t.numel() * t.element_size() for lw in weights.layers
                    for t in _tensors(lw.moe) if t.dim() == 3)
    sh_bytes = sum(getattr(lw.moe, f).numel() * 2 for lw in weights.layers
                   for f in ("shared_gate", "shared_up", "shared_down"))
    print(f"  Qwen2-57B-A14B config: {cfg.n_layers} of its 28 layers, E={cfg.n_embd}, "
          f"{cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim}, {cfg.n_experts} experts of {cfg.n_ff_exp} "
          f"top-{cfg.n_experts_used}, shared expert {QWEN2MOE_SHARED_FF}, attn_bias "
          f"{cfg.attn_bias}, norm_topk_prob {cfg.norm_topk_prob}; fabricated weights "
          f"{w_bytes / GB:.2f} GB (TCQ4 expert stacks {exp_bytes / GB:.2f} GB, bf16 shared "
          f"experts {sh_bytes / GB:.2f} GB) in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator().manual_seed(0)
    prompts = {"5": torch.randint(0, cfg.vocab_size, (5,), generator=rng).tolist(),
               "40": torch.randint(0, cfg.vocab_size, (40,), generator=rng).tolist(),
               "300 copies": [1234] * 300}
    t0 = time.perf_counter()
    warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    warm.generate(prompts["5"], 2)
    del warm
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    torch.cuda.synchronize()
    print(f"  warm-up generate {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    outs, per_prompt = {}, {}
    t0 = time.perf_counter()
    for name, p in prompts.items():
        with moe_branches() as branches:
            outs[name] = ctx.generate(p, 16)
        per_prompt[name] = branches
    print(f"  three requests {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    launches = {key: kernels.LAUNCHES[n] for key, n in QWEN3MOE_COUNTERS.items()}
    for name, out in outs.items():
        if len(out) != 16 or not all(0 <= tok < cfg.vocab_size for tok in out):
            raise AssertionError(f"qwen2moe generate {name}: {len(out)} tokens: {out}")
    perf = ctx.perf()
    print(f"  requests: prompts 5/40/300 copies x 16 new tokens; prefill {perf['n_p_eval']} tok "
          f"@ {perf['pp_tok_per_s']:.1f} tok/s, decode {perf['n_eval']} tok @ "
          f"{perf['tg_tok_per_s']:.2f} tok/s ({perf['t_eval_ms'] / max(perf['n_eval'], 1):.3f} "
          f"ms/token); peak memory {torch.cuda.max_memory_allocated() / GB:.2f} GB", flush=True)
    print("  greedy tokens: " + "; ".join(f"{k}: {v[:6]}..." for k, v in outs.items()),
          flush=True)
    print(f"  MoE branches by prompt (prefill and decode): {per_prompt}; launches on the "
          f"Qwen2-57B-A14B path: {launches}", flush=True)
    if not per_prompt["300 copies"]["fallback"] or not per_prompt["40"]["capacity"] \
            or not per_prompt["5"]["rows"]:
        raise AssertionError(f"qwen2moe generate: the rows, capacity and scan branches were not "
                             f"all reached: {per_prompt}")
    for key in ("gx2", "tcq4", "q8", "fa", "tq_rows", "tq_all"):
        if launches[key] == 0:
            raise AssertionError(f"qwen2moe generate: kernel {key} was never launched")
    for key, n in launches.items():
        reports[key].entry["launches_qwen2moe"] = n
    return cfg, weights, ctx, prompts, sh_bytes


def phase_qwen2moe_held(ctx, prompts):
    """On the QWEN2MOE_LAYERS-layer Qwen2-57B-A14B weights ``generate`` ran,
    at the published widths: teacher-forced prefills of the 40-token prompt
    (capacity) and of 300 copies of one token (the overflow scan; M >= 256,
    so the i8p kernel) and one decode step after each (rows), every kernel
    launch held to its plain version on the very inputs it got."""
    import torch

    from rrs_tpu_torch import kernels

    expect = {"tcq4_matmul_gx2", "tcq4_matmul", "tcq4_matmul_i8p", "q8_matmul",
              "flash_attention", "tcq4_matmul_experts_rows", "tcq4_matmul_all_experts"}
    t0 = time.perf_counter()
    kernels.reset_launches()
    with held_to_plain("Qwen2-57B-A14B", expect) as seen, moe_branches() as branches:
        for name in ("40", "300 copies"):
            seq = ctx.new_sequence()
            last = ctx.prefill(seq, prompts[name])[-1]
            out = ctx.decode({seq: int(last.argmax())})[seq]
            if not (torch.isfinite(last).all() and torch.isfinite(out).all()):
                raise AssertionError(f"Qwen2-57B-A14B held steps, {name}: non-finite logits")
            ctx.kv.seq_rm(seq)
        torch.cuda.synchronize()
    if not (branches["rows"] and branches["capacity"] and branches["fallback"]):
        raise AssertionError(f"Qwen2-57B-A14B held steps: the rows, capacity and scan branches "
                             f"were not all reached: {branches}")
    for name, (worst, shapes) in sorted(seen.items()):
        print(f"  Qwen2-57B-A14B held, {name}: {kernels.LAUNCHES[name]} launches, each within "
              f"its tolerance of its plain version (max rel {worst:.2e}); shapes "
              f"{sorted(shapes)}", flush=True)
    print(f"  Qwen2-57B-A14B prefills of 40 and 300 copies + a decode step each, held to the "
          f"plain versions in {time.perf_counter() - t0:.1f} s; MoE branches {branches}",
          flush=True)


def phase_qwen2moe_profile(cfg, weights, ctx, prompts, sh_bytes):
    """Two decode profiles at Qwen2-57B-A14B's widths, with and without the
    shared expert; their difference is its device ms a step. Run with no
    verb process beside it, so that the wall and idle share are the card
    machine's alone."""
    import dataclasses

    from rrs_tpu_torch.runtime.context import InferenceContext

    t0 = time.perf_counter()
    with_sh = profile_decode(ctx, prompts["40"], label="Qwen2-57B-A14B")
    no_sh = dataclasses.replace(weights, layers=[
        dataclasses.replace(lw, moe=dataclasses.replace(lw.moe, shared_gate=None))
        for lw in weights.layers])
    ctx_ns = InferenceContext(cfg, no_sh, n_lanes=1, max_seq=1024)
    without = profile_decode(ctx_ns, prompts["40"], label="Qwen2-57B-A14B, shared expert off")
    if with_sh and without:
        d = with_sh["device_ms"] - without["device_ms"]
        print(f"  the shared expert's device time a decode step: {d:.3f} ms of "
              f"{with_sh['device_ms']:.3f} ms ({d / with_sh['device_ms']:.3f} of the device "
              f"time; bound {sh_bytes / 3.35e12 * 1e3:.3f} ms for its {sh_bytes / GB:.2f} GB "
              f"at 3.35 TB/s; both profiles {time.perf_counter() - t0:.1f} s)", flush=True)


def _grammar_holds(label: str, text: str, gbnf: str, lazy_words=()) -> None:
    """A served text must be accepted, as a prefix, by a fresh host grammar
    (a lazy one fed as the engine feeds it: unconstrained until a trigger
    word, then character by character)."""
    from rrs_tpu_torch.runtime.grammar import Grammar

    g = Grammar(gbnf, lazy=bool(lazy_words), trigger_words=list(lazy_words))
    ok = True
    for ch in text:
        if g.awaiting_trigger:
            g.feed_token(-1, ch)
        elif not g.accept_text(ch):
            ok = False
            break
    if not ok:
        raise AssertionError(f"{label}: served text {text!r} breaks its grammar {gbnf!r}")


def _sse_events(data: bytes) -> list:
    return [json.loads(line[6:]) for line in data.decode().split("\n")
            if line.startswith("data: {")]


def self_draft_drift(target, draft, prompt, n_new: int, n_draft: int = 4):
    """``generate_speculative`` with a draft context on the target's own
    weights, recording the draft's decode logits and each verify chunk's:
    at every drafted position both saw the same tokens, so a draft or
    target cache out of step shows as logits that part. Returns (tokens,
    stats, the largest rel L2 between a draft row and its verify row)."""
    import torch

    from rrs_tpu_torch.runtime.speculative import generate_speculative

    rows = {"draft": [], "verify": []}
    decode, prefill = draft.decode, target.prefill

    def draft_decode(seq_tokens):
        out = decode(seq_tokens)
        rows["draft"].append(next(iter(out.values())).float().cpu())
        return out

    def target_prefill(seq, tokens, all_logits=True):
        out = prefill(seq, tokens, all_logits)
        if len(tokens) == n_draft + 1:
            rows["verify"].append(out[:n_draft].float().cpu())
        return out

    draft.decode, target.prefill = draft_decode, target_prefill
    out, st = generate_speculative(target, draft, prompt, n_new, n_draft=n_draft)
    if len(rows["draft"]) != n_draft * len(rows["verify"]) or not rows["verify"]:
        raise AssertionError(f"self-draft: {len(rows['draft'])} draft steps for "
                             f"{len(rows['verify'])} verify chunks")
    drift = 0.0
    for r, ver in enumerate(rows["verify"]):
        for k in range(n_draft):
            d = rows["draft"][r * n_draft + k]
            drift = max(drift, float(((d - ver[k]).norm() / ver[k].norm()).item()))
    return out, st, drift


REST_SCHEMA = {"type": "object", "properties": {"name": {"type": "string"},
                                                "age": {"type": "integer"}},
               "required": ["name", "age"]}


# the layers of qwen3-4b that phase 10 runs, cut from 36 so that the script
# fits its time limit beside phase 19 (with all 36, and before phase 19, it
# took 926 s to its summary on an H100 80GB HBM3 at 700 W)
SERVER_REST_LAYERS = 12


def first_layers(cfg, weights, n: int):
    """(cfg, weights) of the model's first ``n`` layers, sharing its tensors."""
    import dataclasses

    return (dataclasses.replace(cfg, n_layers=n),
            dataclasses.replace(weights, layers=weights.layers[:n]))


def phase_server_rest(cfg, weights, reports):
    """The rest of the server at qwen3-4b width, cut to SERVER_REST_LAYERS of
    its 36 layers (``Engine`` over a 4-lane,
    2048-token context; the synthetic vocabulary with three FIM ids): the
    grammar options over HTTP, embeddings, rerank, infill, /v1/messages and
    the web UI, then speculative and prompt-lookup decoding. Every response
    must answer 200 and every hold raises on failure."""
    import torch
    from http.server import ThreadingHTTPServer
    from pathlib import Path

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import PRESETS
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.runtime.json_schema import json_schema_to_gbnf
    from rrs_tpu_torch.runtime.lookup import generate_lookup
    from rrs_tpu_torch.runtime.speculative import generate_speculative
    from rrs_tpu_torch.serving import engine as engine_mod
    from rrs_tpu_torch.serving.engine import Engine, GenRequest
    from rrs_tpu_torch.serving.server import WEBUI, ServerState, make_handler
    from rrs_tpu_torch.runtime.sampler import SamplerParams

    t_phase = time.perf_counter()
    vocab = synthetic_vocab(cfg.vocab_size, fim=True)
    t0 = time.perf_counter()
    vocab.pieces()
    vocab.token_trie()
    print(f"  vocabulary pieces and token trie ({cfg.vocab_size} tokens) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ctx = InferenceContext(cfg, weights, n_lanes=4, max_seq=2048)
    # a grammar violation costs the rest of its run: short runs while the
    # optimistic path serves, the default length for the timed requests
    run_steps = ctx.DECODE_RUN_STEPS
    ctx.DECODE_RUN_STEPS = 8
    engine = Engine(ctx)
    state = ServerState(cfg, vocab, engine, {}, "qwen3-4b-fabricated")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    rng = torch.Generator().manual_seed(17)
    ids = lambda n: torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist()  # noqa: E731
    chat = [{"role": "user", "content": "Give me a record."}]
    gbnf_az = "root ::= [a-z ]+"
    key_az = (gbnf_az, cfg.vocab_size)
    with engine_mod._DFA_LOCK:
        engine_mod._DFA_CACHE.pop(key_az, None)

    def post(path, body):
        t1 = time.perf_counter()
        status, data = _http(port, "POST", path, body)
        if status != 200:
            raise AssertionError(f"server rest: {path} answered {status}: {data[:300]!r}")
        return data, time.perf_counter() - t1

    def completion_text(data):
        c = json.loads(data)["choices"][0]
        return c["message"]["content"] if "message" in c else c["text"]

    engine.start()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        kernels.reset_launches()
        # 1) the schema request alone: random weights make most tokens
        # illegal, so the optimistic path must resample
        r0 = engine.n_resampled
        data, dt = post("/v1/completions", {"prompt": ids(30), "json_schema": REST_SCHEMA,
                                            "max_tokens": 6, "temperature": 0.0})
        text = completion_text(data)
        _grammar_holds("json_schema", text, json_schema_to_gbnf(REST_SCHEMA))
        n_res_schema = engine.n_resampled - r0
        if n_res_schema < 1:
            raise AssertionError("json_schema request: the optimistic path never resampled")
        print(f"  json_schema (required name, age): {text!r} in {dt:.1f} s, "
              f"{n_res_schema} candidate resamples", flush=True)
        # 2) four grammar requests at once
        jobs = {"grammar greedy": ("/v1/completions", {"prompt": ids(20), "grammar": gbnf_az,
                                                       "max_tokens": 8, "temperature": 0.0},
                                   gbnf_az, ()),
                "grammar sampled": ("/v1/completions", {"prompt": ids(20), "grammar": gbnf_az,
                                                        "max_tokens": 8, "temperature": 0.8,
                                                        "seed": 3}, gbnf_az, ()),
                "json_object chat": ("/v1/chat/completions",
                                     {"messages": chat, "max_tokens": 6, "temperature": 0.0,
                                      "response_format": {"type": "json_object"}},
                                     json_schema_to_gbnf({}), ()),
                "lazy grammar": ("/v1/completions",
                                 {"prompt": ids(20), "grammar": 'root ::= "a" [a-z]+',
                                  "grammar_triggers": [{"type": "word", "value": "a"}],
                                  "max_tokens": 12, "temperature": 0.0},
                                 'root ::= "a" [a-z]+', ("a",))}
        results = {}

        def run(name):
            path, body, _, _ = jobs[name]
            results[name] = post(path, body)

        threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if set(results) != set(jobs):
            raise AssertionError(f"grammar requests: {set(jobs) - set(results)} did not answer")
        for name, (data, dt) in results.items():
            text = completion_text(data)
            _grammar_holds(name, text, jobs[name][2], jobs[name][3])
            print(f"  {name}: {text!r} ({dt:.1f} s)", flush=True)
        # 3) the [a-z ]+ DFA, compiled in a spawned process since the first
        # such request
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 120:
            with engine_mod._DFA_LOCK:
                if key_az in engine_mod._DFA_CACHE:
                    break
            time.sleep(0.1)
        with engine_mod._DFA_LOCK:
            dfa = engine_mod._DFA_CACHE.get(key_az)
            compile_s = engine_mod.DFA_COMPILE_S.get(key_az, float("nan"))
        if dfa is None or dfa.masks.shape[0] > 4:
            raise AssertionError(f"the [a-z ]+ token DFA did not compile within 4 states: "
                                 f"{None if dfa is None else dfa.masks.shape}")
        print(f"  [a-z ]+ token DFA: {dfa.masks.shape[0]} states x {dfa.masks.shape[1]} tokens, "
              f"compiled in a spawned process in {compile_s:.2f} s", flush=True)
        # 4) the DFA request alone at the default run length, then the same
        # request without a grammar: served tok/s with and without
        ctx.DECODE_RUN_STEPS = run_steps
        prompt = ids(40)
        speeds = {}
        for name, extra in (("DFA grammar", {"grammar": gbnf_az}), ("no grammar", {})):
            d0, r0 = engine.n_dfa_runs, engine.n_resampled
            data, dt = post("/v1/completions", {"prompt": prompt, "max_tokens": 64,
                                                "temperature": 0.0, **extra})
            out = json.loads(data)
            tm = out["timings"]
            n = out["usage"]["completion_tokens"]
            speeds[name] = (n - 1) / max(tm["predicted_ms"] / 1e3, 1e-9)
            if extra:
                _grammar_holds(name, completion_text(data), gbnf_az)
                if engine.n_dfa_runs == d0 or engine.n_resampled != r0:
                    raise AssertionError(f"DFA request: {engine.n_dfa_runs - d0} DFA runs, "
                                         f"{engine.n_resampled - r0} resamples (want > 0, 0)")
                print(f"  DFA request: {engine.n_dfa_runs - d0} device runs carried the DFA, "
                      f"0 candidate resamples", flush=True)
        print(f"  served decode tok/s, one request of 64 tokens alone (runs of {run_steps}): "
              f"DFA grammar {speeds['DFA grammar']:.2f}, no grammar {speeds['no grammar']:.2f}",
              flush=True)
        # 5) embeddings (B4 at 40 rows, B5 at 300), rerank, infill, messages
        lat = {}
        for n in (40, 300, 40, 300):                  # the second of each is timed
            data, lat[n] = post("/v1/embeddings", {"input": [ids(n)]})
        kernels.reset_launches()
        with held_to_plain("embeddings", {"tcq4_matmul", "tcq4_matmul_i8p",
                                          "flash_attention"}) as seen:
            for n in (40, 300):
                data, _ = post("/v1/embeddings", {"input": [ids(n)]})
                vec = torch.tensor(json.loads(data)["data"][0]["embedding"])
                if vec.shape != (cfg.n_embd,) or not torch.isfinite(vec).all():
                    raise AssertionError(f"embedding of {n} tokens: {tuple(vec.shape)}")
        emb_launches = {k: kernels.LAUNCHES[v] for k, v in COUNTERS.items()}
        print(f"  /v1/embeddings (mean pooling) request latency: 40 tokens "
              f"{lat[40] * 1e3:.1f} ms, 300 tokens {lat[300] * 1e3:.1f} ms; held: launches "
              f"{emb_launches}, each vs its plain version (max rel): "
              + ", ".join(f"{k} {v[0]:.2e} (shapes {sorted(v[1])})" for k, v in seen.items()),
              flush=True)
        data, dt = post("/rerank", {"query": "graphics cards", "top_n": 3,
                                    "documents": ["gpus and tensor cores", "a recipe for soup",
                                                  "memory bandwidth of accelerators"]})
        res = json.loads(data)["results"]
        scores = [r["relevance_score"] for r in res]
        if len(res) != 3 or scores != sorted(scores, reverse=True) or not all(
                math.isfinite(s) for s in scores):
            raise AssertionError(f"rerank: {res}")
        print(f"  /rerank of 3 documents in {dt * 1e3:.0f} ms: "
              f"{[(r['index'], round(r['relevance_score'], 3)) for r in res]}", flush=True)
        data, dt = post("/infill", {"input_prefix": "def add(a, b):", "input_suffix": "return c",
                                    "max_tokens": 8})
        out = json.loads(data)
        if out["stop_type"] not in ("stop", "length") or not isinstance(out["content"], str) \
                or out["tokens_predicted"] > 8:
            raise AssertionError(f"infill: {out}")
        print(f"  /infill: {out['content']!r} ({out['tokens_predicted']} tokens, stop "
              f"{out['stop_type']}, {dt:.1f} s)", flush=True)
        data, dt = post("/v1/messages", {"messages": chat, "system": "be brief",
                                         "max_tokens": 8, "temperature": 0.0})
        msg = json.loads(data)
        if msg["type"] != "message" or msg["usage"]["output_tokens"] < 1:
            raise AssertionError(f"/v1/messages: {msg}")
        data, _ = post("/v1/messages", {"messages": chat, "system": "be brief",
                                        "max_tokens": 8, "temperature": 0.0, "stream": True})
        events = _sse_events(data)
        kinds = [e["type"] for e in events]
        streamed = "".join(e["delta"]["text"] for e in events
                           if e["type"] == "content_block_delta")
        if kinds[:2] != ["message_start", "content_block_start"] or kinds[-3:] != [
                "content_block_stop", "message_delta", "message_stop"]:
            raise AssertionError(f"/v1/messages stream events: {kinds}")
        n_streamed = events[-2]["usage"]["output_tokens"]
        if not 1 <= n_streamed <= 8:
            raise AssertionError(f"/v1/messages stream: {n_streamed} output tokens")
        # the streamed request reuses the first one's prompt cache, so its
        # prefill runs other row counts and W4A4 greedy text may part
        print(f"  /v1/messages: {msg['content'][0]['text']!r} ({msg['stop_reason']}); "
              f"streamed in {len(events)} events, {n_streamed} tokens: {streamed!r}", flush=True)
        status, page = _http(port, "GET", "/")
        if status != 200 or page != WEBUI.read_bytes():
            raise AssertionError(f"GET /: {status}, {len(page)} bytes")
        rest_launches = {k: kernels.LAUNCHES[v] for k, v in COUNTERS.items()}
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    for key, n in rest_launches.items():
        reports[key].entry["launches_server_rest"] = n
    print(f"  launches since the embeddings (embeddings, rerank, infill, messages): "
          f"{rest_launches}; server part {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 6) the trajectory of the DFA states on the card, one step a run
    seq = ctx.new_sequence()
    first = int(ctx.prefill(seq, ids(20), all_logits=False)[-1].argmax())
    gm, gt = engine._dfa_device(dfa)
    gen = torch.Generator(device=ctx.device).manual_seed(5)
    p = SamplerParams(temperature=0.8, top_k=40, top_p=0.95)
    h = ctx.decode_run_start({seq: first}, {seq: gen}, {seq: p}, 1, dfa=(gm, gt, {seq: 0}))
    lane = h["lanes"][seq]
    toks, states = [], []
    for i in range(8):
        if i:
            h = ctx.decode_run_start({seq: None}, {seq: gen}, {seq: p}, 1, chain=h)
        toks.append(int(h["toks"][lane, 0]))
        states.append(int(h["gstate"][lane]))
    walk, host = 0, []
    for t in toks:
        if not dfa.masks[walk, t]:
            raise AssertionError(f"DFA run: token {t} is illegal in state {walk}")
        walk = int(dfa.trans[walk, t])
        host.append(walk)
    if states != host:
        raise AssertionError(f"DFA run: card states {states} vs the host walk {host}")
    print(f"  one DFA run (8 sampled steps): the card's gstate trajectory {states} equals the "
          f"host DFA's walk over the card's tokens {toks}", flush=True)
    ctx.kv.seq_rm(seq)
    del ctx, engine, state, httpd
    gc.collect()
    torch.cuda.empty_cache()

    # 7) a 2-layer glue hold: embed on the card against the CPU, dense bf16
    from rrs_tpu_torch.models.config import ModelConfig

    gcfg = ModelConfig(arch="qwen3", n_layers=2, n_embd=1024, n_heads=16, n_kv_heads=8,
                       head_dim=128, n_ff=3072, vocab_size=4096, context_length=4096,
                       rope_theta=1e6, qk_norm=True)
    dense = llama.random_weights(gcfg, seed=1, device="cpu")
    toks = list(range(7, 47))
    rows = []
    for pooling in ("mean", "last"):
        got = InferenceContext(gcfg, llama.to_device(dense, "cuda"), max_seq=64).embed(
            toks, pooling)
        ref = InferenceContext(gcfg, dense, max_seq=64, device="cpu").embed(toks, pooling)
        rel = float(((torch.from_numpy(got) - torch.from_numpy(ref)).norm()
                     / torch.from_numpy(ref).norm()).item())
        if not (got.shape == ref.shape and math.isfinite(rel) and rel <= GLUE_TOL):
            raise AssertionError(f"embed {pooling} on the card vs the CPU: rel L2 {rel:.4f} "
                                 f"> {GLUE_TOL}")
        rows.append(f"{pooling} rel L2 {rel:.4f}")
    print(f"  2-layer dense embed, card vs CPU (40 tokens): {', '.join(rows)} <= {GLUE_TOL}",
          flush=True)
    # its self-draft: on dense weights the draft's decode step and the
    # verify chunk see the same cache, so their logits must agree
    mkd = lambda: InferenceContext(gcfg, dense_card, n_lanes=1, max_seq=256)   # noqa: E731
    dense_card = llama.to_device(dense, "cuda")
    out, st, drift = self_draft_drift(mkd(), mkd(), toks, 32)
    plain = mkd().generate(toks, 32)
    if drift > GLUE_TOL:
        raise AssertionError(f"2-layer dense self-draft: the draft's decode logits and the "
                             f"verify chunk's part by rel L2 {drift:.4f} > {GLUE_TOL}")
    agree = next((i for i, (a, b) in enumerate(zip(out, plain)) if a != b), len(out))
    print(f"  2-layer dense self-draft: draft decode vs verify chunk logits within rel L2 "
          f"{drift:.4f} <= {GLUE_TOL} at every drafted position; {st.n_accepted} of "
          f"{st.n_drafted} drafts accepted ({st.acceptance_rate:.3f}); agrees with plain greedy "
          f"decode for the first {agree} of 32 tokens (reported)", flush=True)
    del dense_card

    # 8) speculative decoding: the target as its own draft, then the
    # fabricated qwen3-0.6b as the draft; prompt lookup
    t0 = time.perf_counter()
    dcfg = PRESETS["qwen3-0.6b"]
    dweights = llama.fabricated_tcq4_weights(dcfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    print(f"  fabricated the qwen3-0.6b draft ({dcfg.n_layers} layers, vocab "
          f"{dcfg.vocab_size}) in {time.perf_counter() - t0:.1f} s", flush=True)
    prompt = ids(40)
    mk = lambda c, w: InferenceContext(c, w, n_lanes=1, max_seq=512)      # noqa: E731
    plain = mk(cfg, weights).generate(prompt, SPEC_NEW)
    with held_to_plain("one speculative round", {"tcq4_matmul_gx2", "tcq4_matmul",
                                                 "q8_matmul", "flash_attention"}) as seen:
        out, st = generate_speculative(mk(cfg, weights), mk(cfg, weights), prompt, 2,
                                       n_draft=4)
        torch.cuda.synchronize()
    if st.n_drafted != 4:
        raise AssertionError(f"one speculative round drafted {st.n_drafted} tokens, not 4")
    print("  one speculative round (4 drafts, a 5-token verify), each launch vs its plain "
          "version (max rel): " + ", ".join(f"{k} {v[0]:.2e} (shapes {sorted(v[1])})"
                                            for k, v in seen.items()), flush=True)
    for label in ("self-draft", "qwen3-0.6b draft"):
        t1 = time.perf_counter()
        if label == "self-draft":
            out, st, drift = self_draft_drift(mk(cfg, weights), mk(cfg, weights), prompt,
                                              SPEC_NEW)
            extra = (f"; draft decode vs verify chunk logits part by rel L2 up to {drift:.4f} "
                     f"(B1's integer path against B4's dequantized one, reported)")
        else:
            out, st = generate_speculative(mk(cfg, weights), mk(dcfg, dweights), prompt,
                                           SPEC_NEW,
                                           n_draft=4)
            extra = ""
        torch.cuda.synchronize()
        agree = next((i for i, (a, b) in enumerate(zip(out, plain)) if a != b), len(out))
        print(f"  generate_speculative, {label}: {st.n_accepted} of {st.n_drafted} drafts "
              f"accepted ({st.acceptance_rate:.3f}), {SPEC_NEW} tokens in "
              f"{time.perf_counter() - t1:.1f} s; agrees with plain greedy decode for the "
              f"first {agree} of {SPEC_NEW} tokens (reported){extra}", flush=True)
    # the server's engine with the 0.6b draft: four greedy requests at once
    tctx = InferenceContext(cfg, weights, n_lanes=4, max_seq=512)
    eng = Engine(tctx, draft_ctx=InferenceContext(dcfg, dweights, n_lanes=4, max_seq=512),
                 n_draft=4)
    done, outs = {}, {i: [] for i in range(4)}
    for i, n_new in enumerate((6, 10, 14, 24)):
        eng.submit(GenRequest(prompt_tokens=ids(30), max_tokens=n_new,
                              params=SamplerParams(temperature=0.0),
                              on_token=lambda tk, pc, f, r, i=i:
                              done.__setitem__(i, r) if f else outs[i].append(tk)))
    t1 = time.perf_counter()
    for _ in range(2000):
        eng._iterate()
        if len(done) == 4:
            break
    torch.cuda.synchronize()
    if len(done) != 4 or [len(outs[i]) for i in range(4)] != [6, 10, 14, 24]:
        raise AssertionError(f"engine with a draft: {done}, {[len(o) for o in outs.values()]}")
    print(f"  Engine(ctx, draft_ctx=qwen3-0.6b), 4 greedy requests at once (6 / 10 / 14 / 24 "
          f"tokens) in {time.perf_counter() - t1:.1f} s: {eng.n_draft_accepted} of "
          f"{eng.n_drafted} drafts accepted", flush=True)
    del eng, tctx
    rep = ids(8) * 10
    t1 = time.perf_counter()
    out, st = generate_lookup(mk(cfg, weights), rep, 2 * SPEC_NEW)
    torch.cuda.synchronize()
    if len(out) != 2 * SPEC_NEW:
        raise AssertionError(f"generate_lookup returned {len(out)} tokens")
    print(f"  generate_lookup on an 8-token pattern x 10: {st.n_accepted} of {st.n_drafted} "
          f"drafts accepted, {len(out)} tokens in {time.perf_counter() - t1:.1f} s (random "
          f"weights "
          f"need not follow the pattern: a draft needs an n-gram seen before)", flush=True)
    del dweights
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_router(tcq4_path) -> None:
    """The model router: a server whose default model is the tiny preset on
    the card ``/models/load``s the 2-layer qwen3-4b-width TCQ4 GGUF of phase
    13 under a name, answers one completion routed to it by ``"model"``, and
    ``/models/unload``s it; the card's allocated memory must come back to
    within 0.1 GB of its value before the load."""
    import torch
    from http.server import ThreadingHTTPServer

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import PRESETS
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.serving.engine import Engine
    from rrs_tpu_torch.serving.server import ModelHandle, ServerState, make_handler

    t0 = time.perf_counter()
    tiny = PRESETS["tiny"]
    engine = Engine(InferenceContext(tiny, llama.random_weights(tiny, seed=0, device="cuda"),
                                     n_lanes=1, max_seq=128))
    state = ServerState(tiny, synthetic_vocab(tiny.vocab_size), engine, {}, "tiny")
    state.models["tcq4-2layer"] = ModelHandle("tcq4-2layer", str(tcq4_path), n_lanes=1,
                                              max_seq=256)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    engine.start()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        status, data = _http(port, "POST", "/models/load", {"model": "tcq4-2layer"})
        t_load = time.perf_counter() - t1
        if status != 200:
            raise AssertionError(f"/models/load answered {status}: {data[:300]!r}")
        loaded = torch.cuda.memory_allocated()
        status, data = _http(port, "POST", "/v1/completions",
                             {"model": "tcq4-2layer", "prompt": PIPELINE_PROMPT,
                              "max_tokens": 8, "temperature": 0.0})
        out = json.loads(data) if status == 200 else {}
        if status != 200 or out.get("model") != "tcq4-2layer" \
                or out["usage"]["completion_tokens"] < 1:
            raise AssertionError(f"routed completion: {status} {data[:300]!r}")
        status, data = _http(port, "POST", "/models/unload", {"model": "tcq4-2layer"})
        if status != 200:
            raise AssertionError(f"/models/unload answered {status}: {data[:300]!r}")
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    if abs(after - before) > 0.1 * GB:
        raise AssertionError(f"router: {after / GB:.3f} GB allocated after the unload, "
                             f"{before / GB:.3f} GB before the load")
    print(f"  router: /models/load of the 2-layer TCQ4 GGUF in {t_load:.1f} s "
          f"(+{(loaded - before) / GB:.3f} GB), a routed completion {out['choices'][0]['text']!r}, "
          f"/models/unload back to {after / GB:.3f} GB (before the load {before / GB:.3f} GB); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


T_START = time.perf_counter()


# -- DeepSeek-V2-Lite (MLA) and gemma3-4b: the attention families of the layer body --

# The GGUF metadata of DeepSeek-V2-Lite as its published config.json gives it
# (Hugging Face deepseek-ai/DeepSeek-V2-Lite; llama.cpp's converter writes these
# keys, the split k_b / v_b layout: the cache row sizes under key / value_length,
# the head sizes under the *_mla keys, 0.1 * mscale_all_dim as the YaRN log
# multiplier)
DEEPSEEK_V2_LITE_GGUF = {
    "general.architecture": "deepseek2", "deepseek2.block_count": 27,
    "deepseek2.context_length": 163840, "deepseek2.embedding_length": 2048,
    "deepseek2.feed_forward_length": 10944, "deepseek2.attention.head_count": 16,
    "deepseek2.attention.head_count_kv": 1, "deepseek2.attention.key_length": 576,
    "deepseek2.attention.value_length": 512, "deepseek2.attention.key_length_mla": 192,
    "deepseek2.attention.value_length_mla": 128,
    "deepseek2.attention.layer_norm_rms_epsilon": 1e-6, "deepseek2.rope.freq_base": 10000.0,
    "deepseek2.rope.dimension_count": 64, "deepseek2.rope.scaling.type": "yarn",
    "deepseek2.rope.scaling.factor": 40.0,
    "deepseek2.rope.scaling.original_context_length": 4096,
    "deepseek2.rope.scaling.yarn_log_multiplier": 0.0707,
    "deepseek2.attention.kv_lora_rank": 512, "deepseek2.leading_dense_block_count": 1,
    "deepseek2.expert_count": 64, "deepseek2.expert_used_count": 6,
    "deepseek2.expert_shared_count": 2, "deepseek2.expert_feed_forward_length": 1408,
    "deepseek2.expert_weights_scale": 1.0, "deepseek2.vocab_size": 102400}
# The GGUF metadata of gemma-3-4b's text model as the published config.json of
# google/gemma-3-4b-it gives it (query_pre_attn_scalar 256 = head_dim)
GEMMA3_4B_GGUF = {
    "general.architecture": "gemma3", "gemma3.block_count": 34,
    "gemma3.context_length": 131072, "gemma3.embedding_length": 2560,
    "gemma3.feed_forward_length": 10240, "gemma3.attention.head_count": 8,
    "gemma3.attention.head_count_kv": 4, "gemma3.attention.key_length": 256,
    "gemma3.attention.value_length": 256, "gemma3.attention.layer_norm_rms_epsilon": 1e-6,
    "gemma3.rope.freq_base": 1e6, "gemma3.attention.sliding_window": 1024,
    "gemma3.rope.scaling.type": "linear", "gemma3.rope.scaling.factor": 8.0,
    "gemma3.vocab_size": 262208}
# the layers of their full-width runs, cut so that the script fits its time
# limit beside phase 18 (with all 27 and 34, and before phase 18, it took
# 1,058 s to its summary on an H100 80GB HBM3 at 700 W): DeepSeek-V2-Lite
# keeps its dense lead layer and 8 MoE layers, gemma3-4b two periods of five
# sliding layers and a global one
DEEPSEEK_V2_LITE_LAYERS = 9
GEMMA3_LAYERS = 12
MLA_PATH = {"tcq4_matmul_gx2", "tcq4_matmul", "tcq4_matmul_i8p", "q8_matmul"}
GEMMA3_NEW = 16
# the 2-layer family checks: arch -> config fields at reduced widths
FAMILY_SMALL = {
    "gemma2": dict(arch="gemma2", n_heads=4, n_kv_heads=2, head_dim=256, swa_window=32,
                   swa_pattern=2, attn_softcap=50.0, final_softcap=30.0, ffn_act="gelu",
                   embd_scale=1024.0 ** 0.5, sandwich_norm=True, attn_scale=1.0 / 16.0,
                   tie_embeddings=True),
    "granite": dict(arch="granite", rope_neox=False, embd_scale=6.0, residual_scale=0.22,
                    logits_divisor=4.0, attn_scale=0.015625),
    "minicpm": dict(arch="minicpm", embd_scale=12.0, residual_scale=1.4 / 2 ** 0.5,
                    logits_divisor=0.25),
    "olmo2": dict(arch="olmo2", qk_norm=True, qk_norm_full=True, post_norm_only=True),
    "phi3": dict(arch="phi3", rope_rot_dim=64, rope_orig_context=1024, rope_scale_factor=4.0),
    "llama-moe": dict(arch="llama", rope_neox=False, n_experts=8, n_experts_used=2,
                      n_ff_exp=512),
}


def mark_launches(reports, key: str) -> dict:
    """Every kernel's launch count since the last reset, into its report
    under ``key``; returns the non-zero ones."""
    from rrs_tpu_torch import kernels

    out = {}
    for rep in reports.values():
        n = kernels.LAUNCHES[rep.entry["name"]]
        rep.entry[key] = n
        if n:
            out[rep.entry["name"]] = n
    return out


def family_small_weights(cfg, seed: int):
    """Dense bf16 weights of a 2-layer family check on the CPU
    (``random_weights``), with the norms drawn around 1, olmo2's q / k norms
    over the whole projection and its post norms, and phi3's LongRoPE
    factors."""
    import dataclasses

    import torch

    from rrs_tpu_torch.models import llama

    w = llama.random_weights(cfg, seed=seed, device="cpu", scale=0.05)
    gen = torch.Generator().manual_seed(seed + 1)

    def norm(n):
        return (1.0 + 0.2 * torch.randn(n, generator=gen)).to(torch.bfloat16)

    layers = []
    for lw in w.layers:
        e = cfg.n_embd
        extra = dict(attn_norm=norm(e), ffn_norm=norm(e))
        if cfg.qk_norm:
            qd, kd = (cfg.n_q_dim, cfg.n_kv_dim) if cfg.qk_norm_full else (cfg.head_dim,) * 2
            extra.update(q_norm=norm(qd), k_norm=norm(kd))
        if cfg.sandwich_norm or cfg.post_norm_only:
            extra.update(attn_post_norm=norm(e), ffn_post_norm=norm(e))
        layers.append(dataclasses.replace(lw, **extra))
    factors = None
    if cfg.rope_rot_dim:
        factors = 1.0 + 3.0 * torch.rand(cfg.rope_rot_dim // 2, generator=gen)
    return dataclasses.replace(w, layers=layers, rope_factors=factors,
                               final_norm=norm(cfg.n_embd))


def phase_families_small():
    """tiny-mla (q LoRA, V3 routing: sigmoid gating, groups, selection bias)
    in 2 layers on the card against the CPU, with dense weights (logits
    within GLUE_TOL) and, at E = 256 so that every projection is TCQ4, with
    fabricated TCQ4 weights (every launch held to its plain version, the
    drift reported); then each dense family in 2 layers at reduced widths,
    logits within GLUE_TOL: gemma2 (softcaps 50 / 30) over bf16 and q8 KV
    (B3 and B6 with the softcap), granite, minicpm, olmo2, phi3 (partial
    rotary, LongRoPE factors) and a llama-architecture MoE."""
    import dataclasses

    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import PRESETS, ModelConfig

    t0 = time.perf_counter()
    rng = torch.Generator().manual_seed(8)
    tiny = dataclasses.replace(PRESETS["tiny-mla"], n_layers=2)
    wide = dataclasses.replace(tiny, n_embd=256, q_lora_rank=256, v_head_dim=64, n_ff=512)
    prompts = {"40": torch.randint(0, 512, (40,), generator=rng).tolist(),
               "300": torch.randint(0, 512, (300,), generator=rng).tolist()}
    card_vs_cpu("tiny-mla dense (2 layers)", tiny,
                llama.fabricated_mla_weights(tiny, seed=3, device="cpu", quantized=False),
                prompts, set(), held_logits=True)
    card_vs_cpu("tiny-mla TCQ4 at E=256 (2 layers)", wide,
                llama.fabricated_mla_weights(wide, seed=3, device="cpu"), prompts, MLA_PATH,
                held_logits=False)
    base = dict(n_layers=2, n_embd=1024, n_heads=8, n_kv_heads=4, head_dim=128, n_ff=2048,
                vocab_size=4096, context_length=4096)
    fam_prompts = {"40": torch.randint(0, 4096, (40,), generator=rng).tolist()}
    for i, (fam, fields) in enumerate(FAMILY_SMALL.items()):
        cfg = ModelConfig(**{**base, **fields})
        w = family_small_weights(cfg, seed=20 + i)
        for kvq in (("none", "q8") if fam == "gemma2" else ("none",)):
            expect = {"flash_attention_q8" if kvq == "q8" else "flash_attention"}
            card_vs_cpu(f"{fam} (2 layers{', q8 KV' if kvq == 'q8' else ''})", cfg, w,
                        fam_prompts, expect, held_logits=True, kv_quant=kvq)
    print(f"  2-layer checks took {time.perf_counter() - t0:.1f} s", flush=True)


def phase_mla_generate(reports):
    """``generate`` at DeepSeek-V2-Lite's published widths, cut to
    DEEPSEEK_V2_LITE_LAYERS of its 27 layers (the config from
    ``ModelConfig.from_gguf`` on its metadata; weights fabricated
    on the card in the quantizer's types by ``fabricated_mla_weights``):
    greedy prompts of 5, 40 and 300 tokens x 32 new tokens over bf16 and then
    q8 KV, the launch counts set to 0 before and read after, the MoE
    branches taken (the dense expert stacks: the gather at <= 16 tokens, the
    capacity dispatch and its all-experts fallback)."""
    import dataclasses

    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg = dataclasses.replace(ModelConfig.from_gguf(DEEPSEEK_V2_LITE_GGUF),
                              n_layers=DEEPSEEK_V2_LITE_LAYERS)
    t0 = time.perf_counter()
    weights = llama.fabricated_mla_weights(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(weights))
    exp_bytes = sum(t.numel() * t.element_size() for lw in weights.layers if lw.moe is not None
                    for t in (lw.moe.gate, lw.moe.up, lw.moe.down))
    kinds = {f: type(getattr(weights.layers[0], f)).__name__
             for f in ("wq", "wkv_a", "wo", "w_gate", "w_down")}
    print(f"  DeepSeek-V2-Lite config: {cfg.n_layers} layers, E={cfg.n_embd}, {cfg.n_heads} heads "
          f"(nope {cfg.qk_nope_dim} + rope {cfg.qk_rope_dim}, v {cfg.v_head_dim}), kv_lora "
          f"{cfg.kv_lora_rank} (cache rows {cfg.kv_k_dim} / {cfg.kv_v_dim}), {cfg.n_dense_lead} "
          f"dense lead layer of {cfg.n_ff}, {cfg.n_experts} experts of {cfg.n_ff_exp} top-"
          f"{cfg.n_experts_used} + 2 shared, YaRN x{cfg.rope_scale_factor:g} (log mul "
          f"{cfg.rope_yarn_log_mul:.3f}, kq scale {llama.mla_kq_scale(cfg):.6f}); fabricated "
          f"weights {w_bytes / GB:.2f} GB (routed experts {exp_bytes / GB:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s; lead layer linears {kinds}", flush=True)
    rng = torch.Generator().manual_seed(0)
    prompts = {n: torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (5, 40, 300)}
    warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    warm.generate(prompts[5], 2)
    del warm
    ctxs = {}
    for quant in ("none", "q8"):
        ctxs[quant] = ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024,
                                             kv_quant=quant)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = {}
        with moe_branches() as branches:
            for n, p in prompts.items():
                outs[n] = ctx.generate(p, 32)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = mark_launches(reports, "launches_mla" if quant == "none" else "launches_mla_q8")
        for n, out in outs.items():
            if len(out) != 32 or not all(0 <= tok < cfg.vocab_size for tok in out):
                raise AssertionError(f"DeepSeek-V2-Lite generate {n}: {len(out)} tokens: {out}")
        if MLA_PATH - set(launches) or any(k.startswith("flash") for k in launches):
            raise AssertionError(f"DeepSeek-V2-Lite generate ({quant} KV): launches {launches}")
        if branches["rows"] or not branches["capacity"] + branches["fallback"]:
            raise AssertionError(f"DeepSeek-V2-Lite generate: dense branches {branches}")
        perf = ctx.perf()
        print(f"  generate ({'bf16' if quant == 'none' else quant} KV): prompts 5/40/300 x 32 "
              f"new tokens in {dt:.1f} s; prefill {perf['n_p_eval']} tok @ "
              f"{perf['pp_tok_per_s']:.1f} tok/s, decode {perf['n_eval']} tok @ "
              f"{perf['tg_tok_per_s']:.2f} tok/s ({perf['t_eval_ms'] / max(perf['n_eval'], 1):.3f}"
              f" ms/token); KV resident {ctx.kv.nbytes() / GB:.4f} GB (S=1024, one 576 + 512 "
              f"row a slot and layer), peak memory {torch.cuda.max_memory_allocated() / GB:.2f} "
              f"GB; MoE branches {branches}; greedy {outs[40][:6]}...; launches {launches}",
              flush=True)
    return cfg, weights, ctxs, prompts


def phase_mla_held(ctx, prompts, quant: str):
    """On the layers ``generate`` ran, over the context's quantized cache:
    teacher-forced prefills of 40 tokens (B4 at N = 3,072 and 576, B2 at K =
    10,944) and of 300 (a 512-row bucket: B5) and one decode step after each
    (B1), every kernel launch held to its plain version on the very inputs
    it got and every K / V store (one head, 576- and 512-wide rows) held bit
    for bit to the CPU's (``store_held``); then one context shift of the
    300-token lane held to the CPU's (``shift_held``) and a decode step
    after it."""
    import torch

    label = f"DeepSeek-V2-Lite {quant}"
    t0 = time.perf_counter()
    with held_to_plain(label, MLA_PATH) as seen, store_held(label) as stores:
        for n in (40, 300):
            seq = ctx.new_sequence()
            last = ctx.prefill(seq, prompts[n])[-1]
            out = ctx.decode({seq: int(last.argmax())})[seq]
            if not (torch.isfinite(last).all() and torch.isfinite(out).all()):
                raise AssertionError(f"{label} held steps, {n}: non-finite logits")
            if n == 40:
                ctx.kv.seq_rm(seq)
        torch.cuda.synchronize()
    for name, (worst, shapes) in sorted(seen.items()):
        print(f"  {label} held, {name}: max rel {worst:.2e} <= {SMALL_TOL[name]:.0e}; "
              f"shapes {sorted(shapes)}", flush=True)
    print(f"  {label}: held prefills of 40 and 300 tokens + a decode step each in "
          f"{time.perf_counter() - t0:.1f} s; {stores['stores']} K/V stores "
          f"({stores['rows']} rows) bit-equal to the CPU's", flush=True)
    shift_held(ctx, "DeepSeek-V2-Lite MLA")
    if not torch.isfinite(ctx.decode({seq: 7})[seq]).all():
        raise AssertionError(f"{label} context shift: non-finite logits after it")
    ctx.kv.seq_rm(seq)


def phase_mla_q4(cfg, weights, prompts, reports):
    """MLA over a q4 cache (one head, the halves layout: 288-byte K rows and
    256-byte V rows a slot): greedy ``generate`` of the 40-token prompt x 32
    new tokens with its launch counts, then ``phase_mla_held`` over it."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.runtime.context import InferenceContext

    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024, kv_quant="q4")
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = ctx.generate(prompts[40], 32)
    torch.cuda.synchronize()
    launches = mark_launches(reports, "launches_mla_q4")
    if len(out) != 32 or not all(0 <= tok < cfg.vocab_size for tok in out) \
            or MLA_PATH - {"tcq4_matmul_i8p"} - set(launches) or any(k.startswith("flash") for k in launches):
        raise AssertionError(f"DeepSeek-V2-Lite generate (q4 KV): {out}; launches {launches}")
    print(f"  generate (q4 KV): prompt 40 x 32 new tokens in {time.perf_counter() - t0:.1f} s; "
          f"K / V rows of {ctx.kv.k[0][0].shape[-1]} / {ctx.kv.v[0][0].shape[-1]} bytes a slot; "
          f"greedy {out[:6]}...; launches {launches}", flush=True)
    phase_mla_held(ctx, prompts, "q4")
    del ctx


def device_ms_of(fn, reps: int = 5) -> float:
    """The device ms of one call of ``fn``: torch.profiler over ``reps``
    calls after two warm-up calls, the kernels' durations summed. Where the
    profiler records no device event (it missed a session late in a long
    process once), CUDA events around the calls instead, queued behind a
    device sleep longer than the host takes to issue them, so that the
    launch gaps do not count; that reading is said to be so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events, by_name = device_ms_by_kernel(prof)
    if events:
        return sum(by_name.values()) / reps
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(host_s * reps * 4e9))        # cycles: ~2 s per s of issue time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    print(f"  (the profiler recorded no device time: {ms:.3f} ms a call from CUDA events)",
          flush=True)
    return ms


def mla_attend_ms(cfg, b: int, s: int, quant: str) -> float:
    """The device ms a decode step spends in MLA's plain attention
    (``mla_attend``: the q8 / q4 dequantization of the whole cache, scores,
    softmax, read-out) at B lanes of S slots, all live, times the layers.
    The cache is filled with random rows through the model's store."""
    import dataclasses

    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.runtime.kv_cache import KVCache

    gen = torch.Generator(device="cuda").manual_seed(1)
    kv = KVCache.create(dataclasses.replace(cfg, n_layers=1), b, s, device="cuda", quant=quant)
    kc, vc = kv.k[0], kv.v[0]
    new = torch.randn((b, 1, s, cfg.kv_k_dim), generator=gen, device="cuda").to(torch.bfloat16)
    llama._store_cache(kc, new, [0] * b)
    llama._store_cache(vc, new[..., cfg.qk_rope_dim:], [0] * b)
    q = torch.randn((b, 1, cfg.n_heads, cfg.kv_k_dim), generator=gen, device="cuda").to(
        torch.bfloat16)
    mask = torch.full((b, 1), s - 1, device="cuda")
    scale = llama.mla_kq_scale(cfg)
    ms = device_ms_of(lambda: llama.mla_attend(q, kc, vc, mask, scale)) * cfg.n_layers
    del kv
    return ms


def mla_decode_split(cfg, weights, device_ms: float, s: int) -> None:
    """Where DeepSeek-V2-Lite's B = 1 decode step's device time goes, each
    part timed alone at the decode shape over its layers: the MoE layers'
    router (``moe.route``), the routed experts' dense gather
    (``moe._dense_ffn``, less the router) and the shared experts with the
    combine (``moe_ffn``, less both), and MLA's plain attention over a bf16
    cache of S slots; each as a share of the step's ``device_ms``."""
    import torch

    from rrs_tpu_torch.models import moe

    mws = [lw.moe for lw in weights.layers if lw.moe is not None]
    gen = torch.Generator(device="cuda").manual_seed(2)
    x2 = torch.randn((1, cfg.n_embd), generator=gen, device="cuda").to(torch.bfloat16)

    def routers():
        for mw in mws:
            moe.route(cfg, mw, x2)

    def routed():
        for mw in mws:
            topi, topv = moe.route(cfg, mw, x2)
            moe._dense_ffn(cfg, mw, x2, topi, topv, x2.dtype)

    def whole():
        for mw in mws:
            moe.moe_ffn(cfg, mw, x2[None])

    r_ms, g_ms, w_ms = device_ms_of(routers), device_ms_of(routed), device_ms_of(whole)
    a_ms = mla_attend_ms(cfg, 1, s, "none")
    parts = {"router": r_ms, "routed experts' dense gather": g_ms - r_ms,
             "shared experts and combine": w_ms - g_ms, "MLA's plain attention": a_ms}
    rest = device_ms - sum(parts.values())
    print(f"  DeepSeek-V2-Lite decode step, B=1, of its {device_ms:.3f} device ms ("
          f"{len(mws)} MoE layers, each part timed alone): "
          + ", ".join(f"{k} {v:.3f} ({v / device_ms:.3f})" for k, v in parts.items())
          + f"; the rest (the port's kernels, norms, RoPE, the lead layer, the head) "
          f"{rest:.3f} ({rest / device_ms:.3f})", flush=True)


def mla_served_share(ctx) -> None:
    """MLA's plain attention at the served geometry: the server's 4-lane,
    4,096-slot context with four prompts prefilled, one sampled decode run
    profiled (``profile_decode_run``); ``mla_attend`` at 4 lanes x 4,096
    live slots over bf16 and q8 caches, each as a share of that step's
    device ms (the step's other work does not depend on the KV type)."""
    seqs, first, lengths = prefill_four(ctx)
    prof = profile_decode_run(ctx, seqs, first, lengths, label="DeepSeek-V2-Lite bf16 KV")
    for seq in seqs:
        ctx.kv.seq_rm(seq)
    if not prof:
        return
    dev = prof["device_ms"]
    b, s = ctx.kv.n_lanes, ctx.kv.max_seq
    for quant in ("none", "q8"):
        ms = mla_attend_ms(ctx.cfg, b, s, quant)
        print(f"  MLA's plain attention at {b} lanes x {s} slots, "
              f"{'bf16' if quant == 'none' else quant} KV: {ms:.3f} device ms a decode step = "
              f"{ms / dev:.3f} of the served step's {dev:.3f} device ms", flush=True)


MLA_COUNTERS = {"gx2": "tcq4_matmul_gx2", "tcq4": "tcq4_matmul", "i8p": "tcq4_matmul_i8p",
                "q8": "q8_matmul"}


def phase_mla(reports):
    """DeepSeek-V2-Lite at its published widths: generate, held steps with
    the stores held and a context shift over q8 and q4 KV, the server (4
    slots, ctx 4096, four 1,000 / 2,000-token requests) and MLA's plain
    attention's share of its decode step, a B = 1 decode profile split by
    part."""
    cfg, weights, ctxs, prompts = phase_mla_generate(reports)
    phase_mla_held(ctxs["q8"], prompts, "q8")
    del ctxs["q8"]
    phase_mla_q4(cfg, weights, prompts, reports)
    t0 = time.perf_counter()
    served, _, _ = serve_four(cfg, weights, "DeepSeek-V2-Lite", MLA_COUNTERS)
    print(f"  DeepSeek-V2-Lite serving took {time.perf_counter() - t0:.1f} s", flush=True)
    mla_served_share(served)
    del served
    prof = profile_decode(ctxs["none"], prompts[40], label="DeepSeek-V2-Lite")
    if prof:
        mla_decode_split(cfg, weights, prof["device_ms"], ctxs["none"].kv.max_seq)
    del ctxs, weights


def phase_gemma3(reports):
    """gemma3-4b at its published widths, cut to GEMMA3_LAYERS of its 34
    layers (the config from
    ``ModelConfig.from_gguf`` on its metadata: 8 / 4 heads x 256, FF 10,240,
    five sliding layers of every six over 1,024-window rings with a 10k
    base, linear x8 RoPE on the global ones, the sqrt(E) embedding scale,
    GEGLU, q / k and sandwich norms; fabricated TCQ4 linears with their i8p
    packs, a Q8_0 lm_head over the 262,208-entry vocabulary): greedy prompts
    of 5, 40 and 1,600 tokens (past the 1,536-slot rings, which wrap) x 16
    new tokens over bf16 and q8 KV, launch counts read after each; a
    teacher-forced 560-token prefill (chunks of 512 rows, B5, and 48, B4)
    and a decode step with every launch held to its plain version; one
    decode profile."""
    import dataclasses

    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg = dataclasses.replace(ModelConfig.from_gguf(GEMMA3_4B_GGUF), n_layers=GEMMA3_LAYERS)
    t0 = time.perf_counter()
    weights = llama.fabricated_tcq4_weights(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(weights))
    n_swa = sum(cfg.is_swa(i) for i in range(cfg.n_layers))
    print(f"  gemma3-4b config: {cfg.n_layers} layers ({n_swa} "
          f"sliding, window {cfg.swa_window}, base {cfg.rope_theta_swa:g}; global base "
          f"{cfg.rope_theta:g} with {cfg.rope_scaling_type} x{cfg.rope_scale_factor:g}), E="
          f"{cfg.n_embd}, {cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, FF {cfg.n_ff}, "
          f"vocab {cfg.vocab_size}, embd scale {cfg.embd_scale:.3f}; fabricated weights "
          f"{w_bytes / GB:.2f} GB in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator().manual_seed(0)
    prompts = {n: torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (5, 40, 1600)}
    warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=2048)
    warm.generate(prompts[5], 2)
    del warm
    ctxs = {}
    for quant in ("none", "q8"):
        ctxs[quant] = ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=2048,
                                             kv_quant=quant)
        ring = min(ctx.kv.sizes)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = {n: ctx.generate(p, GEMMA3_NEW) for n, p in prompts.items()}
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = mark_launches(reports, "launches_gemma3" if quant == "none"
                                 else "launches_gemma3_q8")
        attn = "flash_attention" if quant == "none" else "flash_attention_q8"
        for n, out in outs.items():
            if len(out) != GEMMA3_NEW or not all(0 <= tok < cfg.vocab_size for tok in out):
                raise AssertionError(f"gemma3-4b generate {n}: {len(out)} tokens: {out}")
        if ({"tcq4_matmul_gx2", "tcq4_matmul", "tcq4_matmul_i8p", "q8_matmul", attn}
                - set(launches)) or 1600 + GEMMA3_NEW <= ring:
            raise AssertionError(f"gemma3-4b generate ({quant} KV): ring {ring}, launches "
                                 f"{launches}")
        perf = ctx.perf()
        print(f"  generate ({'bf16' if quant == 'none' else quant} KV): prompts 5/40/1600 x "
              f"{GEMMA3_NEW} new tokens in {dt:.1f} s (rings of {ring} slots wrapped); prefill "
              f"{perf['n_p_eval']} tok @ {perf['pp_tok_per_s']:.1f} tok/s, decode "
              f"{perf['n_eval']} tok @ {perf['tg_tok_per_s']:.2f} tok/s; KV resident "
              f"{ctx.kv.nbytes() / GB:.3f} GB; greedy {outs[40][:6]}...; launches {launches}",
              flush=True)
    t0 = time.perf_counter()
    ctx = ctxs["none"]
    with held_to_plain("gemma3-4b", BF16_PATH) as seen:
        seq = ctx.new_sequence()
        last = ctx.prefill(seq, prompts[1600][:560])[-1]
        out = ctx.decode({seq: int(last.argmax())})[seq]
        if not (torch.isfinite(last).all() and torch.isfinite(out).all()):
            raise AssertionError("gemma3-4b held steps: non-finite logits")
        ctx.kv.seq_rm(seq)
        torch.cuda.synchronize()
    print("  gemma3-4b held (bf16 KV; a 560-token prefill, chunks of 512 and 48, + a decode "
          "step), max rel by "
          "kernel: " + ", ".join(f"{k} {v[0]:.2e} <= {SMALL_TOL[k]:.0e}"
                                 for k, v in sorted(seen.items()))
          + f" in {time.perf_counter() - t0:.1f} s", flush=True)
    prof = profile_decode(ctx, prompts[40], label="gemma3-4b")
    del ctx, ctxs, weights
    return prof


# -- The recurrent families: Falcon-Mamba-7B, RWKV-6 7B, Jamba-v0.1 ---------------

# The GGUF metadata of Falcon-Mamba-7B as its published config.json gives it
# (Hugging Face tiiuae/falcon-mamba-7b: hidden 4,096, 64 layers, expand 2,
# d_state 16, d_conv 4, time_step_rank 256, vocab 65,024, the weightless
# dt / B / C norms; llama.cpp's converter writes these keys), cut to 16 of
# its 64 layers and RWKV-6 7B to 8 of 32 below, so that the script keeps to
# its time limit on a slow host (with both whole it took 1,118 s on an
# H100 80GB HBM3 at 700 W; at 32 and 16 layers, before phase 17, 953 s);
# widths as published
FALCON_MAMBA_LAYERS = 16
RWKV6_LAYERS = 8
FALCON_MAMBA_7B_GGUF = {
    "general.architecture": "falcon_mamba", "falcon_mamba.block_count": FALCON_MAMBA_LAYERS,
    "falcon_mamba.context_length": 1048576, "falcon_mamba.embedding_length": 4096,
    "falcon_mamba.feed_forward_length": 0, "falcon_mamba.attention.head_count": 0,
    "falcon_mamba.attention.layer_norm_rms_epsilon": 1e-5, "falcon_mamba.ssm.conv_kernel": 4,
    "falcon_mamba.ssm.inner_size": 8192, "falcon_mamba.ssm.state_size": 16,
    "falcon_mamba.ssm.time_step_rank": 256, "falcon_mamba.ssm.dt_b_c_rms": True,
    "falcon_mamba.vocab_size": 65024}
# RWKV-6 Finch 7B (Hugging Face RWKV/v6-Finch-7B-HF: hidden 4,096, 32 layers,
# head size 64, intermediate 14,336, vocab 65,536, rescale_every 6; the
# converter's extra widths for a 4,096-wide model, 64 and 128)
RWKV6_7B_GGUF = {
    "general.architecture": "rwkv6", "rwkv6.block_count": RWKV6_LAYERS,
    "rwkv6.context_length": 1048576,
    "rwkv6.embedding_length": 4096, "rwkv6.feed_forward_length": 14336,
    "rwkv6.attention.head_count": 0, "rwkv6.wkv.head_size": 64,
    "rwkv6.time_mix_extra_dim": 64, "rwkv6.time_decay_extra_dim": 128,
    "rwkv6.rescale_every_n_layers": 6, "rwkv6.attention.layer_norm_epsilon": 1e-5,
    "rwkv6.vocab_size": 65536}
# Jamba-v0.1 (Hugging Face ai21labs/Jamba-v0.1: hidden 4,096, 32 / 8 heads,
# intermediate 14,336, 16 experts top-2 on odd layers, attention at layer 4
# of each period of 8, expand 2, d_state 16, dt_rank 256, vocab 65,536),
# cut to one period of 8 of its 32 layers; head_count_kv as the scalar the
# JAX package reads (llama.cpp's converter writes a per-layer array)
JAMBA_LAYERS = 8
JAMBA_V01_GGUF = {
    "general.architecture": "jamba", "jamba.block_count": JAMBA_LAYERS,
    "jamba.context_length": 262144, "jamba.embedding_length": 4096,
    "jamba.feed_forward_length": 14336, "jamba.attention.head_count": 32,
    "jamba.attention.head_count_kv": 8, "jamba.attention.layer_norm_rms_epsilon": 1e-6,
    "jamba.ssm.conv_kernel": 4, "jamba.ssm.inner_size": 8192, "jamba.ssm.state_size": 16,
    "jamba.ssm.time_step_rank": 256, "jamba.expert_count": 16, "jamba.expert_used_count": 2,
    "jamba.vocab_size": 65536}
# new tokens a recurrent generate / served request asks for
RECUR_NEW = 32
RECUR_SERVE_NEW = 16
RECUR_COUNTERS = {"gx2": "tcq4_matmul_gx2", "tcq4": "tcq4_matmul", "i8p": "tcq4_matmul_i8p",
                  "q8": "q8_matmul"}
# the 2-layer checks: arch -> config fields at reduced widths (every linear
# TCQ4-eligible where the full-width one is: Falcon-Mamba's dt_rank 256)
RECUR_SMALL = {
    "mamba": dict(arch="mamba", ssm_d_conv=4, ssm_d_inner=1024, ssm_d_state=16, ssm_dt_rank=32),
    "falcon_mamba": dict(arch="falcon_mamba", ssm_d_conv=4, ssm_d_inner=1024, ssm_d_state=16,
                         ssm_dt_rank=256, ssm_dt_b_c_rms=True, rms_eps=1e-5),
    "rwkv6": dict(arch="rwkv6", n_ff=1792, rwkv_head_size=64, rwkv_tm_extra=32,
                  rwkv_decay_extra=64, rwkv_rescale_every=1),
    "jamba": dict(arch="jamba", n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128, n_ff=1024,
                  ssm_d_conv=4, ssm_d_inner=1024, ssm_d_state=16, ssm_dt_rank=256, no_rope=True,
                  n_experts=4, n_experts_used=2),
}


def recurrent_weights(cfg, seed: int, device, quantized: bool = True):
    """Fabricated weights of a recurrent / hybrid config (the model module's
    ``fabricated_tcq4_weights``); Jamba's 2-layer check puts its attention
    layer second and its MoE FFN first."""
    from rrs_tpu_torch.models import hybrid, mamba, rwkv6

    if cfg.is_hybrid:
        kw = dict(attn_period=2, attn_offset=1, expert_period=2, expert_offset=0) \
            if cfg.n_layers == 2 else {}
        return hybrid.fabricated_tcq4_weights(cfg, seed=seed, device=device,
                                              quantized=quantized, **kw)
    mod = rwkv6 if cfg.rwkv_head_size else mamba
    return mod.fabricated_tcq4_weights(cfg, seed=seed, device=device, quantized=quantized)


def phase_recurrent_small():
    """Each recurrent family in 2 layers at reduced widths (E = 512, vocab
    4,096) on the card against the same weights on the CPU, through the
    context ``make_context`` picks: bf16 dense weights (logits within
    GLUE_TOL; the states after prefill reported), then fabricated TCQ4
    weights (every launch held to its plain version, the drift reported):
    Mamba, Falcon-Mamba (the weightless dt / B / C norms, ssm_dt TCQ4 at K =
    256, ssm_x at N = 288), RWKV6 (x halved every layer) and Jamba (an MoE
    Mamba layer, then attention without RoPE and a dense FFN)."""
    import torch

    from rrs_tpu_torch.models.config import ModelConfig

    t0 = time.perf_counter()
    rng = torch.Generator().manual_seed(16)
    base = dict(n_layers=2, n_embd=512, n_heads=0, n_kv_heads=0, head_dim=0, n_ff=0,
                vocab_size=4096, context_length=4096)
    prompts = {"40": torch.randint(0, 4096, (40,), generator=rng).tolist(),
               "300": torch.randint(0, 4096, (300,), generator=rng).tolist()}
    for i, (fam, fields) in enumerate(RECUR_SMALL.items()):
        cfg = ModelConfig(**{**base, **fields})
        attn = {"flash_attention"} if cfg.is_hybrid else set()
        card_vs_cpu(f"{fam} dense (2 layers)", cfg,
                    recurrent_weights(cfg, 40 + i, "cpu", quantized=False), prompts, attn,
                    held_logits=True)
        expect = {"tcq4_matmul_gx2", "tcq4_matmul", "q8_matmul"} | attn
        if cfg.is_hybrid:
            expect |= {"tcq4_matmul_experts_rows"}
        card_vs_cpu(f"{fam} TCQ4 (2 layers)", cfg, recurrent_weights(cfg, 40 + i, "cpu"),
                    prompts, expect, held_logits=False)
    print(f"  recurrent 2-layer checks took {time.perf_counter() - t0:.1f} s", flush=True)


def decode_step_bytes(cfg, weights, state_bytes: int) -> float:
    """The bytes a B = 1 decode step must move: every weight it reads once
    (a TCQ4 linear's codes and scales, not its i8p pack, which only prefill
    reads; a Q8 head's codes and scales; an MoE layer's router and top-k of
    its experts' stacks; the f32 norms, lerps, conv taps, A and D), one
    embedding row, and the recurrent state read and written."""
    import dataclasses

    import torch

    from rrs_tpu_torch.models.linear import Q8Linear, TCQ4Linear
    from rrs_tpu_torch.models.moe import MoEWeights

    def nbytes(t):
        return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0

    def walk(obj) -> float:
        if isinstance(obj, TCQ4Linear):
            return nbytes(obj.qs) + nbytes(obj.eff)
        if isinstance(obj, Q8Linear):
            return nbytes(obj.q) + nbytes(obj.scale)
        if isinstance(obj, MoEWeights):
            stacks = sum(nbytes(getattr(obj, f)) for f in (
                "gate", "up", "down", "gate_qs", "gate_eff", "up_qs", "up_eff", "down_qs",
                "down_eff"))
            return nbytes(obj.router) + stacks * cfg.n_experts_used / cfg.n_experts
        if isinstance(obj, torch.Tensor):
            return nbytes(obj)
        if dataclasses.is_dataclass(obj):
            return sum(walk(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                       if f.name != "embed")
        if isinstance(obj, (list, tuple)):
            return sum(walk(o) for o in obj)
        return 0
    row = weights.embed[0]
    return walk(weights) + nbytes(row) + 2 * state_bytes


def recurrent_generate(label, cfg, weights, key, reports, expect):
    """``generate`` of 5-, 40- and 300-token greedy prompts x RECUR_NEW new
    tokens on a one-lane context (``make_context``), after a warm-up; the
    launch counts set to 0 before and read after (into each report under
    ``key``); every kernel of ``expect`` must have launched. Returns the
    context and the prompts."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.runtime.recurrent import make_context

    rng = torch.Generator().manual_seed(0)
    prompts = {n: torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (5, 40, 300)}
    ctx = make_context(cfg, weights, n_lanes=1, max_seq=1024)
    ctx.generate(prompts[5], 2)
    ctx.n_prefill_tokens = ctx.n_decode_tokens = 0
    ctx.t_prefill_s = ctx.t_decode_s = 0.0
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with moe_branches() as branches:
        outs = {n: ctx.generate(p, RECUR_NEW) for n, p in prompts.items()}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = mark_launches(reports, key)
    for n, out in outs.items():
        if len(out) != RECUR_NEW or not all(0 <= tok < cfg.vocab_size for tok in out):
            raise AssertionError(f"{label} generate {n}: {len(out)} tokens: {out}")
    if set(expect) - set(launches):
        raise AssertionError(f"{label} generate: kernels not launched: "
                             f"{set(expect) - set(launches)}; launches {launches}")
    perf = ctx.perf()
    step_bytes = decode_step_bytes(cfg, weights, ctx.kv.nbytes() - sum(
        t.numel() * t.element_size() for t in getattr(ctx.kv, "k", []) + getattr(ctx.kv, "v", [])
        if t is not None))
    bw = card_peaks(torch.cuda.get_device_name(0))[0]
    print(f"  {label} generate: prompts 5/40/300 x {RECUR_NEW} new tokens in {dt:.1f} s; "
          f"prefill {perf['n_p_eval']} tok @ {perf['pp_tok_per_s']:.1f} tok/s, decode "
          f"{perf['n_eval']} tok @ {perf['tg_tok_per_s']:.2f} tok/s "
          f"({perf['t_eval_ms'] / max(perf['n_eval'], 1):.3f} ms/token; bytes bound "
          f"{step_bytes / bw * 1e3:.3f} ms a step: {step_bytes / GB:.3f} GB at "
          f"{bw / 1e12:.2f} TB/s); recurrent state {ctx.kv.nbytes() / GB:.4f} GB; MoE branches "
          f"{branches}; greedy {outs[40][:6]}...; launches {launches}", flush=True)
    return ctx, prompts


def recurrent_held(ctx, label, prompt, expect):
    """A teacher-forced 128-token chunk (one exact chunk) and a decode step
    after it, every kernel launch held to its plain version on the inputs
    it got."""
    import torch

    t0 = time.perf_counter()
    with held_to_plain(f"{label} held", expect) as seen:
        seq = ctx.new_sequence()
        last = ctx.prefill(seq, prompt[:128])[-1]
        out = ctx.decode({seq: int(last.argmax())})[seq]
        torch.cuda.synchronize()
        ctx.kv.seq_rm(seq)
    if not (torch.isfinite(last).all() and torch.isfinite(out).all()):
        raise AssertionError(f"{label} held steps: non-finite logits")
    print(f"  {label} held (a 128-token chunk + a decode step) in "
          f"{time.perf_counter() - t0:.1f} s, max rel by kernel: "
          + ", ".join(f"{k} {v[0]:.2e} <= {SMALL_TOL[k]:.0e} at (M, K, N) {sorted(v[1])}"
                      for k, v in sorted(seen.items())), flush=True)


def recurrent_shares(label, cfg, n_layers: int, step_ms: float, parts) -> None:
    """Each plain-torch part of a step timed alone (``device_ms_of``) at the
    step's shape, times its layers, as a share of the step's device ms;
    ``parts``: name -> (fn, layers it runs on)."""
    out = []
    for name, (fn, layers) in parts.items():
        ms = device_ms_of(fn, reps=3) * layers
        out.append(f"{name} {ms:.3f} ({ms / step_ms:.3f})")
    print(f"  {label}: of a {step_ms:.3f} device ms step, each part timed alone: "
          + ", ".join(out), flush=True)


def mamba_parts(cfg, b: int, t: int):
    """Mamba's plain-torch parts at B lanes x T tokens: the conv and the
    log-step scan, and at T > 1 a loop over T of ``ssm_step`` (the
    alternative to the log-step scan, not on the path)."""
    import torch

    from rrs_tpu_torch.ops import ssm

    gen = torch.Generator(device="cuda").manual_seed(3)
    di, ds = cfg.ssm_d_inner, cfg.ssm_d_state
    f32 = dict(generator=gen, device="cuda")
    x = torch.randn((b, t, di), **f32).to(torch.bfloat16)
    dt = torch.randn((b, t, di), **f32)
    a = -torch.exp(torch.randn((di, ds), **f32) * 0.5)
    bc, cc = torch.randn((b, t, ds), **f32), torch.randn((b, t, ds), **f32)
    h0 = torch.zeros((b, di, ds), device="cuda")
    conv_w, conv_b = torch.randn((4, di), **f32), torch.zeros((di,), device="cuda")
    st = torch.zeros((b, 3, di), dtype=torch.bfloat16, device="cuda")
    parts = {"ssm_conv": lambda: ssm.ssm_conv(x, st, conv_w, conv_b),
             "ssm_scan (log-step)": lambda: ssm.ssm_scan(h0, x, dt, a, bc, cc)}
    if t > 1:
        def loop():
            h = h0
            for i in range(t):
                _, h = ssm.ssm_step(h, x[:, i], dt[:, i], a, bc[:, i], cc[:, i])
        parts["ssm_step looped over T (not on the path)"] = loop
    return parts


def wkv_parts(cfg, b: int, t: int):
    import torch

    from rrs_tpu_torch.ops import rwkv

    gen = torch.Generator(device="cuda").manual_seed(4)
    hs = cfg.rwkv_head_size
    h = cfg.n_embd // hs
    k, v, r = (torch.randn((b, t, h, hs), generator=gen, device="cuda") for _ in range(3))
    td = torch.rand((b, t, h, hs), generator=gen, device="cuda")
    tf = torch.randn((h, hs), generator=gen, device="cuda")
    s0 = torch.zeros((b, h, hs, hs), device="cuda")
    return {"wkv6": lambda: rwkv.wkv6(k, v, r, tf, td, s0)}


def chunk_device_ms(ctx, prompt) -> float:
    """The device ms of one 128-token prefill chunk on a fresh sequence."""
    def step():
        seq = ctx.new_sequence()
        ctx.prefill(seq, prompt[:128])
        ctx.kv.seq_rm(seq)
    return device_ms_of(step, reps=2)


def serve_recurrent(cfg, weights, label, reports, expect_served):
    """The server in-process over a 4-lane recurrent context (``make_context``,
    ctx 4096): four concurrent completions (300 / 1,000 / 300 / 1,000
    tokens, two greedy, two sampled, RECUR_SERVE_NEW new tokens each), each
    prefilled one slot a step over all 4 lanes (M = 4 x 128: B5); then, on
    the same engine, a request extending slot 0's retained sequence by two
    tokens (its whole stored prefix reused) and one that parts from it
    after 10 tokens (restarted). Every response must finish by length with
    its count and no device decode run may be launched. Then one 4-lane
    prefill step held to the plain versions (B5). Returns the context."""
    import queue as _queue

    import torch
    from http.server import ThreadingHTTPServer

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.runtime.recurrent import make_context
    from rrs_tpu_torch.runtime.sampler import SamplerParams
    from rrs_tpu_torch.serving.engine import Engine, GenRequest
    from rrs_tpu_torch.serving.server import ServerState, make_handler

    ctx = make_context(cfg, weights, n_lanes=4, max_seq=4096)
    engine = Engine(ctx)
    state = ServerState(cfg, synthetic_vocab(cfg.vocab_size), engine, {}, f"{label}-fabricated")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    rng = torch.Generator().manual_seed(13)
    lengths = (300, 1000, 300, 1000)
    bodies = []
    for i, n in enumerate(lengths):
        body = {"prompt": torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist(),
                "max_tokens": RECUR_SERVE_NEW, "seed": i}
        if i < 2:
            body["temperature"] = 0.0
        bodies.append(body)
    results: dict = {}

    def run(i):
        t0 = time.perf_counter()
        results[i] = _http(port, "POST", "/v1/completions", bodies[i]) + (t0,
                                                                          time.perf_counter())

    def direct(prompt):
        q: "_queue.Queue" = _queue.Queue()
        got = []
        engine.submit(GenRequest(
            prompt_tokens=prompt, max_tokens=RECUR_SERVE_NEW,
            params=SamplerParams(temperature=0.0),
            on_token=lambda tok, piece, fin, reason: q.put(reason) if fin else got.append(tok)))
        reason = q.get(timeout=600)
        if reason != "length" or len(got) != RECUR_SERVE_NEW:
            raise AssertionError(f"{label} serving: a direct request finished by {reason} "
                                 f"with {len(got)} tokens")
        return got

    engine.start()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t_start = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"{label} serving: a request did not finish within 600 s")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = {k: kernels.LAUNCHES[n] for k, n in RECUR_COUNTERS.items()}
        for i, (status, data, t0, t1) in sorted(results.items()):
            if status != 200:
                raise AssertionError(f"{label} serving: request {i} answered {status}: "
                                     f"{data[:300]!r}")
            out = json.loads(data)
            reason = out["choices"][0]["finish_reason"]
            n_out = out["usage"]["completion_tokens"]
            if reason != "length" or n_out != RECUR_SERVE_NEW:
                raise AssertionError(f"{label} serving: request {i} finished by {reason} "
                                     f"with {n_out} tokens")
            tm = out["timings"]
            print(f"  {label} completion {lengths[i]} {'greedy' if i < 2 else 'sampled'}: "
                  f"{n_out} tokens, time to first token {tm['prompt_ms']:.1f} ms, decode "
                  f"{(n_out - 1) / max(tm['predicted_ms'] / 1e3, 1e-9):.2f} tok/s", flush=True)
        slot = engine.slots[0]
        stored = ctx.kv.lengths[ctx.kv.lane_of(slot.retained_seq)]
        direct(slot.cache_tokens[:stored] + [5, 6])
        reused = slot.n_reused
        direct(slot.cache_tokens[:10] + [7, 8, 9])
        if reused != stored or slot.n_reused != 0:
            raise AssertionError(f"{label} serving: prompt cache reused {reused} of {stored} "
                                 f"on a full prefix, {slot.n_reused} on a mismatch")
        if engine.n_decode_runs or engine.n_drafted:
            raise AssertionError(f"{label} serving: {engine.n_decode_runs} device decode runs")
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    if engine._thread.is_alive():
        raise AssertionError(f"{label} serving: the engine thread did not stop")
    if launches["i8p"] == 0:
        raise AssertionError(f"{label} serving: B5 never launched: {launches}")
    for key, n in launches.items():
        reports[key].entry[f"launches_serve_{label.split()[0].lower().replace('-', '_')}"] = n
    print(f"  {label} served 4 requests ({sum(lengths)} prompt tokens) in {wall:.1f} s, then "
          f"a full-prefix reuse ({stored} tokens kept) and a mismatch (restarted); "
          f"launches {launches}", flush=True)
    # one 4-lane prefill step held: B5 at M = 4 x 128
    t0 = time.perf_counter()
    with held_to_plain(f"{label} 4-lane prefill step", expect_served) as seen:
        seq = ctx.new_sequence()
        last = ctx.prefill(seq, bodies[1]["prompt"][:128])[-1]
        torch.cuda.synchronize()
        ctx.kv.seq_rm(seq)
    if not torch.isfinite(last).all():
        raise AssertionError(f"{label} 4-lane prefill step: non-finite logits")
    print(f"  {label} 4-lane prefill step held in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v[0]:.2e} at {sorted(v[1])}" for k, v in sorted(seen.items())),
          flush=True)
    return ctx


def phase_falcon_mamba(reports):
    """Falcon-Mamba-7B at its published widths, cut to 16 of its 64 layers
    (config from ``ModelConfig.from_gguf`` on its metadata; fabricated TCQ4
    linears with their i8p packs, a Q8_0 head): generate, a held chunk and decode step,
    a B = 1 decode profile with the conv's and the scan's shares (and the
    scan's share of a 128-token chunk, beside a loop over T), the server."""
    import torch

    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.models import mamba

    cfg = ModelConfig.from_gguf(FALCON_MAMBA_7B_GGUF)
    t0 = time.perf_counter()
    weights = mamba.fabricated_tcq4_weights(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(weights))
    kinds = {f: type(getattr(weights.layers[0], f)).__name__
             for f in ("w_in", "w_x", "w_dt", "w_out")}
    print(f"  Falcon-Mamba-7B config: {cfg.n_layers} layers, E={cfg.n_embd}, d_inner "
          f"{cfg.ssm_d_inner}, d_state {cfg.ssm_d_state}, d_conv {cfg.ssm_d_conv}, dt_rank "
          f"{cfg.ssm_dt_rank}, dt_b_c_rms {cfg.ssm_dt_b_c_rms}, vocab {cfg.vocab_size} (of 64 "
          f"layers); "
          f"fabricated weights {w_bytes / GB:.2f} GB in {time.perf_counter() - t0:.1f} s; "
          f"linears {kinds}", flush=True)
    path = {"tcq4_matmul_gx2", "tcq4_matmul", "q8_matmul"}
    ctx, prompts = recurrent_generate("Falcon-Mamba-7B", cfg, weights, "launches_falcon_mamba",
                                      reports, path)
    recurrent_held(ctx, "Falcon-Mamba-7B", prompts[300], path)
    prof = profile_decode(ctx, prompts[40], label="Falcon-Mamba-7B")
    if prof:
        recurrent_shares("Falcon-Mamba-7B decode, B=1", cfg, cfg.n_layers, prof["device_ms"],
                         {k: (fn, cfg.n_layers) for k, fn in mamba_parts(cfg, 1, 1).items()})
    recurrent_shares("Falcon-Mamba-7B 128-token chunk, B=1", cfg, cfg.n_layers,
                     chunk_device_ms(ctx, prompts[300]),
                     {k: (fn, cfg.n_layers) for k, fn in mamba_parts(cfg, 1, 128).items()})
    del ctx
    t0 = time.perf_counter()
    served = serve_recurrent(cfg, weights, "Falcon-Mamba-7B", reports,
                             {"tcq4_matmul_i8p", "q8_matmul"})
    print(f"  Falcon-Mamba-7B serving took {time.perf_counter() - t0:.1f} s", flush=True)
    del served, weights


def phase_rwkv6(reports):
    """RWKV-6 Finch 7B at its published widths, cut to 16 of its 32 layers:
    generate, a held chunk and decode step (B4 at M = 1 for K = 14,336), a
    decode profile with wkv6's share, and wkv6's share of a 128-token
    chunk."""
    import torch

    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.models import rwkv6

    cfg = ModelConfig.from_gguf(RWKV6_7B_GGUF)
    t0 = time.perf_counter()
    weights = rwkv6.fabricated_tcq4_weights(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(weights))
    print(f"  RWKV-6 7B config: {cfg.n_layers} of 32 layers, E={cfg.n_embd}, head size "
          f"{cfg.rwkv_head_size}, FF {cfg.n_ff}, extra {cfg.rwkv_tm_extra} / "
          f"{cfg.rwkv_decay_extra}, rescale every {cfg.rwkv_rescale_every}, vocab "
          f"{cfg.vocab_size}; fabricated weights {w_bytes / GB:.2f} GB in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    path = {"tcq4_matmul_gx2", "tcq4_matmul", "q8_matmul"}
    ctx, prompts = recurrent_generate("RWKV-6 7B", cfg, weights, "launches_rwkv6", reports, path)
    recurrent_held(ctx, "RWKV-6 7B", prompts[300], path)
    prof = profile_decode(ctx, prompts[40], label="RWKV-6 7B")
    if prof:
        recurrent_shares("RWKV-6 7B decode, B=1", cfg, cfg.n_layers, prof["device_ms"],
                         {k: (fn, cfg.n_layers) for k, fn in wkv_parts(cfg, 1, 1).items()})
    recurrent_shares("RWKV-6 7B 128-token chunk, B=1", cfg, cfg.n_layers,
                     chunk_device_ms(ctx, prompts[300]),
                     {k: (fn, cfg.n_layers) for k, fn in wkv_parts(cfg, 1, 128).items()})
    del ctx, weights


def phase_jamba(reports):
    """Jamba-v0.1 at its published widths, cut to 8 of its 32 layers (one
    period: attention at layer 4, MoE on the odd layers): generate, a held
    chunk and decode step (B3 without RoPE, B9 at decode, B10 or the scan at
    prefill, B1 / B4), a decode profile with the scan's and conv's
    shares."""
    import torch

    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.models import hybrid

    cfg = ModelConfig.from_gguf(JAMBA_V01_GGUF)
    t0 = time.perf_counter()
    weights = hybrid.fabricated_tcq4_weights(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(weights))
    kinds = [("attn" if hl.kind == "attn" else "ssm") + ("+moe" if hl.moe else "")
             for hl in weights.layers]
    print(f"  Jamba-v0.1 config: {cfg.n_layers} of 32 layers {kinds}, E={cfg.n_embd}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim} (no RoPE), FF {cfg.n_ff}, "
          f"{cfg.n_experts} experts top-{cfg.n_experts_used}, d_inner {cfg.ssm_d_inner}, "
          f"dt_rank {cfg.ssm_dt_rank}, vocab {cfg.vocab_size}; fabricated weights "
          f"{w_bytes / GB:.2f} GB in {time.perf_counter() - t0:.1f} s", flush=True)
    path = {"tcq4_matmul_gx2", "tcq4_matmul", "q8_matmul", "flash_attention",
            "tcq4_matmul_experts_rows"}
    ctx, prompts = recurrent_generate("Jamba-v0.1 (8 layers)", cfg, weights, "launches_jamba",
                                      reports, path)
    recurrent_held(ctx, "Jamba-v0.1", prompts[300], path)
    prof = profile_decode(ctx, prompts[40], label="Jamba-v0.1 (8 layers)")
    if prof:
        n_ssm = sum(hl.kind == "ssm" for hl in weights.layers)
        recurrent_shares("Jamba-v0.1 decode, B=1", cfg, n_ssm, prof["device_ms"],
                         {k: (fn, n_ssm) for k, fn in mamba_parts(cfg, 1, 1).items()})
    del ctx, weights


def phase_recurrent(reports):
    """Phase 16: the 2-layer card-vs-CPU checks, then Falcon-Mamba-7B,
    RWKV-6 7B and Jamba-v0.1 (8 layers), each model's tensors freed before
    the next."""
    import torch

    for name, run in (("2-layer checks", phase_recurrent_small),
                      ("Falcon-Mamba-7B", lambda: phase_falcon_mamba(reports)),
                      ("RWKV-6 7B", lambda: phase_rwkv6(reports)),
                      ("Jamba-v0.1", lambda: phase_jamba(reports))):
        t0 = time.perf_counter()
        run()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name} took {time.perf_counter() - t0:.1f} s", flush=True)


# -- the tool suite: convert-hf, LoRA, control vectors, quantize-stats, fit-params -------

TOOLS_SEED = 20
LORA_RANK, LORA_ALPHA = 16, 32.0
LORA_TARGETS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")
CV_POSITIVE = ("the weather is lovely and the sun is warm today",
               "what a wonderful kind and happy morning this is",
               "we laughed and sang together in the bright garden",
               "thank you so much, this gift is perfect")
CV_NEGATIVE = ("the weather is awful and the rain is cold today",
               "what a dreadful cruel and miserable morning this is",
               "we argued and shouted at each other in the dark street",
               "no thanks, this gift is useless")
TOOLS_PROMPT = "the tool suite runs the port on the card: convert, adapt, steer, and count"


def write_hf_qwen3(d, cfg, seed: int) -> int:
    """An HF-format Qwen3 directory at ``cfg``'s widths: ``config.json``, one
    ``model.safetensors`` of BF16 N(0, 0.05) weights drawn on the card from
    ``seed`` (norms one) written by the port's writer, and a BPE
    ``tokenizer.json`` of ``synthetic_vocab``'s tokens. Returns its bytes."""
    import torch

    from rrs_tpu_torch.tools.safetensors_io import save_safetensors

    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
        "hidden_size": cfg.n_embd, "intermediate_size": cfg.n_ff,
        "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "vocab_size": cfg.vocab_size, "max_position_embeddings": cfg.context_length,
        "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_embeddings, "torch_dtype": "bfloat16"}))
    toks = synthetic_vocab(cfg.vocab_size).tokens
    (d / "tokenizer.json").write_text(json.dumps({
        "model": {"type": "BPE", "vocab": {t: i for i, t in enumerate(toks)}, "merges": []},
        "added_tokens": []}))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.05).to(torch.bfloat16).cpu()

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16)

    e, f = cfg.n_embd, cfg.n_ff
    sd = {"model.embed_tokens.weight": rnd(cfg.vocab_size, e), "model.norm.weight": ones(e)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": ones(e),
                   p + "post_attention_layernorm.weight": ones(e),
                   p + "self_attn.q_proj.weight": rnd(cfg.n_q_dim, e),
                   p + "self_attn.k_proj.weight": rnd(cfg.n_kv_dim, e),
                   p + "self_attn.v_proj.weight": rnd(cfg.n_kv_dim, e),
                   p + "self_attn.o_proj.weight": rnd(e, cfg.n_q_dim),
                   p + "self_attn.q_norm.weight": ones(cfg.head_dim),
                   p + "self_attn.k_norm.weight": ones(cfg.head_dim),
                   p + "mlp.gate_proj.weight": rnd(f, e), p + "mlp.up_proj.weight": rnd(f, e),
                   p + "mlp.down_proj.weight": rnd(e, f)})
    save_safetensors(d / "model.safetensors", sd, metadata={"format": "pt"})
    return sum(p.stat().st_size for p in d.iterdir())


def write_lora(path, cfg, seed: int):
    """A rank-LORA_RANK adapter (alpha LORA_ALPHA) on LORA_TARGETS of every
    layer, N(0, 0.02) factors, written by the port's GGUF writer."""
    import numpy as np

    from rrs_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    shapes = {"attn_q": (cfg.n_q_dim, cfg.n_embd), "attn_k": (cfg.n_kv_dim, cfg.n_embd),
              "attn_v": (cfg.n_kv_dim, cfg.n_embd), "attn_output": (cfg.n_embd, cfg.n_q_dim),
              "ffn_gate": (cfg.n_ff, cfg.n_embd), "ffn_up": (cfg.n_ff, cfg.n_embd),
              "ffn_down": (cfg.n_embd, cfg.n_ff)}
    w = GGUFWriter(path)
    w.add_string("general.architecture", cfg.arch)
    w.add_string("general.type", "adapter")
    w.add_string("adapter.type", "lora")
    w.add_float32("adapter.lora.alpha", LORA_ALPHA)
    for li in range(cfg.n_layers):
        for t in LORA_TARGETS:
            n, k = shapes[t]
            w.add_tensor(f"blk.{li}.{t}.weight.lora_a",
                         (rng.standard_normal((LORA_RANK, k)) * 0.02).astype(np.float32))
            w.add_tensor(f"blk.{li}.{t}.weight.lora_b",
                         (rng.standard_normal((n, LORA_RANK)) * 0.02).astype(np.float32))
    return w.write()


def _prefill_logits(cfg, weights, tokens, device, max_seq: int = 1024):
    """One prefill of ``tokens`` in a fresh one-lane context; logits [T, V]
    f32 on the host."""
    import torch

    from rrs_tpu_torch.runtime.context import InferenceContext

    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=max_seq, device=device)
    out = ctx.prefill(ctx.new_sequence(), tokens).float().cpu()
    if device == "cuda":
        torch.cuda.synchronize()
    return out


def _rel_t(got, ref) -> float:
    return ((got - ref).norm() / ref.norm()).item()


def _decode_ms(ctx, seq, steps: int = 8) -> float:
    """Host-clock ms of one decode step (teacher-forced token 11), over
    ``steps`` steps after one warm step, each ending in a synchronize."""
    import torch

    ctx.decode({seq: 11})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        ctx.decode({seq: 11})
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def tools_lora_f16(cfg, f16, lora, merged_run, tokens):
    """LoRA on the F16 file: the adapter attached to unfused weights on the
    card against the ``export-lora`` merged file loaded plainly, and against
    the same attachment on the CPU port (GLUE_TOL each); the adapter must
    move the logits."""
    import torch

    from rrs_tpu_torch.models.adapter import attach_lora, load_lora_gguf
    from rrs_tpu_torch.models.loader import load_model

    t0 = time.perf_counter()
    _, w_cpu, _ = load_model(f16, device="cpu", fuse=False)
    attach_lora(w_cpu, load_lora_gguf(lora, device="cpu")[0])
    ref_cpu = _prefill_logits(cfg, w_cpu, tokens, "cpu")
    del w_cpu
    _, w_card, _ = load_model(f16, device="cuda", fuse=False)
    base = _prefill_logits(cfg, w_card, tokens, "cuda")
    attach_lora(w_card, load_lora_gguf(lora, device="cuda")[0])
    got = _prefill_logits(cfg, w_card, tokens, "cuda")
    del w_card
    _verb_wait(merged_run[0])
    _, w_merged, _ = load_model(merged_run[1], device="cuda")
    merged = _prefill_logits(cfg, w_merged, tokens, "cuda")
    del w_merged
    torch.cuda.empty_cache()
    rows = {"card LoRA vs merged file": _rel_t(got, merged),
            "card LoRA vs CPU LoRA": _rel_t(got, ref_cpu)}
    moved = _rel_t(got, base)
    for label, rel in rows.items():
        if not (torch.isfinite(got).all() and rel <= GLUE_TOL):
            raise AssertionError(f"tools, F16 LoRA: {label} rel L2 {rel:.4f} > {GLUE_TOL}")
    if moved < 1e-2:
        raise AssertionError(f"tools, F16 LoRA: the adapter moved the logits by {moved:.2e}")
    print(f"  F16 base, rank-{LORA_RANK} adapter on {len(LORA_TARGETS)} linears x "
          f"{cfg.n_layers} layers, {len(tokens)}-token prompt: "
          + ", ".join(f"{k} rel L2 {v:.4f} <= {GLUE_TOL}" for k, v in rows.items())
          + f"; with vs without the adapter rel L2 {moved:.4f} "
          f"({time.perf_counter() - t0:.1f} s with the loads)", flush=True)


def tools_lora_tcq4(cfg, tcq4, lora, tokens, reports):
    """LoRA on the TCQ4 file (unfused, i8p packs kept): a teacher-forced
    512-token prefill (B5 + delta), a 40-token prefill (B4 + delta) and a
    decode step (B1 + delta), every launch held to its plain version; the
    counts since the reset go under ``launches_tools``. The logits must
    move with the adapter; a decode step's host-clock time with and without
    it is reported."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models.adapter import attach_lora, load_lora_gguf
    from rrs_tpu_torch.models.linear import TCQ4Linear
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.runtime.context import InferenceContext

    t0 = time.perf_counter()
    _, w, _ = load_model(tcq4, device="cuda", fuse=False)
    lw = w.layers[0]
    if not (isinstance(lw.wq, TCQ4Linear) and lw.wq.i8p is not None and lw.wqkv is None):
        raise AssertionError("tools: the unfused TCQ4 load lost its i8p packs or fused")
    short = tokens[:40]
    long = (tokens * (512 // len(tokens) + 1))[:512]
    base = _prefill_logits(cfg, w, short, "cuda")
    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=128)
    seq = ctx.new_sequence()
    ctx.prefill(seq, short)
    base_ms = _decode_ms(ctx, seq)
    del ctx
    attach_lora(w, load_lora_gguf(lora, device="cuda")[0])
    torch.cuda.synchronize()
    kernels.reset_launches()
    with held_to_plain("tools, TCQ4 + LoRA", {"tcq4_matmul_i8p", "tcq4_matmul",
                                               "tcq4_matmul_gx2", "flash_attention"}) as seen:
        _prefill_logits(cfg, w, long, "cuda")
        ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=128)
        seq = ctx.new_sequence()
        got = ctx.prefill(seq, short).float().cpu()
        step = ctx.decode({seq: 11})[seq].float().cpu()
        torch.cuda.synchronize()
    launches = mark_launches(reports, "launches_tools")
    lora_ms = _decode_ms(ctx, seq)
    moved = _rel_t(got, base)
    if not (torch.isfinite(got).all() and torch.isfinite(step).all()) or moved < 1e-2:
        raise AssertionError(f"tools, TCQ4 + LoRA: the adapter moved the logits by {moved:.2e}")
    print(f"  TCQ4 base + adapter (unfused, i8p packs): 512- and {len(short)}-token prefills and "
          f"a decode step, each launch vs its plain version (max rel): "
          + ", ".join(f"{k} {v[0]:.2e} <= {SMALL_TOL[k]:.0e} at {sorted(v[1])}"
                      for k, v in seen.items())
          + f"; launches_tools {launches}; with vs without the adapter rel L2 {moved:.4f}; "
          f"decode step {lora_ms:.2f} ms with the adapter, {base_ms:.2f} ms without "
          f"(host clock, {cfg.n_layers} layers; {time.perf_counter() - t0:.1f} s)", flush=True)
    del ctx, w
    torch.cuda.empty_cache()


def tools_cvector(cfg, f16, vocab, tokens, tmp):
    """Control vectors on the F16 file: the mean-difference directions of
    CV_POSITIVE against CV_NEGATIVE on the card and on the CPU port (rel L2
    per layer <= GLUE_TOL), the GGUF written and read back equal, a forward
    with the vector on the card against the CPU (GLUE_TOL), and the vector
    must move the logits."""
    import numpy as np
    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.tools.cvector import (build_control_vector, load_control_vector,
                                             save_control_vector)

    t0 = time.perf_counter()
    pos = [vocab.encode(s, add_special=True) for s in CV_POSITIVE]
    neg = [vocab.encode(s, add_special=True) for s in CV_NEGATIVE]
    out = {}
    for dev in ("cuda", "cpu"):
        _, w, _ = load_model(f16, device=dev)
        dirs = build_control_vector(cfg, w, pos, neg)
        if dev == "cuda":
            path = save_control_vector(tmp / "cv_card.gguf", dirs, model_hint="tools")
            cv = load_control_vector(path, cfg.n_layers, cfg.n_embd, device="cpu")
            if not np.array_equal(cv.vectors.numpy(), dirs):
                raise AssertionError("tools: the control vector read back differs")
        cv = load_control_vector(tmp / "cv_card.gguf", cfg.n_layers, cfg.n_embd, device=dev)
        t = len(tokens)
        pos_ids = np.arange(t, dtype=np.int32)[None]
        logits = []
        for vec in (None, cv):
            kc, vc = llama.scratch_caches(cfg, 1, t, device=dev)
            with torch.inference_mode():
                logits.append(llama.forward(cfg, w, np.asarray([tokens], np.int32), pos_ids, kc,
                                            vc, pos_ids, pos_ids, control_vector=vec
                                            ).float().cpu())
        out[dev] = (dirs, logits)
        del w
    torch.cuda.empty_cache()
    (d_card, (plain, steered)), (d_cpu, (_, steered_cpu)) = out["cuda"], out["cpu"]
    rels = [float(np.linalg.norm(d_card[li] - d_cpu[li]) / np.linalg.norm(d_cpu[li]))
            for li in range(cfg.n_layers)]
    fwd = _rel_t(steered, steered_cpu)
    moved = _rel_t(steered, plain)
    if max(rels) > GLUE_TOL or fwd > GLUE_TOL or moved < 1e-2:
        raise AssertionError(f"tools, cvector: directions card vs CPU {rels}, forward {fwd:.4f} "
                             f"(<= {GLUE_TOL}), moved {moved:.2e}")
    print(f"  cvector on the F16 file ({len(pos)} + {len(neg)} prompts): directions card vs CPU "
          f"rel L2 per layer {[f'{r:.2e}' for r in rels]} <= {GLUE_TOL}, norms "
          f"{[f'{float(np.linalg.norm(d)):.3f}' for d in d_card]}; the GGUF read back equal; "
          f"steered forward card vs CPU rel L2 {fwd:.4f} <= {GLUE_TOL}; the vector moves the "
          f"logits by rel L2 {moved:.4f} ({time.perf_counter() - t0:.1f} s)", flush=True)


def stats_subset(src, dst, n: int = 4):
    """A GGUF of the ``n`` smallest 2-D blk.* tensors of ``src`` (at
    Qwen3-4B's widths the k / v projections of both layers), in file order,
    payloads copied raw. quantize-stats reads a file's 2-D tensors in order;
    Q4_K's host encoder takes ~1 us a weight there, so the embedding's 389 M
    weights would take minutes and the 10.5 M of a q / o projection ~15 s."""
    from rrs_tpu_torch.gguf.reader import read_gguf
    from rrs_tpu_torch.gguf.writer import GGUFWriter

    with read_gguf(src) as g:
        w = GGUFWriter(dst)
        w.add_string("general.architecture", str(g.metadata["general.architecture"]))
        cands = [k for k, info in g.tensors.items()
                 if k.startswith("blk.") and len(info.shape) == 2 and info.shape[-1] % 256 == 0]
        small = sorted(cands, key=lambda k: (math.prod(g.tensors[k].shape), cands.index(k)))[:n]
        names = [k for k in cands if k in small]
        for k in names:
            info = g.tensors[k]
            w.add_tensor(k, g.tensor_bytes(k), shape=tuple(info.shape), ggml_type=info.ggml_type)
        w.write()
    return names


def phase_tools(reports, tmp):
    """Phase 17 (see the module docstring): the tool suite at Qwen3-4B's
    published widths cut to 2 of 36 layers, each verb a process of its own,
    the checks on the card in this process while they run."""
    import dataclasses

    import torch

    from rrs_tpu_torch.gguf.reader import read_gguf
    from rrs_tpu_torch.models.config import PRESETS, ModelConfig
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab

    cfg = dataclasses.replace(PRESETS["qwen3-4b"], n_layers=2)
    t0 = time.perf_counter()
    hf = tmp / "Qwen3-4B-2layer"
    nbytes = write_hf_qwen3(hf, cfg, TOOLS_SEED)
    print(f"  HF directory (config.json, BF16 model.safetensors, tokenizer.json) "
          f"{nbytes / GB:.3f} GB written in {time.perf_counter() - t0:.1f} s", flush=True)
    f16, tcq4, lora = tmp / "f16.gguf", tmp / "tcq4.gguf", tmp / "lora.gguf"
    t0 = time.perf_counter()
    out = _verb(["convert-hf", hf, f16, "--outtype", "f16"])
    if out.strip() != f"wrote {f16}":
        raise AssertionError(f"convert-hf: {out[-500:]}")
    print(f"    F16 GGUF {f16.stat().st_size / GB:.3f} GB ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    write_lora(lora, cfg, TOOLS_SEED + 1)
    quant = _verb_start(["quantize", f16, tcq4])
    merged_run = (_verb_start(["export-lora", "-m", f16, "--lora", lora, "-o",
                               tmp / "merged.gguf"]), tmp / "merged.gguf")
    tok_f16 = _verb_start(["tokenize", "-m", f16, "-p", TOOLS_PROMPT, "--ids-only"])
    with read_gguf(f16) as g:
        vocab = Vocab.from_gguf(g.metadata)
        cfg_f = ModelConfig.from_gguf(g.metadata)
        q_shape = g.tensors["blk.0.attn_q.weight"].shape
        tied = "output.weight" not in g.tensors
    if (cfg_f.n_embd, cfg_f.n_ff, cfg_f.vocab_size, cfg_f.n_layers, cfg_f.qk_norm, tied,
            tuple(q_shape)) != (cfg.n_embd, cfg.n_ff, cfg.vocab_size, 2, True, True,
                                (cfg.n_q_dim, cfg.n_embd)):
        raise AssertionError(f"convert-hf: the file's config {cfg_f}, attn_q {q_shape}")
    tokens = vocab.encode(TOOLS_PROMPT)
    tools_lora_f16(cfg_f, f16, lora, merged_run, tokens[:40])
    print(f"    merged F16 file {merged_run[1].stat().st_size / GB:.3f} GB", flush=True)
    tools_cvector(cfg_f, f16, vocab, tokens[:40], tmp)
    out = _verb_wait(quant, timeout=900)
    stats = [line for line in out.splitlines() if line.startswith("quantized:")]
    print(f"    TCQ4 GGUF {tcq4.stat().st_size / GB:.3f} GB; {stats[0] if stats else out[-300:]}",
          flush=True)
    names = stats_subset(tcq4, tmp / "stats.gguf")
    (tmp / "pos.txt").write_text("\n".join(CV_POSITIVE) + "\n", encoding="utf-8")
    (tmp / "neg.txt").write_text("\n".join(CV_NEGATIVE) + "\n", encoding="utf-8")
    runs = {"tok_tcq4": _verb_start(["tokenize", "-m", tcq4, "-p", TOOLS_PROMPT, "--ids-only"]),
            "cvector": _verb_start(["cvector", "-m", tcq4, "--positive-file", tmp / "pos.txt",
                                    "--negative-file", tmp / "neg.txt", "-o", tmp / "cv.gguf"]),
            "qs_card": _verb_start(["quantize-stats", "-m", tmp / "stats.gguf", "--max-tensors",
                                    "4", "--json"]),
            "qs_cpu": _verb_start(["quantize-stats", "-m", tmp / "stats.gguf", "--max-tensors",
                                   "4", "--json", "--device", "cpu"]),
            "fit": _verb_start(["fit-params", "-m", tcq4, "--hbm-gib", "80"])}
    tools_lora_tcq4(cfg_f, tcq4, lora, tokens, reports)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _, w_plain, _ = load_model(tcq4, device="cuda")
    torch.cuda.synchronize()
    loaded = torch.cuda.memory_allocated() - before
    del w_plain
    torch.cuda.empty_cache()
    for label, handle in (("F16", tok_f16), ("TCQ4", runs["tok_tcq4"])):
        ids = [int(t) for t in _verb_wait(handle).split()]
        if ids != tokens:
            raise AssertionError(f"tokenize -m {label}: {ids[:8]}... vs the port's "
                                 f"{tokens[:8]}...")
    print(f"    tokenize: both files give the CPU port's {len(tokens)} ids", flush=True)
    out = _verb_wait(runs["cvector"])
    with read_gguf(tmp / "cv.gguf") as g:
        dirs = sorted(k for k in g.tensors if k.startswith("direction."))
    if "wrote control vector (2 layers)" not in out or dirs != ["direction.1", "direction.2"]:
        raise AssertionError(f"cvector verb: {out[-300:]} {dirs}")
    rows = {}
    for dev in ("qs_card", "qs_cpu"):
        rows[dev] = [json.loads(line) for line in _verb_wait(runs[dev]).splitlines()
                     if line.startswith("{")]
    if [r["tensor"] for r in rows["qs_card"]] != names or \
            [r["tensor"] for r in rows["qs_cpu"]] != names:
        raise AssertionError(f"quantize-stats tensors: {rows}")
    tol = SMALL_TOL["tcq4_matmul"]
    for card, cpu in zip(rows["qs_card"], rows["qs_cpu"]):
        for key in card:
            if key in ("tensor", "shape"):
                continue
            a, b = card[key], cpu[key]
            lim = tol * abs(b) if key.endswith("rmse_dot_b4") else 0.0
            if not abs(a - b) <= lim:
                raise AssertionError(f"quantize-stats {card['tensor']} {key}: card {a} vs CPU {b}")
        print(f"    quantize-stats {card['tensor']} {card['shape']}: rel RMSE(y) tcq4 "
              f"{card['tcq4_rmse_dot']}, tcq4_reorder {card['tcq4_reorder_rmse_dot']} (the "
              f"integer oracle, the same in both processes); through B4 card / CPU plain tcq4 "
              f"{card['tcq4_rmse_dot_b4']} / {cpu['tcq4_rmse_dot_b4']}, tcq4_reorder "
              f"{card['tcq4_reorder_rmse_dot_b4']} / {cpu['tcq4_reorder_rmse_dot_b4']} (<= "
              f"{tol:.0e} relative); q4_k {card['q4_k_rmse_dot']}, q8_0 "
              f"{card['q8_0_rmse_dot']}; rel RMSE(w) tcq4 {card['tcq4_rmse_w']}", flush=True)
    out = _verb_wait(runs["fit"]).strip()
    model_gb = float(out.split("model=")[1].split("GB")[0])
    print(f"    fit-params: {out}; the same file loaded on the card allocates "
          f"{loaded / GB:.3f} GB (fit-params' model estimate {model_gb:.2f} GB; reported)",
          flush=True)


# -- Qwen2-VL-2B: vision, the qwen2vl text stack with M-RoPE and its ViT ----------

# The GGUF metadata of Qwen2-VL-2B-Instruct's text model as its published
# config.json gives it (Hugging Face Qwen/Qwen2-VL-2B-Instruct; the converter
# pads mrope_section [16, 24, 24] with an empty fourth channel)
QWEN2VL_2B_GGUF = {
    "general.architecture": "qwen2vl", "qwen2vl.block_count": 28,
    "qwen2vl.context_length": 32768, "qwen2vl.embedding_length": 1536,
    "qwen2vl.feed_forward_length": 8960, "qwen2vl.attention.head_count": 12,
    "qwen2vl.attention.head_count_kv": 2, "qwen2vl.attention.layer_norm_rms_epsilon": 1e-6,
    "qwen2vl.rope.freq_base": 1e6, "qwen2vl.rope.dimension_sections": [16, 24, 24, 0],
    "qwen2vl.tie_word_embeddings": True, "qwen2vl.vocab_size": 151936}
# its vision_config (embed_dim 1,280, depth 32, 16 heads, mlp_ratio 4 with
# quick-GELU, patch 14, spatial merge 2, temporal patch 2, merger to 1,536) as
# HF writes it, and as convert-hf --mmproj turns it into clip.cpp's keys
QWEN2VL_2B_VISION = dict(depth=32, embed_dim=1280, hidden_size=1536, hidden_act="quick_gelu",
                         mlp_ratio=4, num_heads=16, in_channels=3, patch_size=14,
                         spatial_merge_size=2, temporal_patch_size=2)
QWEN2VL_2B_MMPROJ = {
    "clip.projector_type": "qwen2vl_merger", "clip.vision.patch_size": 14,
    "clip.vision.image_size": 28, "clip.vision.embedding_length": 1280,
    "clip.vision.block_count": 32, "clip.vision.attention.head_count": 16,
    "clip.vision.feed_forward_length": 5120, "clip.vision.projection_dim": 1536,
    "clip.vision.spatial_merge_size": 2,
    "clip.vision.attention.layer_norm_epsilon": 9.999999974752427e-07}     # 1e-6 as f32
VISION_NEW = 32
# the f32 tower, card against the CPU port (rel L2; no TF32, which the port
# turns off in set_matmul_precision)
VISION_TOL = 1e-3
# the two images, (h, w) as written; each resizes to multiples of 28: 448 x 448
# (a 32 x 32 patch grid, 256 merged tokens) and 448 x 672 (384, h != w)
VISION_IMAGES = {"448x448": (440, 440), "448x672": (450, 660)}


def vision_png(h: int, w: int, seed: int) -> bytes:
    """A gradient with noise, h x w RGB, as PNG from the port's writer."""
    import numpy as np

    from rrs_tpu_torch.mtmd.image_io import encode_png

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 127 // (h + w)], axis=-1)
    return encode_png(np.clip(base + rng.integers(-24, 25, (h, w, 3)), 0, 255).astype(np.uint8))


def vision_model():
    """Qwen2-VL-2B at full width: the config from ``ModelConfig.from_gguf`` on
    its metadata, fabricated TCQ4 linears with their i8p packs (qkv biases
    N(0, 0.02)) and a Q8_0 head over the 151,936-entry vocabulary, all 28
    layers; the whole 32-layer tower from ``random_clip_weights`` at the
    published vision config, f32, on the card."""
    import dataclasses

    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.mtmd.clip import ClipConfig, random_clip_weights

    cfg = ModelConfig.from_gguf(QWEN2VL_2B_GGUF)
    t0 = time.perf_counter()
    w = llama.fabricated_tcq4_weights(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    n_qkv = cfg.n_q_dim + 2 * cfg.n_kv_dim
    w = dataclasses.replace(w, layers=[dataclasses.replace(lw, wqkv=dataclasses.replace(
        lw.wqkv, bias=(torch.randn(n_qkv, generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16))) for lw in w.layers])
    torch.cuda.synchronize()
    t_text = time.perf_counter() - t0
    ccfg = ClipConfig.from_gguf(QWEN2VL_2B_MMPROJ)
    t0 = time.perf_counter()
    cw = random_clip_weights(ccfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(w))
    print(f"  Qwen2-VL-2B config: {cfg.n_layers} layers, E={cfg.n_embd}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim}, FF {cfg.n_ff}, vocab {cfg.vocab_size}, "
          f"M-RoPE sections {cfg.rope_sections}, qkv bias {cfg.attn_bias}; fabricated text "
          f"weights {w_bytes / GB:.3f} GB in {t_text:.1f} s; tower ({ccfg.n_layers} layers, "
          f"E={ccfg.n_embd}, {ccfg.n_heads} heads, FF {ccfg.n_ff} {ccfg.ffn_act}, merger to "
          f"{ccfg.n_embd_llm}) {cw.nbytes() / GB:.3f} GB f32 from random_clip_weights in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, w, ccfg, cw


def tower_flops(ccfg, n: int) -> float:
    """The tower's operations for n patches: the stem, each layer's four
    projections, FFN and attention (QK^T and AV), and the merger."""
    e, f, m2 = ccfg.n_embd, ccfg.n_ff, ccfg.spatial_merge ** 2
    per_layer = 2 * n * (4 * e * e + 2 * e * f) + 4 * n * n * e
    merger = 2 * (n // m2) * (m2 * e) * (m2 * e + ccfg.n_embd_llm)
    return 2 * n * 3 * ccfg.patch_size ** 2 * e + ccfg.n_layers * per_layer + merger


def vision_encode(ccfg, cw, arrays, peaks) -> dict:
    """Each decoded image through the port's preprocessing (bicubic resize,
    normalization, patches: host ms) and the tower on the card (CUDA events,
    after a warm-up encode), beside its bound at the f32 peak."""
    import torch

    from rrs_tpu_torch.mtmd.clip import encode_image_qwen2vl, preprocess_image_qwen2vl

    out = {}
    for name, arr in arrays.items():
        t0 = time.perf_counter()
        patches, grid = preprocess_image_qwen2vl(arr, ccfg)
        host_ms = (time.perf_counter() - t0) * 1e3
        emb = encode_image_qwen2vl(ccfg, cw, patches, grid)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        emb = encode_image_qwen2vl(ccfg, cw, patches, grid)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        flops = tower_flops(ccfg, patches.shape[0])
        m = ccfg.spatial_merge
        if tuple(emb.shape) != (patches.shape[0] // m ** 2, ccfg.n_embd_llm) or \
                not torch.isfinite(emb).all():
            raise AssertionError(f"Qwen2-VL-2B tower {name}: {tuple(emb.shape)}")
        out[name] = ms
        print(f"  image {name}: {arr.shape[1]} x {arr.shape[0]} PNG -> patch grid {grid} -> "
              f"{emb.shape[0]} tokens; host preprocessing {host_ms:.1f} ms; tower on the card "
              f"{ms:.2f} ms for {flops / 1e12:.3f} TFLOP f32 (bound {flops / peaks[3] * 1e3:.2f} "
              f"ms at {peaks[3] / 1e12:.0f} TFLOP/s, {flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
    return out


def vision_generate(cfg, w, ccfg, cw, pngs, reports):
    """``generate_with_images`` over each PNG, decoded by the port (a 1-lane
    context, ctx 2,048), VISION_NEW greedy tokens each, the launch counts set
    to 0 before and read after both (``launches_qwen2vl``): B1-B5 must all
    have run, B5 on the image chunks' o / down projections. Returns the
    context."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.mtmd.image_io import decode_image
    from rrs_tpu_torch.mtmd.pipeline import IMAGE_MARKER, generate_with_images
    from rrs_tpu_torch.runtime.context import InferenceContext

    vocab = synthetic_vocab(cfg.vocab_size)
    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=2048)
    ctx.generate([5, 6, 7], 2)                                       # warm-up
    prompt = f"describe {IMAGE_MARKER} in a few words"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = {name: generate_with_images(ctx, vocab, prompt, [decode_image(png)], ccfg, cw,
                                       max_new_tokens=VISION_NEW) for name, png in pngs.items()}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = mark_launches(reports, "launches_qwen2vl")
    for name, out in outs.items():
        if len(out) != VISION_NEW or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"Qwen2-VL-2B generate_with_images {name}: {out}")
    if BF16_PATH - set(launches):
        raise AssertionError(f"Qwen2-VL-2B generate_with_images: launches {launches}")
    perf = ctx.perf()
    print(f"  generate_with_images, both images x {VISION_NEW} new tokens in {dt:.1f} s (the "
          f"towers on the card included); prefill {perf['n_p_eval']} rows @ "
          f"{perf['pp_tok_per_s']:.1f} rows/s, decode {perf['n_eval']} tok @ "
          f"{perf['tg_tok_per_s']:.2f} tok/s; greedy {outs['448x672'][:6]}...; launches "
          f"{launches}", flush=True)
    return ctx


def vision_held(ctx, chunks) -> None:
    """A teacher-forced [text, image, text] prefill (40 tokens, the 448 x 672
    image's 384 rows with its M-RoPE grid, 30 tokens) and a decode step after
    it, every B1 / B2 / B3 / B4 / B5 launch held to its plain version; the
    lane's text delta equals base + max(gh, gw) - slots."""
    import torch

    cfg = ctx.cfg
    emb, grid = chunks["448x672"]
    rng = torch.Generator().manual_seed(18)
    pre, post = (torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist() for n in (40, 30))
    t0 = time.perf_counter()
    with held_to_plain("Qwen2-VL-2B", BF16_PATH) as seen:
        seq = ctx.new_sequence()
        ctx.prefill(seq, pre)
        ctx.prefill_embeds(seq, emb, mrope_grid=grid)
        delta = ctx.kv.mrope_delta[0]
        last = ctx.prefill(seq, post)[-1]
        out = ctx.decode({seq: int(last.argmax())})[seq]
        ctx.kv.seq_rm(seq)
        torch.cuda.synchronize()
    if delta != 40 + max(grid) - (40 + grid[0] * grid[1]) or \
            not (torch.isfinite(last).all() and torch.isfinite(out).all()):
        raise AssertionError(f"Qwen2-VL-2B held steps: delta {delta}, grid {grid}")
    print(f"  Qwen2-VL-2B held ([40 tokens, a {grid[0]} x {grid[1]} image chunk, 30 tokens] + a "
          f"decode step; M-RoPE delta {delta}), max rel by kernel: "
          + ", ".join(f"{k} {v[0]:.2e} <= {SMALL_TOL[k]:.0e} {sorted(v[1])}"
                      for k, v in sorted(seen.items()))
          + f" in {time.perf_counter() - t0:.1f} s", flush=True)


def serve_chats(cfg, w, label: str, towers: dict, media_jobs: list, n_new: int):
    """The server in-process with ``towers`` set on its state (``clip_cfg`` /
    ``clip_weights``, ``audio_cfg`` / ``audio_weights``), 4 slots, ctx 4096:
    the ``media_jobs`` (name, content parts) and two text-only chats (one
    greedy, one sampled) at once, ``n_new`` tokens each, the media ones
    greedy; every request must finish by length with that many tokens.
    Prints each one's time to first token (the client's: the media decoded
    and encoded in the handler, the prompt prefilled) and the served decode
    tok/s. Returns the context."""
    from http.server import ThreadingHTTPServer

    import torch

    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.serving.engine import Engine
    from rrs_tpu_torch.serving.server import ServerState, make_handler

    ctx = InferenceContext(cfg, w, n_lanes=4, max_seq=4096)
    engine = Engine(ctx)
    state = ServerState(cfg, synthetic_vocab(cfg.vocab_size), engine, {}, f"{label}-fabricated")
    for key, value in towers.items():
        setattr(state, key, value)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    jobs = [(name, {"messages": [{"role": "user", "content": parts}], "temperature": 0})
            for name, parts in media_jobs]
    text = "tell me about the weather on the coast in the spring " * 6
    jobs.append(("text greedy", {"messages": [{"role": "user", "content": text}],
                                 "temperature": 0}))
    jobs.append(("text sampled", {"messages": [{"role": "user", "content": text[::-1]}],
                                  "seed": 3}))
    results: dict = {}

    def run(job):
        name, body = job
        t0 = time.perf_counter()
        status, data = _http(port, "POST", "/v1/chat/completions", {**body, "max_tokens": n_new})
        results[name] = (status, data, t0, time.perf_counter())

    runs0 = engine.n_decode_runs
    engine.start()
    server_thread.start()
    try:
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"{label} serving: a request did not finish within 600 s")
        wall = time.perf_counter() - t_start
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    spans, n_decode = [], 0
    for name, (status, data, t0, t1) in results.items():
        if status != 200:
            raise AssertionError(f"{label} serving: {name} answered {status}: {data[:300]!r}")
        out = json.loads(data)
        reason = out["choices"][0]["finish_reason"]
        n_out = out["usage"]["completion_tokens"]
        if reason != "length" or n_out != n_new:
            raise AssertionError(f"{label} serving: {name} finished by {reason} with "
                                 f"{n_out} tokens")
        decode_s = out["timings"]["predicted_ms"] / 1e3
        spans.append((t1 - decode_s, t1))
        n_decode += n_out - 1
        print(f"  {name}: {n_out} tokens ({reason}), prompt {out['usage']['prompt_tokens']} "
              f"tokens, time to first token {(t1 - t0 - decode_s) * 1e3:.1f} ms (client), "
              f"decode {(n_out - 1) / max(decode_s, 1e-9):.2f} tok/s", flush=True)
    busy = _union_seconds(spans)
    print(f"  {label} served {len(results)} chat requests ({len(media_jobs)} with media) in "
          f"{wall:.1f} s; decode tok/s summed over the slots {n_decode / busy:.2f} ({n_decode} "
          f"tokens over {busy:.1f} s); {engine.n_decode_runs - runs0} device decode runs; KV "
          f"resident {ctx.kv.nbytes() / GB:.3f} GB", flush=True)
    return ctx


def vision_serve(cfg, w, ccfg, cw, pngs):
    """``serve_chats`` with the tower loaded: two ``image_url`` PNG chats
    beside the text ones, VISION_NEW tokens each (an image lane decodes step
    by step, so no device run carries it, and it is kept as no prompt
    cache)."""
    import base64

    jobs = [(f"image {name}", [
        {"type": "text", "text": "what is in this picture? "},
        {"type": "image_url", "image_url": {
            "url": "data:image/png;base64," + base64.b64encode(png).decode()}}])
        for name, png in pngs.items()]
    ctx = serve_chats(cfg, w, "Qwen2-VL-2B", {"clip_cfg": ccfg, "clip_weights": cw}, jobs,
                      VISION_NEW)
    if any(s is not None and ctx.kv.mrope_delta.get(ctx.kv.lane_of(s)) for s in ctx.kv.seq_ids):
        raise AssertionError("Qwen2-VL-2B serving: an image lane was kept as a prompt cache")


def vision_tower_cpu(ccfg, cw) -> None:
    """The 32-layer tower on the card against the same weights on the CPU, a
    112 x 112 PNG (64 patches), both f32: rel L2 <= VISION_TOL. The script
    sets no TF32 switch; the port's contexts turn TF32 off."""
    import torch

    from rrs_tpu_torch.models.llama import to_device
    from rrs_tpu_torch.mtmd.image_io import decode_image
    from rrs_tpu_torch.mtmd.pipeline import embed_images

    t0 = time.perf_counter()
    arr = decode_image(vision_png(112, 112, seed=5))
    (got, grid), = embed_images(ccfg, cw, [arr])
    cpu = to_device(cw, "cpu")
    (ref, _), = embed_images(ccfg, cpu, [arr])
    rel = _rel_t(got.float().cpu(), ref)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    if rel > VISION_TOL or tf32:
        raise AssertionError(f"Qwen2-VL-2B tower card vs CPU: rel L2 {rel:.2e} (TF32 {tf32})")
    print(f"  the 32-layer tower, card vs the CPU port on a 112 x 112 image ({grid} merged grid): "
          f"rel L2 {rel:.2e} <= {VISION_TOL:.0e} (f32 both; torch.backends.cuda.matmul."
          f"allow_tf32 {tf32}) in {time.perf_counter() - t0:.1f} s", flush=True)
    del cpu


def small_projectors() -> dict:
    """label -> (ClipConfig, ClipWeights on the CPU, patches, grid or None):
    each projector at a small width, drawn from a seed."""
    import dataclasses

    import numpy as np
    import torch

    from rrs_tpu_torch.mtmd.clip import ClipConfig, random_clip_weights

    gen = torch.Generator().manual_seed(6)

    def rnd(*shape):
        return torch.randn(shape, generator=gen) * 0.05

    def base(**kw):
        cfg = ClipConfig(**{**dict(image_size=64, patch_size=8, n_embd=128, n_layers=2,
                                   n_heads=4, n_ff=256, n_embd_llm=192, n_merge=2), **kw})
        return cfg, random_clip_weights(cfg, seed=7, device="cpu")

    out = {}
    cfg, w = base()
    out["mlp"] = (cfg, w, None)
    out["gemma3"] = (*base(projector_type="gemma3"), None)
    cfg, w = base(projector_type="qwen2.5vl_merger", ffn_act="silu_gated", n_wa_pattern=2,
                  attn_window_size=32)
    e, f = cfg.n_embd, cfg.n_ff
    w.layers = [dataclasses.replace(lw, w_gate=rnd(e, f), b_gate=rnd(f)) for lw in w.layers]
    out["qwen2.5vl_merger"] = (cfg, w, (10, 6))                  # ragged 2 x 2-unit windows
    cfg, w = base(projector_type="resampler", query_num=16)
    ep = 128
    w.rs = {"query": rnd(16, ep), "kv_w": rnd(e, ep), "ln_q_w": 1 + rnd(ep),
            "ln_q_b": rnd(ep), "ln_kv_w": 1 + rnd(ep), "ln_kv_b": rnd(ep),
            "ln_post_w": 1 + rnd(ep), "ln_post_b": rnd(ep), "proj": rnd(ep, cfg.n_embd_llm),
            **{f"{n}_{s}": rnd(ep, ep) if s == "w" else rnd(ep)
               for n in ("q", "k", "v", "o") for s in ("w", "b")}}
    out["resampler"] = (cfg, w, None)
    cfg, w = base(projector_type="pixtral", spatial_merge=1)
    w.layers = [dataclasses.replace(lw, w_gate=rnd(e, f)) for lw in w.layers]
    w.img_break = rnd(cfg.n_embd_llm)
    out["pixtral"] = (cfg, w, (6, 5))
    cfg, w = base(projector_type="idefics3")
    w.mm_fc = rnd(4 * e, cfg.n_embd_llm)
    out["idefics3"] = (cfg, w, None)
    cfg, w = base(projector_type="internvl")
    w.cls_embd, w.mm_ln_w, w.mm_ln_b = rnd(e), 1 + rnd(4 * e), rnd(4 * e)
    w.pos_embd = rnd(cfg.n_patches + 1, e)
    w.mm0_w, w.mm0_b = rnd(4 * e, 256), rnd(256)
    w.mm2_w = rnd(256, cfg.n_embd_llm)
    w.layers = [dataclasses.replace(lw, ls1=1 + rnd(e), ls2=1 + rnd(e)) for lw in w.layers]
    out["internvl"] = (cfg, w, None)
    rng = np.random.default_rng(9)
    return {k: (c, w_, rng.standard_normal(((g[0] * g[1]) if g else c.n_patches,
                                             3 * c.patch_size ** 2)).astype(np.float32), g)
            for k, (c, w_, g) in out.items()}


def vision_small() -> None:
    """2-layer checks, card against CPU: a qwen2vl text model at reduced
    widths with dense bf16 weights and qkv biases fed [text, a 4 x 6 image
    chunk with its M-RoPE grid, text] then a decode step (logits within
    GLUE_TOL, the text delta equal); each projector at a small width (rel L2
    <= VISION_TOL); ``seq_div`` over a bf16 and a q4 cache, K bit-equal."""
    import dataclasses

    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.mtmd import clip
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.runtime.kv_cache import KVCache

    t0 = time.perf_counter()
    cfg = ModelConfig(arch="qwen2vl", n_layers=2, n_embd=1024, n_heads=8, n_kv_heads=4,
                      head_dim=128, n_ff=2048, vocab_size=4096, context_length=4096,
                      rope_theta=1e6, attn_bias=True, rope_sections=(16, 24, 24, 0))
    w = family_small_weights(cfg, seed=30)
    gen = torch.Generator().manual_seed(31)

    def bias(lin):
        return dataclasses.replace(lin, bias=(torch.randn(lin.w.shape[1], generator=gen) * 0.02
                                              ).to(torch.bfloat16))

    w = dataclasses.replace(w, layers=[dataclasses.replace(
        lw, wq=bias(lw.wq), wk=bias(lw.wk), wv=bias(lw.wv)) for lw in w.layers])
    emb = torch.randn((24, cfg.n_embd), generator=gen) * 0.05
    pre, post = (torch.randint(2, 4096, (n,), generator=gen).tolist() for n in (40, 20))
    res = {}
    for dev, weights in (("cpu", w), ("cuda", llama.to_device(w, "cuda"))):
        ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=256, device=dev)
        seq = ctx.new_sequence()
        ctx.prefill(seq, pre)
        img = ctx.prefill_embeds(seq, emb, mrope_grid=(4, 6))[-1]
        last = ctx.prefill(seq, post)[-1]
        step = ctx.decode({seq: 11})[seq]
        res[dev] = ([t.float().cpu() for t in (img, last, step)], ctx.kv.mrope_delta)
    rels = [_rel_t(a, b) for a, b in zip(res["cuda"][0], res["cpu"][0])]
    if max(rels) > GLUE_TOL or res["cuda"][1] != res["cpu"][1] or not res["cpu"][1]:
        raise AssertionError(f"qwen2vl 2 layers card vs CPU: rel {rels}, deltas "
                             f"{res['cuda'][1]} / {res['cpu'][1]}")
    print(f"  qwen2vl (2 layers, dense, [40 tokens, a 4 x 6 image chunk, 20 tokens] + a decode "
          f"step): logits card vs CPU rel L2 image / text / decode "
          + " / ".join(f"{r:.4f}" for r in rels) + f" <= {GLUE_TOL}; M-RoPE delta "
          f"{res['cuda'][1]} on both", flush=True)
    rels = {}
    for label, (ccfg, cw, patches, grid) in small_projectors().items():
        outs = []
        for dev, weights in (("cpu", cw), ("cuda", llama.to_device(cw, "cuda"))):
            if ccfg.projector_type in clip.MERGERS:
                outs.append(clip.encode_image_qwen2vl(ccfg, weights, patches, grid))
            elif ccfg.projector_type == "pixtral":
                outs.append(clip.encode_image_pixtral(ccfg, weights, patches, grid))
            elif ccfg.projector_type == "resampler":
                outs.append(clip.encode_image_minicpmv(ccfg, weights, patches))
            else:
                outs.append(clip.encode_image(ccfg, weights, patches))
        rels[label] = rel = _rel_t(outs[1].float().cpu(), outs[0])
        if rel > VISION_TOL or outs[1].shape != outs[0].shape:
            raise AssertionError(f"projector {label} card vs CPU: rel L2 {rel:.2e}")
    print("  projectors card vs CPU (rel L2 <= " + f"{VISION_TOL:.0e}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()), flush=True)
    for quant in ("none", "q4"):
        kvs = {}
        for dev in ("cpu", "cuda"):
            kv = KVCache.create(cfg, n_lanes=2, max_seq=256, device=dev, quant=quant)
            g = torch.Generator().manual_seed(40)
            for c in kv.k + kv.v:
                for t in (c if isinstance(c, tuple) else (c,)):
                    src = (torch.randint(0, 256, t.shape, generator=g) if t.dtype == torch.uint8
                           else torch.rand(t.shape, generator=g) * 0.1 if t.dtype == torch.float32
                           else torch.randn(t.shape, generator=g))
                    t.copy_(src.to(t.dtype))
            kv.seq_new(0)
            kv.seq_new(1)
            kv.lengths[1] = 200
            kv.seq_div(cfg, 1, 20, 200, 3)
            kvs[dev] = kv
        same = all(torch.equal(a.cpu(), b) for ca, cb in zip(kvs["cuda"].k, kvs["cpu"].k)
                   for a, b in zip(ca if quant == "q4" else (ca,), cb if quant == "q4" else (cb,)))
        if not same or not (kvs["cuda"].slot_pos[1] == kvs["cpu"].slot_pos[1]).all():
            raise AssertionError(f"seq_div over a {quant} cache: K differs from the CPU's")
        print(f"  seq_div ([20, 200) of 200 positions / 3) over a "
              f"{'bf16' if quant == 'none' else 'q4 head-pair'} cache: K bit-equal to the CPU's, "
              f"next position offset {kvs['cuda'].pos_offset(1)}", flush=True)
    print(f"  2-layer and small-width checks took {time.perf_counter() - t0:.1f} s", flush=True)


def write_hf_qwen2vl(d, cfg, ccfg, cw, seed: int) -> dict:
    """An HF-format Qwen2-VL directory: ``config.json`` at Qwen2-VL-2B's
    widths with the text cut to ``cfg.n_layers`` layers, BF16 text weights
    N(0, 0.05) drawn on the card from ``seed`` (qkv biases, norms one, tied
    embeddings), the 32-layer tower's weights ``cw`` rounded to BF16 (the
    conv3d stem as two halves of the summed stem, q / k / v fused into qkv),
    all written by the port's safetensors writer, and ``synthetic_vocab``'s
    BPE ``tokenizer.json``. Returns the BF16 tower tensors by HF name."""
    import torch

    from rrs_tpu_torch.tools.safetensors_io import save_safetensors

    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "architectures": ["Qwen2VLForConditionalGeneration"], "model_type": "qwen2_vl",
        "hidden_size": cfg.n_embd, "intermediate_size": cfg.n_ff,
        "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.context_length, "rms_norm_eps": cfg.rms_eps,
        "rope_theta": cfg.rope_theta, "tie_word_embeddings": True, "torch_dtype": "bfloat16",
        "rope_scaling": {"type": "mrope", "mrope_section": list(cfg.rope_sections[:3])},
        "vision_config": QWEN2VL_2B_VISION}))
    toks = synthetic_vocab(cfg.vocab_size).tokens
    (d / "tokenizer.json").write_text(json.dumps({
        "model": {"type": "BPE", "vocab": {t: i for i, t in enumerate(toks)}, "merges": []},
        "added_tokens": []}))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.05).to(torch.bfloat16).cpu()

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16)

    e, f = cfg.n_embd, cfg.n_ff
    pfx = "model.language_model."
    sd = {pfx + "embed_tokens.weight": rnd(cfg.vocab_size, e), pfx + "norm.weight": ones(e)}
    for i in range(cfg.n_layers):
        p = f"{pfx}layers.{i}."
        sd.update({p + "input_layernorm.weight": ones(e),
                   p + "post_attention_layernorm.weight": ones(e),
                   p + "self_attn.q_proj.weight": rnd(cfg.n_q_dim, e),
                   p + "self_attn.q_proj.bias": rnd(cfg.n_q_dim),
                   p + "self_attn.k_proj.weight": rnd(cfg.n_kv_dim, e),
                   p + "self_attn.k_proj.bias": rnd(cfg.n_kv_dim),
                   p + "self_attn.v_proj.weight": rnd(cfg.n_kv_dim, e),
                   p + "self_attn.v_proj.bias": rnd(cfg.n_kv_dim),
                   p + "self_attn.o_proj.weight": rnd(e, cfg.n_q_dim),
                   p + "mlp.gate_proj.weight": rnd(f, e), p + "mlp.up_proj.weight": rnd(f, e),
                   p + "mlp.down_proj.weight": rnd(e, f)})

    def b16(t):
        return t.to(torch.bfloat16).cpu().contiguous()

    v = "model.visual."
    half = b16(cw.patch_w.T.reshape(ccfg.n_embd, 3, ccfg.patch_size, ccfg.patch_size) / 2)
    tower = {v + "patch_embed.proj.weight": torch.stack([half, half], dim=2)}
    for i, lw in enumerate(cw.layers):
        p = f"{v}blocks.{i}."
        tower.update({p + "norm1.weight": b16(lw.ln1_w), p + "norm1.bias": b16(lw.ln1_b),
                      p + "norm2.weight": b16(lw.ln2_w), p + "norm2.bias": b16(lw.ln2_b),
                      p + "attn.qkv.weight": b16(torch.cat([lw.wq.T, lw.wk.T, lw.wv.T])),
                      p + "attn.qkv.bias": b16(torch.cat([lw.bq, lw.bk, lw.bv])),
                      p + "attn.proj.weight": b16(lw.wo.T), p + "attn.proj.bias": b16(lw.bo),
                      p + "mlp.fc1.weight": b16(lw.w_up.T), p + "mlp.fc1.bias": b16(lw.b_up),
                      p + "mlp.fc2.weight": b16(lw.w_down.T), p + "mlp.fc2.bias": b16(lw.b_down)})
    tower.update({v + "merger.ln_q.weight": b16(cw.post_ln_w),
                  v + "merger.ln_q.bias": b16(cw.post_ln_b),
                  v + "merger.mlp.0.weight": b16(cw.mm0_w.T),
                  v + "merger.mlp.0.bias": b16(cw.mm0_b),
                  v + "merger.mlp.2.weight": b16(cw.mm2_w.T),
                  v + "merger.mlp.2.bias": b16(cw.mm2_b)})
    save_safetensors(d / "model-00001-of-00002.safetensors", sd, metadata={"format": "pt"})
    save_safetensors(d / "model-00002-of-00002.safetensors", tower, metadata={"format": "pt"})
    return tower


def tower_from_hf(ccfg, tower):
    """The in-memory tower of the BF16 HF tensors, on the card: each weight
    widened to f32 and laid out as ``load_mmproj`` lays out the converted
    file's (the two stem halves summed in f32, [in, out] contiguous)."""
    import torch

    from rrs_tpu_torch.mtmd.clip import ClipLayer, ClipWeights

    v, e = "model.visual.", ccfg.n_embd

    def f32(name):
        return tower[name].to(torch.float32)

    def lin(t):
        return t.T.contiguous().cuda()

    stem = f32(v + "patch_embed.proj.weight")
    patch_w = (stem[:, :, 0].reshape(e, -1) + stem[:, :, 1].reshape(e, -1)).T.contiguous()
    layers = []
    for i in range(ccfg.n_layers):
        p = f"{v}blocks.{i}."
        qkv, qkv_b = f32(p + "attn.qkv.weight"), f32(p + "attn.qkv.bias")
        layers.append(ClipLayer(
            ln1_w=f32(p + "norm1.weight").cuda(), ln1_b=f32(p + "norm1.bias").cuda(),
            wq=lin(qkv[:e]), bq=qkv_b[:e].cuda(), wk=lin(qkv[e:2 * e]),
            bk=qkv_b[e:2 * e].cuda(), wv=lin(qkv[2 * e:]), bv=qkv_b[2 * e:].cuda(),
            wo=lin(f32(p + "attn.proj.weight")), bo=f32(p + "attn.proj.bias").cuda(),
            ln2_w=f32(p + "norm2.weight").cuda(), ln2_b=f32(p + "norm2.bias").cuda(),
            w_up=lin(f32(p + "mlp.fc1.weight")), b_up=f32(p + "mlp.fc1.bias").cuda(),
            w_down=lin(f32(p + "mlp.fc2.weight")), b_down=f32(p + "mlp.fc2.bias").cuda()))
    return ClipWeights(
        patch_w=patch_w.cuda(), patch_b=None, pos_embd=None, pre_ln_w=None, pre_ln_b=None,
        post_ln_w=f32(v + "merger.ln_q.weight").cuda(),
        post_ln_b=f32(v + "merger.ln_q.bias").cuda(), layers=layers,
        mm0_w=lin(f32(v + "merger.mlp.0.weight")), mm0_b=f32(v + "merger.mlp.0.bias").cuda(),
        mm2_w=lin(f32(v + "merger.mlp.2.weight")), mm2_b=f32(v + "merger.mlp.2.bias").cuda())


def vision_files_start(cfg_full, ccfg, cw, tmp):
    """The file path's first half: the HF-format directory at Qwen2-VL-2B's
    widths (text cut to 2 layers, the full 32-layer tower, BF16), then
    ``convert-hf`` and ``convert-hf --mmproj``, each a process of its own,
    left running beside the checks that follow. Returns what
    ``vision_files_finish`` takes."""
    import dataclasses

    t0 = time.perf_counter()
    hf = tmp / "qwen2vl-hf"
    tower = write_hf_qwen2vl(hf, dataclasses.replace(cfg_full, n_layers=2), ccfg, cw,
                             seed=TOOLS_SEED)
    size = sum(p.stat().st_size for p in hf.iterdir())
    print(f"  HF directory (text 2 of 28 layers, the 32-layer tower, BF16): {size / GB:.3f} GB "
          f"written in {time.perf_counter() - t0:.1f} s; convert-hf and convert-hf --mmproj "
          f"started", flush=True)
    runs = [_verb_start(["convert-hf", hf, tmp / "qwen2vl-f16.gguf", "--outtype", "f16"]),
            _verb_start(["convert-hf", hf, tmp / "mmproj.gguf", "--mmproj"])]
    return runs, tower, t0


def vision_files_finish(ccfg, pngs, tmp, started) -> None:
    """The file path's second half: the converted tower's embeddings of the
    448 x 448 image bit-equal, on the card, to those of the in-memory tower
    built from the same BF16 weights; then ``serve -m ... --mmproj ...`` as a
    process answering one chat request with the 448 x 672 image."""
    import base64

    import torch

    from rrs_tpu_torch.mtmd.clip import load_mmproj
    from rrs_tpu_torch.mtmd.image_io import decode_image
    from rrs_tpu_torch.mtmd.pipeline import embed_images

    runs, tower, t0 = started
    ref_tower = tower_from_hf(ccfg, tower)
    for r in runs:
        _verb_wait(r, timeout=600)
    fcfg, fw = load_mmproj(tmp / "mmproj.gguf", device="cuda")
    arr = decode_image(pngs["448x448"])
    (got, grid), = embed_images(fcfg, fw, [arr])
    (ref, _), = embed_images(ccfg, ref_tower, [arr])
    if fcfg != ccfg or not torch.equal(got, ref):
        raise AssertionError(f"mmproj file tower vs the in-memory BF16 tower: config "
                             f"{fcfg == ccfg}, max diff {(got - ref).abs().max().item():.3e}")
    print(f"  convert-hf --mmproj: {(tmp / 'mmproj.gguf').stat().st_size / GB:.3f} GB f32; its "
          f"tower's embeddings of the 448 x 448 image ({grid} merged grid) bit-equal to the "
          f"in-memory tower of the same BF16 weights", flush=True)
    del fw, ref_tower
    torch.cuda.empty_cache()
    handle = _verb_start(["serve", "-m", tmp / "qwen2vl-f16.gguf", "--mmproj",
                          tmp / "mmproj.gguf", "--port", "0", "--parallel", "1", "--ctx", "1024"])
    proc = handle[0]
    t1 = time.perf_counter()
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("serving "):
                port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
                break
        if port is None:
            raise AssertionError(f"serve --mmproj did not start: {proc.stderr.read()[-2000:]}")
        t_up = time.perf_counter() - t1
        url = "data:image/png;base64," + base64.b64encode(pngs["448x672"]).decode()
        t1 = time.perf_counter()
        status, data = _http(port, "POST", "/v1/chat/completions", {"messages": [
            {"role": "user", "content": [{"type": "text", "text": "what is this? "},
                                         {"type": "image_url", "image_url": {"url": url}}]}],
            "max_tokens": 8, "temperature": 0}, timeout=300)
        dt = time.perf_counter() - t1
        out = json.loads(data) if status == 200 else {}
        if status != 200 or out["usage"]["completion_tokens"] != 8:
            raise AssertionError(f"serve --mmproj chat: {status} {data[:300]!r}")
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
        _CHILDREN.remove(proc)
    print(f"  $ python -m rrs_tpu_torch serve -m qwen2vl-f16.gguf --mmproj mmproj.gguf --port 0 "
          f"--parallel 1 --ctx 1024: serving after {t_up:.1f} s; one chat request with the "
          f"448 x 672 image answered 8 tokens in {dt * 1e3:.0f} ms; the file path took "
          f"{time.perf_counter() - t0:.1f} s from the HF directory's first byte", flush=True)


def phase_vision(reports, peaks, tmp) -> None:
    """Qwen2-VL-2B (phase 18): (a) the full-width model in memory: each
    image's tower, ``generate_with_images``, a held [text, image, text]
    prefill and decode step, the server with image parts, a B = 1 decode
    profile of an image lane; then (d)'s HF directory and converters, left
    running beside (b) the tower on the card against the CPU port and (c) the
    2-layer and small-width checks; then the rest of (d), the converted files
    through ``serve --mmproj``."""
    import torch

    from rrs_tpu_torch.mtmd.image_io import decode_image
    from rrs_tpu_torch.mtmd.pipeline import IMAGE_MARKER, embed_images, multimodal_prefill

    cfg, w, ccfg, cw = vision_model()
    pngs = {name: vision_png(h, wd, seed=i) for i, (name, (h, wd)) in
            enumerate(VISION_IMAGES.items())}
    arrays = {name: decode_image(png) for name, png in pngs.items()}
    vision_encode(ccfg, cw, arrays, peaks)
    ctx = vision_generate(cfg, w, ccfg, cw, pngs, reports)
    chunks = dict(zip(arrays, embed_images(ccfg, cw, list(arrays.values()))))
    vision_held(ctx, chunks)
    vision_serve(cfg, w, ccfg, cw, pngs)
    vocab = synthetic_vocab(cfg.vocab_size)
    profile_decode(ctx, None, label="Qwen2-VL-2B, a lane after the 448 x 448 image",
                   prefill=lambda seq: multimodal_prefill(
                       ctx, vocab, seq, f"describe {IMAGE_MARKER} briefly", [chunks["448x448"]]))
    del ctx, w
    started = vision_files_start(cfg, ccfg, cw, tmp)
    vision_tower_cpu(ccfg, cw)
    gc.collect()
    torch.cuda.empty_cache()
    vision_small()
    vision_files_finish(ccfg, pngs, tmp, started)


# -- audio and TTS: Ultravox v0.5 (Llama-3.2-1B) and OuteTTS-0.2-500M ----------

# The GGUF metadata of Llama-3.2-1B as the published config.json of
# meta-llama/Llama-3.2-1B gives it (Ultravox v0.5's text model,
# fixie-ai/ultravox-v0_5-llama-3_2-1b): tied embeddings, llama3 RoPE scaling
ULTRAVOX_LLAMA_GGUF = {
    "general.architecture": "llama", "llama.block_count": 16,
    "llama.context_length": 131072, "llama.embedding_length": 2048,
    "llama.feed_forward_length": 8192, "llama.attention.head_count": 32,
    "llama.attention.head_count_kv": 8, "llama.attention.layer_norm_rms_epsilon": 1e-5,
    "llama.rope.freq_base": 500000.0, "llama.rope.scaling.type": "llama3",
    "llama.rope.scaling.factor": 32.0, "llama.rope.scaling.original_context_length": 8192,
    "llama.tie_word_embeddings": True, "llama.vocab_size": 128256}
# its audio tower, whisper-large-v3-turbo's encoder (128 mel bins, 32 layers,
# 1,280 wide, 20 heads, FF 5,120), and the ultravox projector (stack factor 8,
# hidden 4,096) under clip.cpp's keys
ULTRAVOX_MMPROJ = {
    "clip.projector_type": "ultravox", "clip.audio.num_mel_bins": 128,
    "clip.audio.embedding_length": 1280, "clip.audio.block_count": 32,
    "clip.audio.attention.head_count": 20, "clip.audio.feed_forward_length": 5120,
    "clip.audio.projection_dim": 2048, "clip.audio.projector.stack_factor": 8,
    "clip.audio.attention.layer_norm_epsilon": 1e-5}
ULTRAVOX_HIDDEN = 4096
# Qwen2-Audio-7B's projector: one fc from the same tower to its 4,096-wide text
QWEN2_AUDIO_DIM = 4096
# OuteTTS-0.2-500M (OuteAI/OuteTTS-0.2-500M's config.json: Qwen2.5-0.5B with
# the vocabulary extended to 157,696) and the OuteTTS special tokens its
# prompt uses, at the ids of the published tokenizer
OUTETTS_GGUF = {
    "general.architecture": "qwen2", "qwen2.block_count": 24,
    "qwen2.context_length": 32768, "qwen2.embedding_length": 896,
    "qwen2.feed_forward_length": 4864, "qwen2.attention.head_count": 14,
    "qwen2.attention.head_count_kv": 2, "qwen2.attention.layer_norm_rms_epsilon": 1e-6,
    "qwen2.rope.freq_base": 1e6, "qwen2.tie_word_embeddings": True,
    "qwen2.vocab_size": 157696}
OUTETTS_SPECIALS = {151643: "<|endoftext|>", 151644: "<|im_start|>", 151645: "<|im_end|>",
                    151661: "<|text_start|>", 151662: "<|text_end|>", 151663: "<|text_sep|>",
                    151666: "<|audio_start|>"}
OUTETTS_EOS = 151645
# the fabricated head's Q8_0 scales on the columns of WavTokenizer's 4,096
# codes (ids 151,672-155,767) are this many times the others', so that
# greedy decoding of random weights emits codes, as a trained model does
CODE_SCALE = 4.0
# WavTokenizer-large-speech-75token as llama.cpp converts it: 4,096 codes of
# 512, the stem to 768, posnet 6 blocks, 12 ConvNeXt blocks of FF 2,304, the
# head to 1,282 (n_fft 1,280, hop 320 at 24 kHz: 75 codes a second)
WAVTOKENIZER = dict(n_codes=4096, c_embd=512, c=768, ff=2304, n_convnext=12, n_out=1282)
AUDIO_NEW = 32
TTS_MAX_CODES = 256
# nine words: with the char-level vocabulary its prompt is 52 tokens, so the
# prefill bucket is 64 rows and ffn_down takes B4 (65-256 tokens take B5)
TTS_TEXT = "hello from the card, this is the port speaking"
# the f32 towers and the vocoder, card against the CPU port (rel L2)
AUDIO_TOL = 1e-3
# a dense text model's step: no B5 unless a prefill chunk reaches 256 rows
AUDIO_PATH = {"tcq4_matmul_gx2", "tcq4_matmul", "q8_matmul", "flash_attention"}
# the two clips: (seconds, sample rate, channels) of PCM16
AUDIO_CLIPS = {"5s-16k-mono": (5.0, 16000, 1), "8s-44k1-stereo": (8.0, 44100, 2)}


def audio_wav(seconds: float, sr: int, channels: int, seed: int) -> bytes:
    """A PCM16 WAV of two tones with noise (the channels phase-shifted),
    written by the standard library's ``wave``."""
    import io
    import wave

    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    chans = [0.3 * np.sin(2 * np.pi * 440 * t + c) + 0.1 * np.sin(2 * np.pi * 1313 * t)
             + 0.02 * rng.standard_normal(t.size) for c in range(channels)]
    pcm = (np.clip(np.stack(chans, axis=1), -1, 1) * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def random_audio_tower(acfg, seed: int, proj: str = "ultravox", device="cuda"):
    """f32 AudioWeights at ``acfg``'s widths drawn on ``device`` from a
    seeded ``torch.Generator`` (matrices N(0, 0.02), biases zero, norms one;
    the JAX package draws its towers on the host, too slow at 637 M
    weights): the ultravox projector at ULTRAVOX_HIDDEN, or qwen2a's fc."""
    import torch

    from rrs_tpu_torch.mtmd.audio import AudioLayer, AudioWeights

    gen = torch.Generator(device=device).manual_seed(seed)
    e, f = acfg.n_embd, acfg.n_ff

    def m(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def zero(n):
        return torch.zeros((n,), device=device)

    def one(n):
        return torch.ones((n,), device=device)

    layers = [AudioLayer(ln1_w=one(e), ln1_b=zero(e), wq=m(e, e), bq=zero(e), wk=m(e, e),
                         wv=m(e, e), bv=zero(e), wo=m(e, e), bo=zero(e), ln2_w=one(e),
                         ln2_b=zero(e), w_up=m(e, f), b_up=zero(f), w_down=m(f, e),
                         b_down=zero(e)) for _ in range(acfg.n_layers)]
    if proj == "ultravox":
        sf, h = acfg.stack_factor, ULTRAVOX_HIDDEN
        p = {"norm_pre_w": one(e * sf), "w1": m(e * sf, 2 * h), "norm_mid_w": one(h),
             "w2": m(h, acfg.n_embd_llm)}
    else:
        p = {"fc_w": m(e, acfg.n_embd_llm), "fc_b": zero(acfg.n_embd_llm)}
    return AudioWeights(conv1_w=m(e, acfg.n_mel, 3), conv1_b=zero(e), conv2_w=m(e, e, 3),
                        conv2_b=zero(e), pos_embd=m(1500, e), layers=layers, ln_post_w=one(e),
                        ln_post_b=zero(e), proj=p)


def audio_tower_flops(acfg, aw, frames: int = 3000) -> float:
    """One chunk's operations: the two convs, each layer's four projections,
    FFN and attention (QK^T and AV) over the 1,500 rows, and the projector."""
    e, f, n = acfg.n_embd, acfg.n_ff, frames // 2
    convs = 2 * frames * acfg.n_mel * 3 * e + 2 * n * e * e * 3
    per_layer = 2 * n * (4 * e * e + 2 * e * f) + 4 * n * n * e
    p = aw.proj
    if "w1" in p:
        rows = -(-n // acfg.stack_factor)
        proj = 2 * rows * (p["w1"].numel() + p["w2"].numel())
    else:
        proj = 2 * n * p["fc_w"].numel()
    return convs + acfg.n_layers * per_layer + proj


def ultravox_model():
    """Ultravox v0.5 at full width: Llama-3.2-1B's config from
    ``ModelConfig.from_gguf`` on its metadata, fabricated TCQ4 linears with
    their i8p packs and a Q8_0 head over the 128,256-entry vocabulary, all 16
    layers; the whole 32-layer whisper-large-v3-turbo tower and the ultravox
    projector, f32 on the card."""
    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.mtmd.audio import AudioConfig

    cfg = ModelConfig.from_gguf(ULTRAVOX_LLAMA_GGUF)
    t0 = time.perf_counter()
    w = llama.fabricated_tcq4_weights(cfg, seed=0, device="cuda")
    acfg = AudioConfig.from_gguf(ULTRAVOX_MMPROJ)
    aw = random_audio_tower(acfg, seed=1)
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(w))
    print(f"  Ultravox v0.5: Llama-3.2-1B {cfg.n_layers} layers, E={cfg.n_embd}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim}, FF {cfg.n_ff}, vocab {cfg.vocab_size}, rope "
          f"{cfg.rope_scaling_type} x{cfg.rope_scale_factor:g}, fabricated text weights "
          f"{w_bytes / GB:.3f} GB; tower {acfg.n_layers} layers, E={acfg.n_embd}, "
          f"{acfg.n_heads} heads, FF {acfg.n_ff}, {acfg.n_mel} mel bins, ultravox x"
          f"{acfg.stack_factor} -> {ULTRAVOX_HIDDEN} -> {acfg.n_embd_llm}, {aw.nbytes() / GB:.3f}"
          f" GB f32 (projector {sum(t.numel() for t in aw.proj.values()) * 4 / GB:.3f} GB); "
          f"drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, w, acfg, aw


def audio_encode(acfg, aw, wavs, peaks) -> dict:
    """Each WAV decoded by ``decode_audio_b64`` (the channel mean, the
    resample), its log-mel front end on the host (timed apart), and the tower
    over its chunk on the card (CUDA events after a warm-up encode) beside
    its bound at the f32 peak. Returns (name -> the [rows, E] chunk, name ->
    the chunk's mel)."""
    import base64

    import torch

    from rrs_tpu_torch.mtmd.audio import chunk_mel, encoder_forward, log_mel_spectrogram
    from rrs_tpu_torch.mtmd.pipeline import decode_audio_b64

    out, mels = {}, {}
    for name, wav in wavs.items():
        t0 = time.perf_counter()
        pcm = decode_audio_b64(base64.b64encode(wav).decode())
        t1 = time.perf_counter()
        mel = log_mel_spectrogram(pcm, n_mel=acfg.n_mel)
        chunks = chunk_mel(mel)
        t2 = time.perf_counter()
        emb = encoder_forward(acfg, aw, chunks[0])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        emb = encoder_forward(acfg, aw, chunks[0])
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        flops = audio_tower_flops(acfg, aw)
        if len(chunks) != 1 or tuple(emb.shape) != (188, acfg.n_embd_llm) or \
                not torch.isfinite(emb).all():
            raise AssertionError(f"Ultravox tower {name}: {len(chunks)} chunks, "
                                 f"{tuple(emb.shape)}")
        out[name], mels[name] = emb, chunks[0]
        print(f"  clip {name}: {pcm.size} samples at 16 kHz after decode_audio_b64 "
              f"({(t1 - t0) * 1e3:.1f} ms); the mel front end on the host {(t2 - t1) * 1e3:.1f} ms "
              f"({mel.shape[1]} frames, {len(chunks)} chunk); the tower on the card {ms:.2f} ms "
              f"for {flops / 1e12:.3f} TFLOP f32 (bound {flops / peaks[3] * 1e3:.2f} ms at "
              f"{peaks[3] / 1e12:.0f} TFLOP/s, {flops / ms / 1e9:.1f} TFLOP/s) -> {emb.shape[0]} "
              f"rows", flush=True)
    return out, mels


AUDIO_PROMPT = "transcribe this clip: {} and then say what it means."


def zero_perf(ctx) -> None:
    """The context's perf counters back to 0 (after its warm-up)."""
    ctx.n_prefill_tokens = ctx.n_decode_tokens = 0
    ctx.t_prefill_s = ctx.t_decode_s = 0.0


def audio_generate(cfg, w, chunks, reports):
    """``multimodal_prefill`` over [text, an audio chunk, text] then AUDIO_NEW
    greedy decode steps, for each clip on a 1-lane context (ctx 2,048), the
    launch counts set to 0 before and read after both (``launches_audio``).
    Returns the context."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.mtmd.pipeline import IMAGE_MARKER, multimodal_prefill
    from rrs_tpu_torch.runtime.context import InferenceContext

    vocab = synthetic_vocab(cfg.vocab_size)
    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=2048)
    ctx.generate([5, 6, 7], 2)                                       # warm-up
    zero_perf(ctx)
    prompt = AUDIO_PROMPT.format(IMAGE_MARKER)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = {}
    for name, chunk in chunks.items():
        seq = ctx.new_sequence()
        try:
            last = multimodal_prefill(ctx, vocab, seq, prompt, [chunk])
            outs[name] = []
            for _ in range(AUDIO_NEW):
                tok = int(torch.argmax(last))
                outs[name].append(tok)
                last = ctx.decode({seq: tok})[seq]
        finally:
            ctx.kv.seq_rm(seq)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = mark_launches(reports, "launches_audio")
    if AUDIO_PATH - set(launches) or any(len(o) != AUDIO_NEW for o in outs.values()):
        raise AssertionError(f"Ultravox multimodal_prefill + decode: launches {launches}")
    perf = ctx.perf()
    print(f"  multimodal_prefill ([{len(vocab.encode(prompt.split(IMAGE_MARKER)[0]))} tokens, "
          f"188 audio rows, text]) + {AUDIO_NEW} greedy steps for both clips in {dt:.1f} s; "
          f"prefill {perf['n_p_eval']} rows @ {perf['pp_tok_per_s']:.1f} rows/s, decode "
          f"{perf['n_eval']} tok @ {perf['tg_tok_per_s']:.2f} tok/s; greedy "
          f"{outs['5s-16k-mono'][:6]}...; launches {launches}", flush=True)
    return ctx, vocab


def audio_held(ctx, chunk) -> None:
    """A teacher-forced [text, audio, text] prefill (30 tokens, the chunk's
    188 rows: B4 at M = 188 on every linear, 20 tokens) and a decode step
    after it, every B1 / B2 / B3 / B4 launch held to its plain version."""
    import torch

    cfg = ctx.cfg
    rng = torch.Generator().manual_seed(19)
    pre, post = (torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist() for n in (30, 20))
    t0 = time.perf_counter()
    with held_to_plain("Ultravox", AUDIO_PATH) as seen:
        seq = ctx.new_sequence()
        ctx.prefill(seq, pre)
        ctx.prefill_embeds(seq, chunk)
        last = ctx.prefill(seq, post)[-1]
        out = ctx.decode({seq: int(last.argmax())})[seq]
        ctx.kv.seq_rm(seq)
        torch.cuda.synchronize()
    if not (torch.isfinite(last).all() and torch.isfinite(out).all()) or \
            not any(s[0] == 188 for s in seen["tcq4_matmul"][1]):
        raise AssertionError(f"Ultravox held steps: B4 shapes {seen['tcq4_matmul'][1]}")
    print("  Ultravox held ([30 tokens, 188 audio rows, 20 tokens] + a decode step), max rel "
          "by kernel: " + ", ".join(f"{k} {v[0]:.2e} <= {SMALL_TOL[k]:.0e} {sorted(v[1])}"
                                    for k, v in sorted(seen.items()))
          + f" in {time.perf_counter() - t0:.1f} s", flush=True)


def audio_serve(cfg, w, acfg, aw, wavs):
    """``serve_chats`` with the audio tower loaded: an ``input_audio`` chat
    with each WAV beside the text ones, AUDIO_NEW tokens each."""
    import base64

    jobs = [(f"audio {name}", [
        {"type": "text", "text": "what is said in this clip? "},
        {"type": "input_audio", "input_audio": {"data": base64.b64encode(wav).decode(),
                                                "format": "wav"}}])
        for name, wav in wavs.items()]
    serve_chats(cfg, w, "Ultravox", {"audio_cfg": acfg, "audio_weights": aw}, jobs, AUDIO_NEW)


def audio_tower_cpu(acfg, aw, mel) -> None:
    """The tower at full width cut to 2 of its 32 layers, on the card against
    the same weights on the CPU over one 30 s chunk, with the ultravox
    projector at Ultravox's widths and qwen2a's fc at Qwen2-Audio-7B's, both
    f32: rel L2 <= AUDIO_TOL. The script sets no TF32 switch; the port's
    ``set_matmul_precision`` turns TF32 off."""
    import dataclasses

    import torch

    from rrs_tpu_torch.models.llama import to_device
    from rrs_tpu_torch.mtmd.audio import encoder_forward

    t0 = time.perf_counter()
    rels = {}
    qwen2a = random_audio_tower(dataclasses.replace(acfg, n_layers=0,
                                                    n_embd_llm=QWEN2_AUDIO_DIM), 2, "qwen2a")
    for name, proj, cfg in (("ultravox", aw.proj, acfg),
                            ("qwen2a", qwen2a.proj,
                             dataclasses.replace(acfg, projector="qwen2a",
                                                 n_embd_llm=QWEN2_AUDIO_DIM))):
        cfg = dataclasses.replace(cfg, n_layers=2)
        card = dataclasses.replace(aw, layers=aw.layers[:2], proj=proj)
        got = encoder_forward(cfg, card, mel)
        ref = encoder_forward(cfg, to_device(card, "cpu"), mel)
        rel = _rel_t(got.cpu(), ref)
        if rel > AUDIO_TOL or got.shape != ref.shape:
            raise AssertionError(f"audio tower ({name}) card vs CPU: rel L2 {rel:.2e}")
        rels[name] = f"{rel:.2e} ({ref.shape[0]} x {ref.shape[1]})"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    if tf32:
        raise AssertionError("audio tower card vs CPU: TF32 is on")
    print(f"  the tower cut to 2 layers at full width, card vs the CPU port over one 30 s chunk "
          f"(rel L2 <= {AUDIO_TOL:.0e}, f32 both; torch.backends.cuda.matmul.allow_tf32 "
          f"{tf32}): " + ", ".join(f"{k} {v}" for k, v in rels.items())
          + f" in {time.perf_counter() - t0:.1f} s", flush=True)


def outetts_vocab(n: int):
    """``synthetic_vocab`` at OuteTTS's size with its special tokens (control
    tokens, so that ``format_prompt``'s text encodes them) and its EOS."""
    from rrs_tpu_torch.models.vocab import Vocab

    toks = [chr(33 + i) if 33 + i < 0x2FF else f"<tok{i}>" for i in range(n)]
    types = [1] * n
    for i, t in OUTETTS_SPECIALS.items():
        toks[i], types[i] = t, 3
    return Vocab(model="gpt2", tokens=toks, scores=None, token_types=types, merges=[],
                 pre="gpt-2", bos_id=151643, eos_id=OUTETTS_EOS, add_bos=False)


def outetts_model():
    """OuteTTS-0.2-500M at full width, all 24 layers, in the types the
    repository's quantizer gives its GGUF: E = 896 is no multiple of 256, so
    qkv (with its biases), o and gate-up are Q8_0 with K padded to 1,024
    (B2), ``ffn_down`` (K = 4,864) TCQ4 with its i8p pack (B1 / B4), the tied
    head Q8_0 over 157,696 ids with the code columns' scales CODE_SCALE
    times the others'; a bf16 embedding N(0, 0.02). Drawn on the card from a
    seeded ``torch.Generator``."""
    import torch

    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.models.linear import Q8Linear, TCQ4Linear, n_pad_width, want_i8p
    from rrs_tpu_torch.models.llama import LayerWeights, ModelWeights
    from rrs_tpu_torch.ops.tcq4_matmul import pack_i8p
    from rrs_tpu_torch.tts.pipeline import CODE_TOKEN_MIN

    cfg = ModelConfig.from_gguf(OUTETTS_GGUF)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(22)

    def q8(k, n, bias=False):
        npad, kpad = n_pad_width(n), -(-k // 256) * 256
        q = torch.randint(-127, 128, (kpad, npad), generator=gen, device=dev, dtype=torch.int8)
        sc = torch.rand((kpad // 32, npad), generator=gen, device=dev) * 1e-3
        sc[k // 32:] = 0.0
        b = (torch.randn(n, generator=gen, device=dev) * 0.02).to(torch.bfloat16) if bias \
            else None
        return Q8Linear(q=q, scale=sc, bias=b, n_logical=n, k_logical=k if kpad != k else 0)

    def tcq4(k, n):
        qs = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8)
        eff = (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
               ).to(torch.bfloat16)
        return TCQ4Linear(qs=qs, eff=eff, i8p=pack_i8p(qs, eff) if want_i8p() else None)

    e, f = cfg.n_embd, cfg.n_ff
    ones = lambda n: torch.ones((n,), dtype=torch.bfloat16, device=dev)   # noqa: E731
    layers = [LayerWeights(wq=None, wk=None, wv=None, wo=q8(cfg.n_q_dim, e), w_gate=None,
                           w_up=None, w_down=tcq4(f, e),
                           wqkv=q8(e, cfg.n_q_dim + 2 * cfg.n_kv_dim, bias=True),
                           w_gateup=q8(e, 2 * f), attn_norm=ones(e), ffn_norm=ones(e),
                           q_norm=None, k_norm=None)
              for _ in range(cfg.n_layers)]
    head = q8(e, cfg.vocab_size)
    head.scale[:, CODE_TOKEN_MIN:CODE_TOKEN_MIN + WAVTOKENIZER["n_codes"]] *= CODE_SCALE
    embed = (torch.randn((cfg.vocab_size, e), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    w = ModelWeights(embed=embed, layers=layers, final_norm=ones(e), lm_head=head)
    torch.cuda.synchronize()
    print(f"  OuteTTS-0.2-500M: qwen2 {cfg.n_layers} layers, E={cfg.n_embd}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim} (GQA group "
          f"{cfg.n_heads // cfg.n_kv_heads}), FF {cfg.n_ff}, vocab {cfg.vocab_size}; qkv / o / "
          f"gate-up Q8_0 at K {e} -> {-(-e // 256) * 256}, ffn_down TCQ4, the head's code "
          f"columns x{CODE_SCALE:g}; "
          f"{sum(t.numel() * t.element_size() for t in _tensors(w)) / GB:.3f} GB", flush=True)
    return cfg, w, outetts_vocab(cfg.vocab_size)


def random_wavtokenizer(seed: int, device="cuda"):
    """WavTokenizer's decoder at WAVTOKENIZER's widths, f32 on ``device``
    from a seeded ``torch.Generator``: matrices and convs N(0, 0.02), the
    code embedding N(0, 0.1), norms one, biases zero, gamma 0.1."""
    import torch

    from rrs_tpu_torch.tts.vocoder import PosnetLayer, VocoderWeights

    gen = torch.Generator(device=device).manual_seed(seed)
    v = WAVTOKENIZER
    c = v["c"]

    def m(*shape, s=0.02):
        return torch.randn(shape, generator=gen, device=device) * s

    def zero(n=c):
        return torch.zeros((n,), device=device)

    def one(n=c):
        return torch.ones((n,), device=device)

    def res():
        return PosnetLayer(kind="res", params=dict(
            norm1_w=one(), norm1_b=zero(), conv1_w=m(c, c, 3), conv1_b=zero(),
            norm2_w=one(), norm2_b=zero(), conv2_w=m(c, c, 3), conv2_b=zero()))

    attn = PosnetLayer(kind="attn", params=dict(
        norm_w=one(), norm_b=zero(), q_w=m(c, c, 1), q_b=zero(), k_w=m(c, c, 1), k_b=zero(),
        v_w=m(c, c, 1), v_b=zero(), o_w=m(c, c, 1), o_b=zero()))
    convnext = [dict(dw_w=m(c, 1, 7), dw_b=zero(), norm_w=one(), norm_b=zero(),
                     pw1_w=m(c, v["ff"]), pw1_b=zero(v["ff"]), pw2_w=m(v["ff"], c),
                     pw2_b=zero(), gamma=one() * 0.1) for _ in range(v["n_convnext"])]
    return VocoderWeights(
        embed=m(v["n_codes"], v["c_embd"], s=0.1), conv_w=m(c, v["c_embd"], 7), conv_b=zero(),
        posnet=[res(), res(), attn, res(), res(),
                PosnetLayer(kind="norm", params=dict(norm_w=one(), norm_b=zero()))],
        tok_norm_w=one(), tok_norm_b=zero(), convnext=convnext, out_norm_w=one(),
        out_norm_b=zero(), head_w=m(c, v["n_out"]), head_b=zero(v["n_out"]))


def write_wavtokenizer(path, voc) -> None:
    """The vocoder's tensors as a WavTokenizer-dec GGUF under the names
    ``load_vocoder`` reads (llama.cpp's), f32, with the port's writer: a conv
    (Cout, Cin, k) as it is (ggml's ne {k, Cin, Cout}), a linear as (out,
    in)."""
    import numpy as np

    from rrs_tpu_torch.gguf.writer import GGUFWriter

    w = GGUFWriter(path)
    w.add_string("general.architecture", "wavtokenizer-dec")

    def add(name, t, linear=False):
        a = t.detach().float().cpu().numpy()
        w.add_tensor(name, np.ascontiguousarray(a.T if linear else a))

    add("token_embd.weight", voc.embed)
    add("conv1d.weight", voc.conv_w)
    add("conv1d.bias", voc.conv_b)
    names = {"norm_w": "attn_norm.weight", "norm_b": "attn_norm.bias", "q_w": "attn_q.weight",
             "q_b": "attn_q.bias", "k_w": "attn_k.weight", "k_b": "attn_k.bias",
             "v_w": "attn_v.weight", "v_b": "attn_v.bias", "o_w": "attn_output.weight",
             "o_b": "attn_output.bias"}
    for il, layer in enumerate(voc.posnet):
        for key, t in layer.params.items():
            if layer.kind == "attn":
                name = names[key]
            elif layer.kind == "norm":
                name = "norm." + ("weight" if key == "norm_w" else "bias")
            else:
                name = f"{key[:-2]}.{'weight' if key.endswith('_w') else 'bias'}"
            add(f"posnet.{il}.{name}", t)
    add("token_embd_norm.weight", voc.tok_norm_w)
    add("token_embd_norm.bias", voc.tok_norm_b)
    for il, blk in enumerate(voc.convnext):
        for key, t in blk.items():
            name = "gamma" if key == "gamma" else \
                f"{key[:-2]}.{'weight' if key.endswith('_w') else 'bias'}"
            add(f"convnext.{il}.{name}", t, linear=key in ("pw1_w", "pw2_w"))
    add("output_norm.weight", voc.out_norm_w)
    add("output_norm.bias", voc.out_norm_b)
    add("output.weight", voc.head_w, linear=True)
    add("output.bias", voc.head_b)
    w.write()


def tts_run(cfg, w, vocab, voc, reports, tmp):
    """``synthesize`` of TTS_TEXT with max_codes TTS_MAX_CODES on a 1-lane
    context (ctx 4,096, as the ``tts`` verb builds it), its vocoder and
    ``embd_to_audio`` calls timed where ``synthesize`` makes them (the
    vocoder with a sync on each side), the launch counts set to 0 before and
    read after (``launches_tts``). Prints the text model's decode tok/s, the
    vocoder's and the synthesis' ms for the codes made, and the real-time
    factor: seconds of audio a second of the whole call. Returns the
    context."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.tts import dsp, pipeline, vocoder

    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=4096)
    ctx.generate([5, 6, 7], 2)                                       # warm-up
    vocoder.vocoder_forward(voc, [1, 2, 3])
    zero_perf(ctx)
    times = {}
    forward, to_audio = vocoder.vocoder_forward, dsp.embd_to_audio

    def timed_forward(weights, codes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(weights, codes)
        torch.cuda.synchronize()
        times["vocoder"] = time.perf_counter() - t0
        times["codes"] = list(codes)
        return out

    def timed_audio(embd):
        t0 = time.perf_counter()
        out = to_audio(embd)
        times["dsp"] = time.perf_counter() - t0
        return out

    torch.cuda.synchronize()
    kernels.reset_launches()
    vocoder.vocoder_forward, dsp.embd_to_audio = timed_forward, timed_audio
    try:
        t0 = time.perf_counter()
        path, n = pipeline.synthesize(ctx, vocab, voc, TTS_TEXT, max_codes=TTS_MAX_CODES,
                                      out_path=tmp / "tts.wav")
        wall = time.perf_counter() - t0
    finally:
        vocoder.vocoder_forward, dsp.embd_to_audio = forward, to_audio
    launches = mark_launches(reports, "launches_tts")
    frames = _wav_frames(path)
    want = (n - 1) * dsp.N_HOP + dsp.N_WIN - (dsp.N_WIN - dsp.N_HOP)
    if AUDIO_PATH - set(launches) or frames != want or n != len(times["codes"]) or n < 16:
        raise AssertionError(f"OuteTTS synthesize: {n} codes, {frames} frames (want {want}), "
                             f"launches {launches}")
    perf = ctx.perf()
    secs = frames / dsp.SAMPLE_RATE
    print(f"  synthesize({TTS_TEXT!r}, max_codes {TTS_MAX_CODES}): {n} audio codes "
          f"({len(set(times['codes']))} distinct) -> {frames} samples, {secs:.2f} s of 24 kHz "
          f"audio in {wall:.2f} s: real-time factor {secs / wall:.3f} (audio s / compute s); "
          f"the text model's prefill {perf['n_p_eval']} tokens @ {perf['pp_tok_per_s']:.1f} "
          f"tok/s, decode {perf['n_eval']} tok @ {perf['tg_tok_per_s']:.2f} tok/s; the vocoder "
          f"{times['vocoder'] * 1e3:.2f} ms, embd_to_audio on the host {times['dsp'] * 1e3:.2f} "
          f"ms; launches {launches}", flush=True)
    return ctx


def _wav_frames(path) -> int:
    """The frame count of a 24 kHz, 16-bit mono WAV; raises on another
    format."""
    import wave

    with wave.open(str(path), "rb") as f:
        if (f.getframerate(), f.getsampwidth(), f.getnchannels()) != (24000, 2, 1):
            raise AssertionError(f"{path}: {f.getframerate()} Hz, {8 * f.getsampwidth()}-bit, "
                                 f"{f.getnchannels()} channels")
        return f.getnframes()


def tts_held(ctx, vocab) -> None:
    """A teacher-forced prefill of the TTS prompt and a decode step, every
    B1 / B2 / B3 / B4 launch held to its plain version: B2 at K = 896 padded
    to 1,024, B3 at the GQA group of 7."""
    import torch

    from rrs_tpu_torch.tts.pipeline import format_prompt

    toks = vocab.encode(format_prompt(TTS_TEXT), add_special=True)
    if len(toks) > 64:
        raise AssertionError(f"the TTS prompt is {len(toks)} tokens: B5, not B4, would run")
    t0 = time.perf_counter()
    with held_to_plain("OuteTTS", AUDIO_PATH) as seen:
        seq = ctx.new_sequence()
        last = ctx.prefill(seq, toks)[-1]
        out = ctx.decode({seq: int(last.argmax())})[seq]
        ctx.kv.seq_rm(seq)
        torch.cuda.synchronize()
    kpad = -(-ctx.cfg.n_embd // 256) * 256
    if not (torch.isfinite(last).all() and torch.isfinite(out).all()) or \
            not any(s[1] == kpad != ctx.cfg.n_embd for s in seen["q8_matmul"][1]):
        raise AssertionError(f"OuteTTS held steps: B2 shapes {seen['q8_matmul'][1]}")
    print(f"  OuteTTS held (a {len(toks)}-token prompt + a decode step), max rel by kernel: "
          + ", ".join(f"{k} {v[0]:.2e} <= {SMALL_TOL[k]:.0e} {sorted(v[1])}"
                      for k, v in sorted(seen.items()))
          + f" in {time.perf_counter() - t0:.1f} s", flush=True)


def vocoder_cpu(voc) -> None:
    """The full-width vocoder on the card against the same weights on the
    CPU over 128 codes from a seed: rel L2 <= AUDIO_TOL; then its time on
    the card for those codes (CUDA events after a warm-up)."""
    import torch

    from rrs_tpu_torch.models.llama import to_device
    from rrs_tpu_torch.tts.vocoder import vocoder_forward

    codes = torch.randint(0, WAVTOKENIZER["n_codes"], (128,),
                          generator=torch.Generator().manual_seed(23)).tolist()
    got = vocoder_forward(voc, codes)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    got = vocoder_forward(voc, codes)
    end.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = vocoder_forward(to_device(voc, "cpu"), codes)
    rel = _rel_t(got.cpu(), ref)
    if rel > AUDIO_TOL or got.shape != (128, WAVTOKENIZER["n_out"]):
        raise AssertionError(f"vocoder card vs CPU: rel L2 {rel:.2e}, {tuple(got.shape)}")
    print(f"  the WavTokenizer decoder ({voc.nbytes() / GB:.3f} GB f32), card vs the CPU port "
          f"over 128 codes: rel L2 {rel:.2e} <= {AUDIO_TOL:.0e}; {start.elapsed_time(end):.2f} "
          f"ms on the card, {(time.perf_counter() - t0) * 1e3:.0f} ms on the host's CPU",
          flush=True)


def write_audio_files(tmp) -> None:
    """The file path's inputs, written on the host (run in a process of its
    own beside the card work): an ultravox mmproj at full widths with the
    tower cut to 2 layers (``write_audio_mmproj``, whose projector hidden is
    the tower's FF, 5,120, as the JAX writer sizes it); Llama-3.2-1B's
    widths and OuteTTS-0.2-500M's, each cut to 2 layers, from the port's
    exporter in F16 (tied embeddings), the latter over OuteTTS's vocabulary
    with the code rows of its embedding scaled by CODE_SCALE in place."""
    import dataclasses
    from pathlib import Path

    import numpy as np

    from rrs_tpu_torch.gguf.reader import read_gguf
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.models.export import export_random_gguf
    from rrs_tpu_torch.mtmd.audio import AudioConfig, write_audio_mmproj
    from rrs_tpu_torch.tts.pipeline import CODE_TOKEN_MIN

    tmp = Path(tmp)
    t0 = time.perf_counter()
    write_audio_mmproj(tmp / "ultravox-mmproj.gguf", dataclasses.replace(
        AudioConfig.from_gguf(ULTRAVOX_MMPROJ), n_layers=2), seed=24)
    for name, md, vocab in (("llama32-1b-2l", ULTRAVOX_LLAMA_GGUF, None),
                            ("outetts-2l", OUTETTS_GGUF, outetts_vocab(157696))):
        cfg = dataclasses.replace(ModelConfig.from_gguf(md), n_layers=2, tie_embeddings=True)
        vocab = vocab or synthetic_vocab(cfg.vocab_size)
        export_random_gguf(cfg, tmp / f"{name}.gguf", seed=25, dtype=np.float16,
                           vocab_tokens=vocab.tokens, vocab_types=vocab.token_types)
    path = tmp / "outetts-2l.gguf"
    with read_gguf(path) as g:
        info = g.tensors["token_embd.weight"]
        row = info.shape[1] * 2
        start = g.data_start + info.offset + CODE_TOKEN_MIN * row
    with open(path, "r+b") as f:
        f.seek(start)
        rows = np.frombuffer(f.read(WAVTOKENIZER["n_codes"] * row), np.float16) * CODE_SCALE
        f.seek(start)
        f.write(rows.astype(np.float16).tobytes())
    print(f"wrote the file path's GGUFs in {time.perf_counter() - t0:.1f} s", flush=True)


def audio_files_start(tmp):
    """``write_audio_files`` in a process of its own; returns its handle."""
    from pathlib import Path

    proc = subprocess.Popen([sys.executable, "-c", "import sys, chip_smoke; "
                             "chip_smoke.write_audio_files(sys.argv[1])", str(tmp)],
                            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    _CHILDREN.append(proc)
    return proc, time.perf_counter()


def audio_files_finish(tmp, wavs, started) -> None:
    """The file path: ``serve -m <Llama-3.2-1B widths, 2 layers> --mmproj
    <the ultravox mmproj>`` as a process answering one chat request with the
    5 s clip as an ``input_audio`` part, and beside it ``tts -m <OuteTTS, 2
    layers> -mv <the vocoder GGUF>``, whose WAV must be 24 kHz, 16-bit, mono
    with (n_codes - 1) * 320 + 1,280 - 960 frames."""
    import base64

    from rrs_tpu_torch.tts import dsp

    writer, t0 = started
    try:
        out, err = writer.communicate(timeout=600)
    finally:
        _CHILDREN.remove(writer)
    if writer.returncode != 0:
        raise AssertionError(f"write_audio_files: exit {writer.returncode}\n{err[-3000:]}")
    sizes = ", ".join(f"{p.name} {p.stat().st_size / GB:.3f} GB" for p in sorted(tmp.glob("*.gguf")))
    print(f"  {out.strip()} ({sizes}; {time.perf_counter() - t0:.1f} s since the phase began)",
          flush=True)
    tts = _verb_start(["tts", "-m", tmp / "outetts-2l.gguf", "-mv", tmp / "wavtokenizer.gguf",
                       "-p", TTS_TEXT, "-o", tmp / "verb.wav", "--max-codes", "48"])
    handle = _verb_start(["serve", "-m", tmp / "llama32-1b-2l.gguf", "--mmproj",
                          tmp / "ultravox-mmproj.gguf", "--port", "0", "--parallel", "1",
                          "--ctx", "1024"])
    proc = handle[0]
    t1 = time.perf_counter()
    try:
        port, lines = None, []
        for line in proc.stdout:
            lines.append(line.strip())
            if line.startswith("serving "):
                port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
                break
        if port is None or not any(s.startswith("loaded audio tower") for s in lines):
            raise AssertionError(f"serve --mmproj did not start: {lines} "
                                 f"{proc.stderr.read()[-2000:]}")
        t_up = time.perf_counter() - t1
        t1 = time.perf_counter()
        status, data = _http(port, "POST", "/v1/chat/completions", {"messages": [
            {"role": "user", "content": [
                {"type": "text", "text": "what is said here? "},
                {"type": "input_audio", "input_audio": {
                    "data": base64.b64encode(wavs["5s-16k-mono"]).decode(), "format": "wav"}}]}],
            "max_tokens": 8, "temperature": 0}, timeout=300)
        dt = time.perf_counter() - t1
        res = json.loads(data) if status == 200 else {}
        if status != 200 or res["usage"]["completion_tokens"] != 8:
            raise AssertionError(f"serve --mmproj audio chat: {status} {data[:300]!r}")
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
        _CHILDREN.remove(proc)
    print(f"  $ python -m rrs_tpu_torch serve -m llama32-1b-2l.gguf --mmproj "
          f"ultravox-mmproj.gguf --port 0 --parallel 1 --ctx 1024: {lines[-2]!r}; serving "
          f"after {t_up:.1f} s; one chat request with the 5 s clip (its 188 audio rows beside "
          f"{res['usage']['prompt_tokens']} prompt tokens) answered 8 tokens in {dt * 1e3:.0f} "
          f"ms", flush=True)
    line = _verb_wait(tts, timeout=600).strip().splitlines()[-1]
    n = int(line.split("(")[1].split()[0])
    frames = _wav_frames(tmp / "verb.wav")
    if frames != (n - 1) * dsp.N_HOP + dsp.N_WIN - (dsp.N_WIN - dsp.N_HOP) or n < 1:
        raise AssertionError(f"tts verb: {line!r}, {frames} frames")
    print(f"  tts: {line!r}: 24 kHz 16-bit mono, {frames} frames = ({n} - 1) * {dsp.N_HOP} + "
          f"{dsp.N_WIN} - {dsp.N_WIN - dsp.N_HOP}; the file path took "
          f"{time.perf_counter() - t0:.1f} s since the phase began", flush=True)


def phase_audio(reports, peaks, tmp) -> None:
    """Audio and TTS (phase 19): (a) Ultravox v0.5 at full width in memory:
    each clip's front end and tower, ``multimodal_prefill`` + greedy decode,
    a held [text, audio, text] prefill and decode step, the server with audio
    parts, a B = 1 decode profile; (b) the tower cut to 2 layers with both
    projectors, card against the CPU port; (c) OuteTTS-0.2-500M at full
    width with the full WavTokenizer decoder: ``synthesize``, a held step, a
    decode profile, the vocoder card against the CPU port; (d) the files,
    written by a process started first, through ``serve --mmproj`` and
    ``tts`` as processes."""
    import torch

    from rrs_tpu_torch.mtmd.pipeline import IMAGE_MARKER, multimodal_prefill
    from rrs_tpu_torch.tts.pipeline import format_prompt

    started = audio_files_start(tmp)
    cfg, w, acfg, aw = ultravox_model()
    wavs = {name: audio_wav(s, sr, ch, seed=i)
            for i, (name, (s, sr, ch)) in enumerate(AUDIO_CLIPS.items())}
    chunks, mels = audio_encode(acfg, aw, wavs, peaks)
    ctx, vocab = audio_generate(cfg, w, chunks, reports)
    audio_held(ctx, chunks["8s-44k1-stereo"])
    audio_serve(cfg, w, acfg, aw, wavs)
    profile_decode(ctx, None, label="Ultravox (Llama-3.2-1B), a lane after the 5 s clip",
                   prefill=lambda seq: multimodal_prefill(
                       ctx, vocab, seq, AUDIO_PROMPT.format(IMAGE_MARKER),
                       [chunks["5s-16k-mono"]]))
    del ctx, w
    audio_tower_cpu(acfg, aw, mels["8s-44k1-stereo"])
    del aw, chunks
    gc.collect()
    torch.cuda.empty_cache()
    cfg, w, vocab = outetts_model()
    voc = random_wavtokenizer(seed=26)
    ctx = tts_run(cfg, w, vocab, voc, reports, tmp)
    tts_held(ctx, vocab)
    profile_decode(ctx, vocab.encode(format_prompt(TTS_TEXT), add_special=True),
                   label="OuteTTS-0.2-500M")
    vocoder_cpu(voc)
    write_wavtokenizer(tmp / "wavtokenizer.gguf", voc)
    del ctx, w, voc
    gc.collect()
    torch.cuda.empty_cache()
    audio_files_finish(tmp, wavs, started)


# ---------------------------------------------------------------------------
# Phase 20: training (train/finetune.py and the finetune verb)
# ---------------------------------------------------------------------------

# qwen3-4b's full depth: AdamW steps on one repeated B = 1, T = 256 batch
TRAIN_STEPS = 4
TRAIN_LR = 1e-3
# the backwards card against CPU (f32 products of the same operands in
# another order; TF32 is off)
TRAIN_BWD_TOL = 1e-4
# a dense f32 model's AdamW steps card against CPU: the first loss (the
# forward alone) absolute; the later ones absolute at the reference's limit
# on a reloaded loss; each tensor's update in rel L2. Adam moves a weight
# whose gradient is near zero by up to lr a step, either way of a last-bit
# difference, so single weights may part by a few lr (2.5 lr measured)
TRAIN_LOSS_TOL = 1e-4
TRAIN_LATER_LOSS_TOL = 1e-3
TRAIN_UPDATE_TOL = 5e-2
# Qwen3-0.6B's published widths for the finetune verb, cut to this many of
# its 28 layers (the phase's time: the f32 file is written and read twice)
VERB_LAYERS = 4
# train() runs the first 12 of qwen3-4b's 36 layers (all 36 until phase 21
# needed the room), as phase 10 serves them
TRAIN_FULL_LAYERS = 12
TRAIN_EXPECT = {"tcq4_matmul_i8p", "tcq4_matmul", "tcq4_matmul_gx2", "q8_matmul"}
NORM_FIELDS = ("attn_norm", "ffn_norm", "q_norm", "k_norm", "attn_post_norm", "ffn_post_norm")


def f32_floats(w):
    """The weights as the finetune verb loads them (f32 floats): f32 copies
    of the embedding and the norms; the TCQ4 codes, their bf16 scales and
    packs, and the Q8 head shared."""
    import dataclasses

    f = lambda t: None if t is None else t.float()                     # noqa: E731
    layers = [dataclasses.replace(lw, **{k: f(getattr(lw, k)) for k in NORM_FIELDS})
              for lw in w.layers]
    return dataclasses.replace(w, embed=f(w.embed), layers=layers, final_norm=f(w.final_norm))


def frozen_checksums(w) -> dict:
    """{path: position-weighted byte sum} of every TCQ4 code tensor, i8p pack
    tensor (its f32 scales too) and Q8 code tensor of the weights."""
    import torch

    def digest(t):
        b = t.contiguous().view(torch.uint8).reshape(-1).to(torch.int64)
        return int((b * (torch.arange(b.numel(), device=b.device) % 65521 + 1)).sum())

    out = {}
    for i, lw in enumerate(w.layers):
        for name in ("wqkv", "wo", "w_gateup", "w_down", "wq", "wk", "wv", "w_gate", "w_up"):
            lin = getattr(lw, name)
            if lin is None:
                continue
            out[f"{i}.{name}.qs"] = digest(lin.qs)
            for j, t in enumerate(lin.i8p or ()):
                out[f"{i}.{name}.i8p{j}"] = digest(t)
    out["lm_head.q"] = digest(w.lm_head.q)
    return out


def training_batch(vocab: int, t: int, seed: int):
    """One [1, t + 1] block of a repeating 64-token pattern."""
    import numpy as np

    from rrs_tpu_torch.train.finetune import make_dataset

    pattern = np.random.default_rng(seed).integers(0, vocab, 64).tolist()
    return make_dataset(pattern * (t // 64 + 2), seq_len=t, batch=1)[0]


def training_backwards_held(cfg, w) -> None:
    """Each quantized linear's backward on the card against the CPU's on the
    same inputs and cotangent: the fused qkv (TCQ4 with its pack) at the M of
    B1, B4 and B5, and the Q8 head at M = 8."""
    import torch

    from rrs_tpu_torch.models.linear import linear_apply
    from rrs_tpu_torch.models.llama import to_device

    gen = torch.Generator(device="cuda").manual_seed(41)
    for label, lin, ms in (("qkv (TCQ4)", w.layers[0].wqkv, (8, 128, 256)),
                           ("lm_head (Q8_0)", w.lm_head, (8,))):
        lin_cpu = to_device(lin, "cpu")
        k = lin.shape[0]
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda")
            g = torch.randn((m, lin.shape[1]), generator=gen, device="cuda")
            grads = []
            for dev, layer in (("cuda", lin), ("cpu", lin_cpu)):
                xr = x.to(dev).clone().requires_grad_(True)
                if hasattr(layer, "scale"):
                    layer = type(layer)(**{**layer.__dict__,
                                           "scale": layer.scale.clone().requires_grad_(True)})
                linear_apply(layer, xr).backward(g.to(dev))
                grads.append([xr.grad] + ([layer.scale.grad] if hasattr(layer, "scale") else []))
            for name, got, ref in zip(("dx", "d scale"), *grads):
                err, rel = compare(f"training backward, {label} {name} at M = {m}", got.cpu(),
                                   ref, TRAIN_BWD_TOL)
                print(f"  backward {label} {name} at M = {m}: card vs CPU err {err:.3e} "
                      f"(rel {rel:.2e} <= {TRAIN_BWD_TOL:.0e})", flush=True)


def training_dense_held() -> None:
    """A dense f32 2-layer model's three AdamW steps on the card against the
    same steps on the CPU: the first loss (before any update), the later
    losses, and every tensor's update."""
    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.train.finetune import TrainConfig, _leaves, train

    cfg = ModelConfig(arch="qwen3", n_layers=2, n_embd=1024, n_heads=8, n_kv_heads=4,
                      head_dim=128, n_ff=3072, vocab_size=4096, context_length=256,
                      qk_norm=True)
    w = llama.random_weights(cfg, seed=17, dtype=torch.float32)
    batches = [training_batch(cfg.vocab_size, 64, seed=18)] * 3
    tc = TrainConfig(lr=TRAIN_LR)
    w_card, l_card = train(cfg, llama.to_device(w, "cuda"), batches, tc, device="cuda")
    w_cpu, l_cpu = train(cfg, w, batches, tc, device="cpu")
    d0 = abs(l_card[0] - l_cpu[0])
    dl = max(abs(a - b) for a, b in zip(l_card, l_cpu))
    # the tied head trains apart from the embedding: w's head is a view of
    # its embedding, so each trained tensor is compared with w's own
    upd = max(float(torch.linalg.vector_norm(a.cpu() - b)
                    / torch.linalg.vector_norm(b - w0).clamp_min(1e-30))
              for a, b, w0 in zip(_leaves(w_card), _leaves(w_cpu), _leaves(w)))
    print(f"  dense f32 2-layer model (E 1,024, vocab 4,096), 3 AdamW steps on one T = 64 "
          f"batch: losses {[round(x, 5) for x in l_card]} (CPU {[round(x, 5) for x in l_cpu]}; "
          f"first {d0:.2e} <= {TRAIN_LOSS_TOL:.0e}, all {dl:.2e} <= {TRAIN_LATER_LOSS_TOL:.0e}); "
          f"updates card vs CPU, worst tensor's rel L2 {upd:.2e} <= {TRAIN_UPDATE_TOL:.0e}",
          flush=True)
    if not (len(l_card) == 3 and d0 <= TRAIN_LOSS_TOL and dl <= TRAIN_LATER_LOSS_TOL
            and upd <= TRAIN_UPDATE_TOL and l_card[-1] < l_card[0]):
        raise AssertionError(f"dense training card vs CPU: losses {l_card} / {l_cpu}, "
                             f"updates {upd:.3e}")


def training_guard_held(w) -> None:
    """A kernel wrapper called under grad outside its autograd Function
    raises on the card (it would cut the gradient)."""
    import torch

    from rrs_tpu_torch.ops import q8_matmul as q8
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    lin = w.layers[0].wqkv
    x = torch.randn((4, lin.shape[0]), device="cuda", requires_grad=True)
    for name, call in (("tcq4_matmul_gx2", lambda: tm.tcq4_matmul_gx2(x, lin.qs, lin.eff)),
                       ("q8_matmul", lambda: q8.q8_matmul(x, w.lm_head.q, w.lm_head.scale))):
        try:
            call()
        except RuntimeError as e:
            if name not in str(e):
                raise
            continue
        raise AssertionError(f"{name} ran under grad on an input that requires grad")
    print("  tcq4_matmul_gx2 and q8_matmul refuse an input that requires grad under autograd",
          flush=True)


def training_held(cfg, weights) -> None:
    """Phase 20 (a): 2 layers of qwen3-4b width in f32 floats: one training
    step at each route's T (256: B5; 128: B4; 8: B1 and B4 for the down
    projection; B2 the head), every launch inside the autograd Functions held
    to its plain version on the inputs it got; the backwards card vs CPU; a
    dense model's AdamW steps card vs CPU; the wrappers' refusal."""
    from rrs_tpu_torch.train.finetune import TrainConfig, train

    t0 = time.perf_counter()
    cfg2, w2 = first_layers(cfg, f32_floats(weights), 2)
    batches = [training_batch(cfg.vocab_size, t, seed=t) for t in (256, 128, 8)]
    with held_to_plain("training, 2 of qwen3-4b's layers", TRAIN_EXPECT) as seen:
        _, losses = train(cfg2, w2, batches, TrainConfig(lr=TRAIN_LR), device="cuda")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training at 2 layers: losses {losses}")
    print(f"  2 layers, T = 256 / 128 / 8: losses {[round(x, 4) for x in losses]}; held to "
          f"the plain versions: " + ", ".join(f"{k} (worst rel {v[0]:.2e}, shapes "
                                              f"{sorted(v[1])})" for k, v in sorted(seen.items()))
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    training_backwards_held(cfg2, w2)
    t1 = time.perf_counter()
    training_dense_held()
    training_guard_held(w2)
    print(f"  the backwards {t1 - t0:.1f} s, the dense model and the refusal "
          f"{time.perf_counter() - t1:.1f} s", flush=True)


def training_profile(cfg, w32, batch, peaks) -> dict:
    """One AdamW step at full depth under torch.profiler, its device time
    split into forward, backward and optimizer (each part ends in a
    synchronize, and a kernel belongs to the part in whose span it starts),
    by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from rrs_tpu_torch.train import finetune as ft

    params, static, plist = ft.trainable(w32)
    opt = ft.make_optimizer(ft.TrainConfig(lr=TRAIN_LR))

    def step(parts):
        for p in plist:
            p.grad = None
        with parts("forward"):
            loss = ft._loss_fn(cfg, ft.combine(params, static), batch)
            torch.cuda.synchronize()
        with parts("backward"):
            loss.backward()
            torch.cuda.synchronize()
        with parts("optimizer"):
            opt.step(plist, [p.grad for p in plist])
            torch.cuda.synchronize()

    step(lambda name: contextlib.nullcontext())                      # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(record_function)
    parts = ("forward", "backward", "optimizer")
    spans = {e.name: (e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name in parts and e.device_type == torch.autograd.DeviceType.CPU}
    # a record_function span shows on the device timeline too: not a kernel
    kernels = [e for e in device_ms_by_kernel(prof)[0] if e.name not in parts]
    if not kernels or len(spans) != 3:
        print("  training profile: the profiler recorded no device time (not measured)",
              flush=True)
        return {}
    out = {}
    for part, (t0, t1) in spans.items():
        by: dict = {}
        for e in kernels:
            if t0 <= e.time_range.start <= t1:
                name = kernel_label(e.name)
                if name == "other":
                    name = training_kernel_kind(e.name)
                by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        out[part] = {"wall_ms": (t1 - t0) / 1e3, "device_ms": sum(by.values()), "by_kernel": by,
                     "kernels": sum(1 for e in kernels if t0 <= e.time_range.start <= t1)}
        split = ", ".join(f"{k} {v:.3f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:8])
        raw: dict = {}
        for e in kernels:
            if t0 <= e.time_range.start <= t1 and kernel_label(e.name) == "other":
                raw[e.name[:70]] = raw.get(e.name[:70], 0.0) + e.time_range.elapsed_us() / 1e3
        top = "; ".join(f"{k} {v:.2f}" for k, v in sorted(raw.items(), key=lambda kv: -kv[1])[:4])
        print(f"  training profile, {part}: wall {out[part]['wall_ms']:.2f} ms, device "
              f"{out[part]['device_ms']:.2f} ms, {out[part]['kernels']} kernels; device ms by "
              f"kernel: {split}; the largest library kernels: {top}", flush=True)
    print(f"  training profile, host ms by op: {host_top(prof, 1, 10)} (the profiler's own cost "
          f"included)", flush=True)
    del params, plist, opt
    return out


def training_kernel_kind(name: str) -> str:
    """A library kernel's kind, by its CUDA name."""
    import re

    for kind, pat in (("matmul (library)", r"gemm|cutlass|xmma|sm90_|ampere_|cublas"),
                      ("reduction", r"reduce|Reduce"), ("index / scatter", r"index|scatter|gather"),
                      ("copy / cast", r"copy|Copy|cast"), ("cat", r"[Cc]at"),
                      ("elementwise", r"elementwise|vectorized|unrolled|Elementwise")):
        if re.search(pat, name):
            return kind
    return "other"


def training_bound_ms(cfg, w, t: int, peaks) -> tuple:
    """(least ms, bound) of one training step at B = 1, T = t: operations
    (the STE backward's f32 products g @ W^T, the head's dx and d scale in
    f32, the W4A4 forward in int8, the head's forward in bf16) over the
    card's peaks against the bytes moved (the codes read forward and
    backward, the AdamW pass over every trained value: p, g, m, v read, p,
    m, v written) over its memory rate."""
    bw, bf16, i8, f32 = peaks
    kn = sum(lin.shape[0] * lin.shape[1] for lw in w.layers
             for lin in (lw.wqkv, lw.wo, lw.w_gateup, lw.w_down))
    head = w.lm_head.q.shape[0] * w.lm_head.q.shape[1]
    t_ops = 2 * t * (kn + 2 * head) / f32 + 2 * t * kn / i8 + 2 * t * head / bf16
    trained = w.embed.numel() + w.lm_head.scale.numel() + sum(
        lw.wqkv.eff.numel() + lw.wo.eff.numel() + lw.w_gateup.eff.numel()
        + lw.w_down.eff.numel() for lw in w.layers)
    code_bytes = 2 * (kn // 2 + head)
    t_bytes = (code_bytes + 7 * 4 * trained) / bw
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            t_ops * 1e3, t_bytes * 1e3)


def training_full(cfg, weights, reports, peaks) -> None:
    """Phase 20 (b): ``train`` at qwen3-4b's full width, its first
    TRAIN_FULL_LAYERS layers (f32 floats, frozen codes shared): AdamW at lr 1e-3 on one repeated B = 1, T = 256
    batch, then one step at T = 128 and one at T = 8; the loss falls, every
    loss is finite, the frozen tensors keep their checksums, B5 / B4 / B1 /
    B2 launch and B3 does not; each step's wall and device-timeline ms, the
    peak memory, one profiled step split into its parts."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.train.finetune import TrainConfig, train

    w32 = f32_floats(weights)
    before = frozen_checksums(w32)
    b256 = training_batch(cfg.vocab_size, 256, seed=20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    marks = []

    def on_step(i, loss):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((time.perf_counter(), ev))

    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    marks.append((t0, start))
    w_out, losses = train(cfg, w32, [b256] * TRAIN_STEPS, TrainConfig(lr=TRAIN_LR),
                          on_step=on_step, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / GB
    wall = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    dev = [a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])]
    extra = {}
    for t in (128, 8):
        t1 = time.perf_counter()
        _, ls = train(cfg, w32, [training_batch(cfg.vocab_size, t, seed=t)],
                      TrainConfig(lr=TRAIN_LR), device="cuda")
        torch.cuda.synchronize()
        extra[t] = (ls[0], (time.perf_counter() - t1) * 1e3)
    launches = {k: kernels.LAUNCHES[k] for k in ("tcq4_matmul_i8p", "tcq4_matmul",
                                                "tcq4_matmul_gx2", "q8_matmul", "flash_attention")}
    after = frozen_checksums(w_out)
    print(f"  qwen3-4b, {cfg.n_layers} of 36 layers, B = 1: AdamW at lr {TRAIN_LR} over one repeated T = 256 "
          f"batch: losses {[round(x, 4) for x in losses]}; T = 128: loss {extra[128][0]:.4f} "
          f"({extra[128][1]:.1f} ms with set-up), T = 8: {extra[8][0]:.4f} "
          f"({extra[8][1]:.1f} ms)", flush=True)
    print(f"  T = 256 step wall ms (host clock, each step ending in its loss read-back): "
          f"{[round(x, 2) for x in wall]}; device-timeline ms (CUDA events between the "
          f"read-backs): {[round(x, 2) for x in dev]}; peak memory {peak:.2f} GB", flush=True)
    print(f"  launches in training: {launches}", flush=True)
    if not (all(math.isfinite(x) for x in losses + [extra[128][0], extra[8][0]])
            and losses[-1] < losses[0]):
        raise AssertionError(f"training at full depth: losses {losses}, {extra}")
    if after != before:
        bad = [k for k in before if before[k] != after.get(k)]
        raise AssertionError(f"training changed frozen tensors: {bad[:8]}")
    if launches["flash_attention"] or not all(launches[k] for k in TRAIN_EXPECT):
        raise AssertionError(f"training launches: {launches}")
    print(f"  frozen tensors unchanged ({len(before)} checksums: TCQ4 codes, i8p packs, the Q8 "
          f"head's codes)", flush=True)
    for key, name in (("i8p", "tcq4_matmul_i8p"), ("tcq4", "tcq4_matmul"),
                      ("gx2", "tcq4_matmul_gx2"), ("q8", "q8_matmul"), ("fa", "flash_attention")):
        reports[key].entry["launches_training"] = launches[name]
    del w_out
    torch.cuda.empty_cache()
    bound, by, t_ops, t_bytes = training_bound_ms(cfg, w32, 256, peaks)
    prof = training_profile(cfg, w32, b256, peaks)
    steady = wall[1:] or wall
    wall_ms = sum(steady) / len(steady)
    busy = sum(p["device_ms"] for p in prof.values()) if prof else float("nan")
    print(f"  training step at T = 256: wall {wall_ms:.2f} ms (steps 2-{TRAIN_STEPS}), device "
          f"busy {busy:.2f} ms (profiled step), idle share {1 - busy / wall_ms:.3f}; bound "
          f"{bound:.2f} ms ({by}: operations {t_ops:.2f}, bytes {t_bytes:.2f}); peak memory "
          f"{peak:.2f} GB", flush=True)
    del w32


def training_verb_start(tmp):
    """Phase 20 (c), its start: an f32 GGUF at Qwen3-0.6B's published widths
    (VERB_LAYERS of its 28 layers, an untied head), written by the port's
    exporter with the synthetic vocabulary, and a text of its tokens; then
    ``finetune`` on them as a process. The files are written, and the
    process started, in a thread of their own beside the card's work.
    Returns what ``training_verb_finish`` needs."""
    box: dict = {}

    def run():
        import dataclasses

        import numpy as np

        from rrs_tpu_torch.models.config import PRESETS
        from rrs_tpu_torch.models.export import export_random_gguf

        try:
            cfg = dataclasses.replace(PRESETS["qwen3-0.6b"], n_layers=VERB_LAYERS,
                                      tie_embeddings=False)
            vocab = synthetic_vocab(cfg.vocab_size)
            t0 = time.perf_counter()
            src = export_random_gguf(cfg, tmp / "qwen3-0.6b-f32.gguf", seed=21, scale=0.02,
                                     vocab_tokens=vocab.tokens)
            chars = [t for t in vocab.tokens[:200] if len(t) == 1 and not t.isspace()]
            pattern = "".join(np.random.default_rng(22).choice(chars, 64))
            text = tmp / "train.txt"
            text.write_text(pattern * 8)
            box["files"] = (f"  wrote {src.name} ({src.stat().st_size / GB:.2f} GB) and a "
                            f"{len(pattern) * 8}-char text in {time.perf_counter() - t0:.1f} s")
            out = tmp / "qwen3-0.6b-trained.gguf"
            box["started"] = (_verb_start(["finetune", "-m", src, "-f", text, "-o", out, "--lr",
                                           "1e-3", "--seq-len", "128", "--batch", "1",
                                           "--epochs", "1"]), out, text)
        except BaseException as e:                                  # raised by the finish
            box["error"] = e

    thread = threading.Thread(target=run, name="finetune-files")
    thread.start()
    return thread, box


def training_verb_finish(started) -> None:
    """Phase 20 (c), its end: the verb's per-step losses, its written file
    reloaded on the card, and the reloaded model's loss over the verb's first
    two batches within 1e-3 of the trained loss the verb printed."""
    import re

    import torch

    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.train.finetune import evaluate, make_dataset

    thread, box = started
    thread.join()
    if "error" in box:
        raise box["error"]
    print(box["files"], flush=True)
    handle, out, text = box["started"]
    log = _verb_wait(handle, timeout=300)
    losses = [float(v) for v in re.findall(r"step \d+: loss ([0-9.]+)", log)]
    trained = float(re.search(r"trained loss ([0-9.]+)", log).group(1))
    t0 = time.perf_counter()
    cfg, w, md = load_model(out, dtype=torch.float32, fuse=False, device="cuda")
    toks = Vocab.from_gguf(md).encode(text.read_text(), add_special=True)
    reloaded = evaluate(cfg, w, make_dataset(toks, seq_len=128, batch=1)[:2], device="cuda")
    print(f"  finetune (Qwen3-0.6B widths, {cfg.n_layers} of 28 layers, f32): step losses "
          f"{losses}; trained loss {trained:.6f}, reloaded {reloaded:.6f} "
          f"(|diff| {abs(reloaded - trained):.2e} <= 1e-3; reload and evaluation "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if not (losses and all(math.isfinite(x) for x in losses) and trained < losses[0]
            and abs(reloaded - trained) <= 1e-3):
        raise AssertionError(f"finetune verb: losses {losses}, trained {trained}, "
                             f"reloaded {reloaded}")
    del w
    torch.cuda.empty_cache()


def phase_training(cfg, weights, reports, peaks, tmp):
    """Phase 20: the finetune verb's files and process started first (a
    thread writes them and the process runs while the card runs phases
    20-22), then the held checks at 2 layers and the full-depth steps.
    Returns the started verb, whose result ``training_verb_finish`` reads
    after phase 22."""
    t0 = time.perf_counter()
    started = training_verb_start(tmp)
    training_held(cfg, weights)
    t1 = time.perf_counter()
    training_full(*first_layers(cfg, weights, TRAIN_FULL_LAYERS), reports, peaks)
    print(f"  phase 20 took {time.perf_counter() - t0:.1f} s (the held part {t1 - t0:.1f} s, full "
          f"depth {time.perf_counter() - t1:.1f} s; the verb's files written beside them)",
          flush=True)
    return started


# ---------------------------------------------------------------------------
# Phase 21: the parallel serving paths (tensor / data parallel over a mesh of
# shards, the pipeline, the multi-process entry) on one card
# ---------------------------------------------------------------------------

PARALLEL_LAYERS = 6             # of qwen3-4b's 36 layers (12 until phase 22 needed the room)
PARALLEL_NEW = 16
PARALLEL_PROMPT = "the parallel paths run on one card: two shards, two rows, two stages"
TP_PATH = {"tcq4_matmul_gx2", "tcq4_matmul_i8p", "q8_matmul", "flash_attention"}


@contextlib.contextmanager
def reduces_held(model, full, label: str):
    """While open, every row-parallel product on ``model``'s shards (o and
    down: ``linear_apply`` with a ``reduce_axis``) records each shard's
    input and the all-reduced f32 sum, before the bias and the cast; on
    leaving, each reduce is held to the unsharded kernel route (the full-K
    TCQ4 linear of ``full`` at the same M) on the shards' inputs joined in
    rank order: INT_TOL where the route is an integer kernel (B1, B5), the
    reference's 0.02 where it is B4. Yields {route: (n, max rel)}."""
    import torch

    from rrs_tpu_torch.models import linear as lin
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    where = {}
    for sh in model.shards:
        for li, lw in enumerate(sh.weights.layers):
            for name in ("wo", "w_down"):
                where[id(getattr(lw, name))] = (li, name)
    calls, lock, orig = [], threading.Lock(), llama.linear_apply

    class Tap:
        def __init__(self, comm):
            self.comm, self.sum = comm, None

        def all_reduce(self, y):
            self.sum = self.comm.all_reduce(y)
            return self.sum

    def hooked(layer, x, reduce_axis=None):
        if reduce_axis is None:
            return orig(layer, x)
        tap = Tap(reduce_axis)
        out = orig(layer, x, reduce_axis=tap)
        with lock:
            calls.append((where[id(layer)], reduce_axis.rank, x, tap.sum))
        return out

    stats: dict = {}
    llama.linear_apply = hooked
    try:
        yield stats
    finally:
        llama.linear_apply = orig
    groups: dict = {}
    for key, rank, x, y in calls:
        groups.setdefault((key, rank), []).append((x, y))
    for (key, rank), got in groups.items():
        if rank != 0:
            continue
        li, name = key
        fl = getattr(full.layers[li], name)
        parts = [groups[(key, r)] for r in range(model.mesh.tp)]
        for i, (_, y) in enumerate(got):
            xf = torch.cat([parts[r][i][0] for r in range(model.mesh.tp)], dim=-1)
            x2 = xf.reshape(-1, xf.shape[-1])
            m, k = x2.shape
            ref = lin._tcq4_forward(x2, fl.qs, fl.eff, fl.i8p)
            route = ("tcq4_matmul_gx2" if tm.gx_viable(m, k, fl.qs.shape[1]) else
                     "tcq4_matmul_i8p" if fl.i8p is not None and m >= 256 else "tcq4_matmul")
            tol = 0.02 if route == "tcq4_matmul" else INT_TOL
            err = (y.float() - ref).abs().max().item()
            rel = err / max(ref.abs().max().item(), 1e-30)
            if not (torch.isfinite(y).all() and rel <= tol):
                raise AssertionError(f"{label}: the reduce of layer {li} {name} at M = {m} "
                                     f"({route}) is {rel:.3e} from the unsharded kernel > {tol}")
            n, worst = stats.get(route, (0, 0.0))
            stats[route] = (n + 1, max(worst, rel))


def tp_greedy(ctx, prompt, n_new: int):
    """Prefill then n_new greedy decode steps: (the prefill's last logits row,
    the tokens)."""
    seq = ctx.new_sequence()
    try:
        last = ctx.prefill(seq, prompt, all_logits=False)[-1]
        toks = [int(last.argmax())]
        for _ in range(n_new - 1):
            toks.append(int(ctx.decode({seq: toks[-1]})[seq].argmax()))
    finally:
        ctx.kv.seq_rm(seq)
    return last, toks


def parallel_held(cfg, w, label_kv: str, quant: str, expect) -> None:
    """Teacher-forced prefills of 40 and 300 tokens and a decode step on a
    tp = 2 context over 2 layers, every kernel launch on each shard held to
    its plain version and every row-parallel reduce to the unsharded
    kernel."""
    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.parallel.sharding import make_mesh
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg2, w2 = first_layers(cfg, w, 2)
    full = llama.unfused(cfg2, w2)
    ctx = InferenceContext(cfg2, full, n_lanes=1, max_seq=1024, kv_quant=quant,
                           mesh=make_mesh(devices=["cuda:0"] * 2))
    rng = torch.Generator().manual_seed(21)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist() for n in (40, 300)]
    label = f"tp = 2 held, {label_kv}"
    with held_to_plain(label, expect) as seen, reduces_held(ctx.sharded, full, label) as red:
        seq = ctx.new_sequence()
        for p in prompts:
            ctx.prefill(seq, p)
        out = ctx.decode({seq: 7})[seq]
        torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite decode logits")
    one = InferenceContext(cfg2, full, n_lanes=1, max_seq=1024, kv_quant=quant)
    seq = one.new_sequence()
    for p in prompts:
        one.prefill(seq, p)
    ref = one.decode({seq: 7})[seq]
    print(f"  {label}: the decode step's logits against the unsharded context on the same 2 "
          f"layers (reported): max |diff| {(out - ref).abs().max().item():.4f} of max |logit| "
          f"{ref.abs().max().item():.3f}, argmax {int(out.argmax())} / {int(ref.argmax())}",
          flush=True)
    for name, (worst, shapes) in sorted(seen.items()):
        print(f"  {label}, {name}: every launch on both shards within its tolerance of its "
              f"plain version (max rel {worst:.2e}); shapes {sorted(shapes)}", flush=True)
    print(f"  {label}, row-parallel reduces (o, down) against the unsharded kernel on the "
          f"joined inputs: " + ", ".join(f"{k} {n} reduces, max rel {r:.2e}"
                                         for k, (n, r) in sorted(red.items())), flush=True)
    if {"tcq4_matmul_gx2", "tcq4_matmul", "tcq4_matmul_i8p"} - set(red):
        raise AssertionError(f"{label}: reduces held only on {sorted(red)}")


def engine_greedy(ctx, prompts):
    """The engine on ``ctx`` serves one greedy request a prompt, each to
    PARALLEL_NEW tokens, all submitted at once: (each request's tokens, the
    seconds)."""
    import queue as _queue

    from rrs_tpu_torch.runtime.sampler import SamplerParams
    from rrs_tpu_torch.serving.engine import Engine, GenRequest

    engine = Engine(ctx)
    q: "_queue.Queue" = _queue.Queue()
    outs = {i: [] for i in range(len(prompts))}
    for i, p in enumerate(prompts):
        engine.submit(GenRequest(
            prompt_tokens=p, max_tokens=PARALLEL_NEW, params=SamplerParams(temperature=0.0),
            on_token=lambda tok, piece, fin, reason, i=i:
            q.put((i, reason)) if fin else outs[i].append(tok)))
    t0 = time.perf_counter()
    engine.start()
    try:
        done = dict(q.get(timeout=600) for _ in prompts)
    finally:
        engine.stop()
    dt = time.perf_counter() - t0
    if any(done[i] != "length" or len(outs[i]) != PARALLEL_NEW for i in outs):
        raise AssertionError(f"engine: {done}, {[len(o) for o in outs.values()]}")
    return [outs[i] for i in range(len(prompts))], dt


def greedy_rows(ctx, prompts, n_new: int, forced=None):
    """Each prompt prefilled on a sequence of its own, then n_new - 1 decode
    steps of all of them in one batch, each feeding its row's argmax or, with
    ``forced`` (a token list a prompt), the given tokens: per prompt, (its
    logits rows [T + n_new - 1, V] on the host, the argmax of its last
    prefill row and of each decode row)."""
    import torch

    seqs = [ctx.new_sequence() for _ in prompts]
    try:
        rows = [[ctx.prefill(s, p).float().cpu()] for s, p in zip(seqs, prompts)]
        toks = [[int(r[0][-1].argmax())] for r in rows]
        for i in range(n_new - 1):
            feed = [t[i] if forced is None else forced[k][i] for k, t in enumerate(toks)]
            out = ctx.decode(dict(zip(seqs, feed)))
            for k, s in enumerate(seqs):
                row = out[s].float().cpu().reshape(1, -1)
                rows[k].append(row)
                toks[k].append(int(row.argmax()))
    finally:
        for s in seqs:
            ctx.kv.seq_rm(s)
    return [(torch.cat(r), t) for r, t in zip(rows, toks)]


def parallel_dense_witness(dev: str = "cuda:0") -> None:
    """The glue of the sharded paths, where no int4 activation quantizer
    turns rounding into other codes: phase 3's 2-layer model with dense bf16
    weights at tp = 2 and at tp 2 x dp 2 (shards on ``dev``), four prompts
    on 4 lanes, each sharded context decoding greedily and the unsharded
    context fed the same tokens. Every logits row of every prefill and
    decode step must be within GLUE_TOL relative L2 of the unsharded one
    (the bf16 logits tie and near-tie, so equal greedy tokens over many
    steps are counted, not required). Then the engine serves the four
    prompts greedily on the tp 2 x dp 2 context, and each token it sends
    must be a maximum of the unsharded logits fed the same tokens, to within
    twice the largest logit difference the contexts showed (or one bf16 ulp
    of the largest logit, if that is more): a token from another lane or a
    wrong step is not."""
    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.parallel.sharding import make_mesh
    from rrs_tpu_torch.runtime.context import InferenceContext

    # max_seq 512, where the 300-token prefill's 512-row bucket once
    # overwrote lane 0's rows and the 100-token one lane 1's rows 256-299:
    # a lane left out of a step writes nothing (ROADMAP C3)
    cfg = small_cfg()
    w = llama.random_weights(cfg, seed=1, device=dev)
    rng = torch.Generator().manual_seed(25)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (40, 300, 100, 20)]
    one = InferenceContext(cfg, w, n_lanes=4, max_seq=512, device=dev)
    meshes = {"tp = 2": make_mesh(devices=[dev] * 2),
              "tp 2 x dp 2": make_mesh(devices=[dev] * 4, dp=2)}
    diff = 0.0
    for label, mesh in meshes.items():
        got = greedy_rows(InferenceContext(cfg, w, n_lanes=4, max_seq=512, mesh=mesh), prompts,
                          PARALLEL_NEW)
        ref = greedy_rows(one, prompts, PARALLEL_NEW, forced=[t for _, t in got])
        worst, same = 0.0, 0
        for n, (g_rows, g_toks), (r_rows, r_toks) in zip(map(len, prompts), got, ref):
            rel = ((g_rows - r_rows).norm(dim=-1) / r_rows.norm(dim=-1)).max().item()
            if not (torch.isfinite(g_rows).all() and rel <= GLUE_TOL):
                raise AssertionError(f"dense witness, {label}, {n}-token prompt: logits rows "
                                     f"rel L2 {rel:.4f} > {GLUE_TOL} from the unsharded "
                                     f"context's on the same tokens")
            worst = max(worst, rel)
            diff = max(diff, (g_rows - r_rows).abs().max().item())
            same += sum(a == b for a, b in zip(g_toks, r_toks))
        print(f"  dense witness (phase 3's 2-layer model, bf16 weights), {label} on {dev} "
              f"against the unsharded context on the same tokens: prompts of "
              f"{'/'.join(map(str, map(len, prompts)))} tokens x {PARALLEL_NEW} greedy steps on "
              f"4 lanes, every logits row within rel L2 {worst:.2e} <= {GLUE_TOL}; argmax equal "
              f"at {same} of {4 * PARALLEL_NEW} steps", flush=True)
    toks, dt = engine_greedy(InferenceContext(cfg, w, n_lanes=4, max_seq=512,
                                              mesh=meshes["tp 2 x dp 2"]), prompts)
    ref = greedy_rows(one, prompts, PARALLEL_NEW, forced=toks)
    top = max(r.abs().max().item() for r, _ in ref)
    eps = 2 * max(diff, 2.0 ** (math.floor(math.log2(top)) - 7))
    short, same = [], 0
    for k, ((rows, r_toks), e_toks) in enumerate(zip(ref, toks)):
        last = torch.cat([rows[len(prompts[k]) - 1:len(prompts[k])], rows[len(prompts[k]):]])
        gap = last.max(dim=-1).values - last[torch.arange(len(e_toks)), e_toks]
        short += [(k, i, round(g, 4)) for i, g in enumerate(gap.tolist()) if g > eps]
        same += sum(a == b for a, b in zip(e_toks, r_toks))
    if short:
        raise AssertionError(f"dense witness: tokens the tp 2 x dp 2 engine sent are no "
                             f"maximum of the unsharded logits (request, step, gap > {eps:.4f})"
                             f": {short}")
    print(f"  dense witness, the engine on tp 2 x dp 2: each of the {4 * PARALLEL_NEW} tokens "
          f"it sent is a maximum of the unsharded logits on the same tokens within {eps:.4f} "
          f"(the unsharded argmax at {same}); {dt:.2f} s", flush=True)


def parallel_engine(cfg, w) -> None:
    """tp 2 x dp 2 on the card: the engine serves four greedy requests on 4
    lanes (two per dp row), each to PARALLEL_NEW tokens (their tokens are
    held in ``parallel_dense_witness``, where no int4 quantizer amplifies
    rounding)."""
    import torch

    from rrs_tpu_torch.parallel.sharding import make_mesh
    from rrs_tpu_torch.runtime.context import InferenceContext

    ctx = InferenceContext(cfg, w, n_lanes=4, max_seq=2048,
                           mesh=make_mesh(devices=["cuda:0"] * 4, dp=2))
    rng = torch.Generator().manual_seed(22)
    lengths = (40, 300, 100, 20)
    _, dt = engine_greedy(ctx, [torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist()
                                for n in lengths])
    print(f"  tp 2 x dp 2 (4 shards on cuda:0), Engine on 4 lanes: four greedy requests "
          f"({' / '.join(map(str, lengths))} tokens) each to {PARALLEL_NEW} tokens in {dt:.1f} s "
          f"({4 * PARALLEL_NEW / dt:.1f} generated tok/s with the prefills)", flush=True)


PP_NLL_TOL = 1e-4               # nats of mean NLL, pipeline against the context
PP_LOGITS_TOL = 1e-3            # relative L2 of the logits rows, the same two


def parallel_pipeline(cfg, w) -> None:
    """compute_perplexity_pp over two stages on cuda:0 against
    compute_perplexity on the same weights and chunks. Each stage runs the
    context's kernels at the context's M (one 512-token chunk a
    microbatch), so the limits are tight: the mean NLL within PP_NLL_TOL
    nats, and the pipeline's logits rows of both chunks within
    PP_LOGITS_TOL relative L2 of the context's (a dropped stage or uniform
    logits moves the mean NLL by nats)."""
    import numpy as np
    import torch

    from rrs_tpu_torch.parallel.pipeline import make_pipeline_forward, make_pp_mesh
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.tools import perplexity as ppl

    n_ctx = 512
    tokens = torch.randint(2, cfg.vocab_size, (2 * n_ctx,),
                           generator=torch.Generator().manual_seed(23)).tolist()
    mesh = make_pp_mesh(devices=["cuda:0"] * 2)
    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=n_ctx)
    t0 = time.perf_counter()
    ref = ppl.compute_perplexity(ctx, tokens, n_ctx=n_ctx)
    t1 = time.perf_counter()
    got = ppl.compute_perplexity_pp(cfg, w, tokens, mesh, n_ctx=n_ctx, n_micro=2)
    t2 = time.perf_counter()
    first = min(n_ctx // 2, 512)
    chunks = [tokens[c * n_ctx:(c + 1) * n_ctx] for c in range(2)]
    rows = np.concatenate([ppl.host_logits(ctx, c)[first:n_ctx - 1] for c in chunks])
    positions = np.broadcast_to(np.arange(n_ctx, dtype=np.int32), (2, n_ctx)).copy()
    pp_rows = make_pipeline_forward(cfg, w, mesh, 2, n_ctx, n_micro=2)(
        np.asarray(chunks, np.int64), positions)[:, first:n_ctx - 1]
    pp_rows = pp_rows.float().cpu().numpy().reshape(rows.shape)
    rel = float(np.linalg.norm(pp_rows - rows) / np.linalg.norm(rows))
    d_mean = abs(got.nll_sum - ref.nll_sum) / ref.n_tokens
    if (got.n_tokens != ref.n_tokens or not math.isfinite(got.ppl) or d_mean > PP_NLL_TOL
            or not rel <= PP_LOGITS_TOL):
        raise AssertionError(f"pipeline perplexity {got.ppl:.4f} vs {ref.ppl:.4f}: mean NLL "
                             f"{d_mean:.2e} (<= {PP_NLL_TOL}?), logits rows rel L2 {rel:.2e} "
                             f"(<= {PP_LOGITS_TOL}?)")
    print(f"  compute_perplexity_pp, pp = 2 (two stages on cuda:0), 2 x {n_ctx} tokens: PPL "
          f"{got.ppl:.4f} against compute_perplexity's {ref.ppl:.4f} (mean NLL "
          f"{ref.nll_sum / ref.n_tokens:.4f}, apart by {d_mean:.2e} <= {PP_NLL_TOL}); the "
          f"pipeline's logits rows within rel L2 {rel:.2e} <= {PP_LOGITS_TOL} of the context's;"
          f" {t2 - t1:.2f} s against {t1 - t0:.2f} s with their first calls", flush=True)


def parallel_verbs_start(tmp):
    """A tiny GGUF, then ``generate`` plain and through one NCCL process
    (``--dist-coordinator 127.0.0.1:<port> --dist-procs 1 --dist-id 0``),
    started at once; returns their handles."""
    import socket

    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.models.export import export_random_gguf

    cfg = ModelConfig(arch="qwen3", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
                      head_dim=64, n_ff=512, vocab_size=256, context_length=512, qk_norm=True)
    vocab = [chr(33 + i) if 33 + i < 0x2FF else f"<tok{i}>" for i in range(256)]
    gguf = export_random_gguf(cfg, tmp / "tiny_dist.gguf", seed=24, vocab_tokens=vocab)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["generate", "-m", str(gguf), "-p", PARALLEL_PROMPT, "-n", str(PARALLEL_NEW)]
    return (_verb_start(argv),
            _verb_start(argv + ["--dist-coordinator", f"127.0.0.1:{port}", "--dist-procs", "1",
                                "--dist-id", "0"]))


def phase_parallel(cfg_full, weights_full, reports, verbs) -> None:
    """Phase 21 on phase 3's qwen3-4b weights at full width, their first
    PARALLEL_LAYERS layers: tp = 2 as two shards on cuda:0 (prefills of 5 and
    300 tokens, PARALLEL_NEW greedy steps each, its launches counted, its
    agreement with the unsharded context, and that of one device's unfused
    weights, reported); launches held on each shard and reduces held to the
    unsharded kernel (bf16 and q8 KV); tp = 2 and tp 2 x dp 2 held to the
    unsharded context on phase 3's dense model (logits and tokens, the
    engine's tokens); tp 2 x dp 2 serving four requests at full width; the
    pipeline's perplexity and logits; one NCCL process; a decode profile of
    the sharded step. ``verbs``: ``parallel_verbs_start``'s processes, which
    run beside phase 20."""
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.parallel.sharding import make_mesh
    from rrs_tpu_torch.runtime.context import InferenceContext

    t_phase = time.perf_counter()
    cfg, w = first_layers(cfg_full, weights_full, PARALLEL_LAYERS)
    ref = InferenceContext(cfg, w, n_lanes=1, max_seq=1024)
    tp = InferenceContext(cfg, llama.unfused(cfg, w), n_lanes=1, max_seq=1024,
                          mesh=make_mesh(devices=["cuda:0"] * 2))
    rng = torch.Generator().manual_seed(20)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist() for n in (5, 300)]
    torch.cuda.synchronize()
    kernels.reset_launches()
    for counts in tp.sharded.launches.values():
        counts.clear()
    t0 = time.perf_counter()
    runs = [tp_greedy(tp, p, PARALLEL_NEW) for p in prompts]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    shard_launches = {f"{d},{r}": dict(c) for (d, r), c in tp.sharded.launches.items()}
    if set(TP_PATH) - set(launches):
        raise AssertionError(f"tp = 2 generate: kernels not launched: {set(TP_PATH) - set(launches)}")
    for key, name in (("gx2", "tcq4_matmul_gx2"), ("i8p", "tcq4_matmul_i8p"), ("q8", "q8_matmul"),
                      ("fa", "flash_attention"), ("tcq4", "tcq4_matmul")):
        reports[key].entry["launches_parallel"] = launches.get(name, 0)
    agree, fused_vs_unfused = [], []
    one = InferenceContext(cfg, llama.unfused(cfg, w), n_lanes=1, max_seq=1024)
    for p, (last_tp, toks_tp) in zip(prompts, runs):
        last_ref, toks_ref = tp_greedy(ref, p, PARALLEL_NEW)
        _, toks_one = tp_greedy(one, p, PARALLEL_NEW)
        one_ref = sum(a == b for a, b in zip(toks_one, toks_ref))
        tp_one = sum(a == b for a, b in zip(toks_tp, toks_one))
        fused_vs_unfused.append(f"{len(p)}-token prompt: the unfused against the fused {one_ref}"
                                f" of {PARALLEL_NEW}, tp = 2 against the unfused {tp_one} of "
                                f"{PARALLEL_NEW}")
        if not torch.isfinite(last_tp).all():
            raise AssertionError("tp = 2: non-finite logits")
        same = sum(a == b for a, b in zip(toks_tp, toks_ref))
        first_diff = next((i for i, (a, b) in enumerate(zip(toks_tp, toks_ref)) if a != b),
                          None)
        agree.append(f"{len(p)}-token prompt: {same} of {PARALLEL_NEW} greedy tokens equal "
                     f"(first difference at step {first_diff}), the prefill's last row max "
                     f"|diff| {(last_tp - last_ref).abs().max().item():.3f} of max |logit| "
                     f"{last_ref.abs().max().item():.3f}")
    print(f"  tp = 2 (two shards on cuda:0), {cfg.n_layers} of 36 layers: prompts of 5 and 300 "
          f"tokens x {PARALLEL_NEW} greedy steps in {dt:.1f} s; launches {launches}", flush=True)
    print(f"  tp = 2 launches by shard (dp row, tp rank): {shard_launches}", flush=True)
    print("  tp = 2 against the unsharded context on the same weights (reported; one device "
          "runs the fused q|k|v and gate|up, the shards their column halves): "
          + "; ".join(agree), flush=True)
    print("  one device, unfused weights (the shards' kernel routes, no split) against the "
          "fused context, greedy tokens equal (reported): " + "; ".join(fused_vs_unfused),
          flush=True)
    prof = profile_decode(tp, prompts[1], label="tp = 2 sharded decode step")
    if prof:
        print(f"  tp = 2 sharded decode step: wall {prof['wall_ms']:.3f} ms, device "
              f"{prof['device_ms']:.3f} ms, idle share {prof['idle']:.3f} (one card: not a "
              f"scaling number)", flush=True)
    del tp, ref, one
    torch.cuda.empty_cache()

    parallel_held(cfg, w, "bf16 KV", "none", BF16_PATH)
    parallel_held(cfg, w, "q8 KV", "q8", BF16_PATH - {"flash_attention"} | {"flash_attention_q8"})
    torch.cuda.empty_cache()
    parallel_dense_witness()
    torch.cuda.empty_cache()
    parallel_engine(cfg, llama.unfused(cfg, w))
    torch.cuda.empty_cache()
    parallel_pipeline(cfg, w)
    plain, dist = (_verb_wait(h).strip().splitlines() for h in verbs)
    if not plain or plain[-1] != dist[-1]:
        raise AssertionError(f"generate through one NCCL process: {dist[-1:]} against plain "
                             f"{plain[-1:]}")
    print(f"  generate through one NCCL process (--dist-coordinator, --dist-procs 1): the text "
          f"of plain generate ({plain[-1]!r})", flush=True)
    print(f"  phase 21 took {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 22: the SPMD train step (parallel/train_step.py) on one card
# ---------------------------------------------------------------------------

TRAIN_MESH_LAYERS = 12          # phase 10's cut of qwen3-4b's 36 layers
TRAIN_MESH_STEPS = 3            # AdamW steps on one repeated T = 256 batch, then one at T = 8
TRAIN_MESH_EXPECT = {"tcq4_matmul_i8p", "tcq4_matmul_gx2", "q8_matmul"}
# the held gradient check (phase 3's dense bf16 2-layer model): the step-0
# loss against one device's (absolute) and each leaf's joined gradient
# against one device's over each dp row's rows (rel L2). The mesh sums each
# replicated bf16 activation's gradient from per-shard parts, each rounded
# to bf16, where one device rounds the whole once
MESH_LOSS_TOL = 1e-3
MESH_GRAD_TOL = 5e-2
# the clipped step: the update's norm against lr x clip (relative); the
# joined parameters f32, so p + u rounds at ~6e-8 of a weight near 1
MESH_CLIP_TOL = 1e-4
# the ep axis at Qwen3-30B-A3B's published widths (2 layers, dense f32 stacks)
QWEN3_30B_A3B_WIDTHS = dict(arch="qwen3moe", n_embd=2048, n_heads=32, n_kv_heads=4,
                            head_dim=128, n_ff=0, n_experts=128, n_experts_used=8,
                            n_ff_exp=768, vocab_size=151936, context_length=4096,
                            rope_theta=1e6, qk_norm=True, norm_topk_prob=True)


def mesh_batch(vocab: int, t: int, rows: int, seed: int):
    """[rows, t + 1]: ``training_batch``'s block for each row, seeds seed ..."""
    import numpy as np

    return np.concatenate([training_batch(vocab, t, seed=seed + i) for i in range(rows)])


def single_grads(cfg, w, batch, dp: int):
    """One device's loss and gradients over each dp row's rows (the mesh's
    M, so the same kernel routes), the rows' losses averaged: (loss, flat
    {position: gradient})."""
    import numpy as np
    import torch

    from rrs_tpu_torch.parallel.train_step import _flat
    from rrs_tpu_torch.train import finetune as ft

    params, static, _ = ft.trainable(w)
    loss = 0.0
    for rows in np.split(batch, dp):
        part = ft._loss_fn(cfg, ft.combine(params, static), rows) / dp
        part.backward()
        loss += float(part.detach())
    grads = {i: (torch.zeros_like(p) if p.grad is None else p.grad).float().cpu()
             for i, p in enumerate(_flat(params)) if isinstance(p, torch.Tensor)}
    return loss, grads


def mesh_grads(cfg, w, devices, dp: int, ep: int, batch, tc=None):
    """One step of the SPMD train step (SGD at lr 0 unless ``tc``): (loss,
    flat {position: joined gradient}, the step's parameters)."""
    import torch

    from rrs_tpu_torch.parallel import train_step as ts
    from rrs_tpu_torch.train.finetune import TrainConfig

    mesh = ts.make_train_mesh(devices=devices, dp=dp, ep=ep)
    step, params, _, opt = ts.make_sharded_train_step(
        cfg, mesh, w, tc or TrainConfig(optimizer="sgd", lr=0.0))
    _, _, loss = step(params, opt, batch)
    grads = {i: g.float() for i, g in enumerate(ts._flat(params.joined_grads()))
             if isinstance(g, torch.Tensor)}
    return float(loss), grads, params


def train_mesh_grads_held(dev: str = "cuda:0") -> None:
    """Phase 22 (b): phase 3's dense bf16 2-layer model (E 1,024) at tp = 2
    and dp 2 x tp 2, and a dense-expert qwen3moe of its width in f32 (8
    experts x 512, top-2) at dp 2 x ep 2 x tp 2, shards on ``dev``: one step's loss
    within MESH_LOSS_TOL of one device's, each leaf's joined gradient within
    MESH_GRAD_TOL (rel L2) of one device's over each dp row, and at dp 2 a
    second fresh mesh's loss and gradients bit-equal to the first's; then a clipped
    SGD step of the f32 copy of each model at dp 2 (x ep 2) x tp 2, clip at
    half the global gradient norm: the update's norm is lr x clip within
    MESH_CLIP_TOL (a norm over a shard's pieces, or a replicated piece
    counted once a shard, scales it otherwise)."""
    import dataclasses

    import torch

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.parallel.train_step import _flat
    from rrs_tpu_torch.train.finetune import TrainConfig, _is_float, _tree_map

    dense = small_cfg()
    moe_cfg = dataclasses.replace(dense, arch="qwen3moe", n_ff=0, n_experts=8, n_experts_used=2,
                                  n_ff_exp=512, norm_topk_prob=True)
    # the expert stacks in f32, as JAX's own test holds them: in bf16 a
    # router logit's last-bit difference re-routes a token near a tie
    models = {"dense": (dense, llama.random_weights(dense, seed=1, device=dev)),
              "qwen3moe": (moe_cfg, llama.random_weights(moe_cfg, seed=2, dtype=torch.float32,
                                                         device=dev))}
    batch = mesh_batch(dense.vocab_size, 64, 2, seed=22)
    for label, name, n, dp, ep in (("tp = 2", "dense", 2, 1, 1), ("dp 2 x tp 2", "dense", 4, 2, 1),
                                   ("dp 2 x ep 2 x tp 2", "qwen3moe", 8, 2, 2)):
        cfg, w = models[name]
        t0 = time.perf_counter()
        loss, got, _ = mesh_grads(cfg, w, [dev] * n, dp, ep, batch)
        ref_loss, ref = single_grads(cfg, w, batch, dp)
        worst, at = max((((got[i].cpu() - g).norm() / g.norm().clamp_min(1e-30)).item(), i)
                        for i, g in ref.items())
        if n > 2:
            # run to run: a fresh mesh after the calling thread's own autograd
            # work (one device's step) gives the same loss and gradients, bit
            # for bit (four or eight shards' parts of a replicated leaf)
            again, got2, _ = mesh_grads(cfg, w, [dev] * n, dp, ep, batch)
            same = again == loss and all(torch.equal(got2[i], g) for i, g in got.items())
            print(f"  held gradients, {name}, {label}, run again on a fresh mesh: loss and "
                  f"{len(got)} joined gradients bit-equal {same}", flush=True)
            if not same:
                raise AssertionError(f"held gradients, {name} {label}: a second run differs "
                                     f"(loss {again} / {loss})")
        dt = str(w.final_norm.dtype).replace("torch.", "")
        print(f"  held gradients, {name} ({cfg.n_layers} layers, E {cfg.n_embd}, {dt}), {label} "
              f"on {dev}: loss {loss:.6f} against one device's {ref_loss:.6f} (|diff| "
              f"{abs(loss - ref_loss):.2e} <= {MESH_LOSS_TOL:.0e}); {len(ref)} leaves, worst "
              f"joined gradient rel L2 {worst:.2e} (leaf {at}) <= {MESH_GRAD_TOL:.0e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not (abs(loss - ref_loss) <= MESH_LOSS_TOL and worst <= MESH_GRAD_TOL):
            raise AssertionError(f"held gradients, {name} {label}: loss {loss} / {ref_loss}, "
                                 f"worst rel L2 {worst:.3e}")
    for label, name, n, ep in (("dp 2 x tp 2", "dense", 4, 1), ("dp 2 x ep 2 x tp 2", "qwen3moe", 8, 2)):
        cfg, w = models[name]
        w32 = _tree_map(lambda t: t.float() if _is_float(t) else t, w)
        _, ref = single_grads(cfg, w32, batch, 2)
        gnorm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in ref.values()))
        clip, lr = gnorm / 2, 0.1
        _, _, params = mesh_grads(cfg, w32, [dev] * n, 2, ep, batch,
                                  TrainConfig(optimizer="sgd", lr=lr, clip_norm=clip))
        moved = math.sqrt(sum(float(((a.double() - b.double().cpu()) ** 2).sum())
                              for a, b in zip(_flat(params.joined()), _flat(w32))
                              if isinstance(a, torch.Tensor)))
        rel = abs(moved - lr * clip) / (lr * clip)
        print(f"  clipped SGD step, {name} in f32, {label}: update norm {moved:.6e} against lr x "
              f"clip {lr * clip:.6e} (global norm {gnorm:.4e}, clip half of it; rel {rel:.2e} <= "
              f"{MESH_CLIP_TOL:.0e})", flush=True)
        if not rel <= MESH_CLIP_TOL:
            raise AssertionError(f"clipped step, {name} {label}: update norm {moved} against "
                                 f"{lr * clip}")


def train_mesh_full(cfg, w, reports, peaks, dev: str = "cuda:0") -> None:
    """Phase 22 (a) and (d): the SPMD train step at qwen3-4b's full width,
    its first TRAIN_MESH_LAYERS layers in f32 floats (frozen codes shared),
    split back per projection: TRAIN_MESH_STEPS AdamW steps at lr TRAIN_LR on
    one repeated T = 256 batch (a row a dp row), then one at T = 8, at tp = 2
    (two shards on cuda:0) and at dp 2 x tp 2 (four), every launch on each
    shard held to its plain version; the losses finite and falling, every
    frozen piece equal to the caller's slice, B5 / B1 / B2 launched and B3
    not, the launches by shard. Then one unheld T = 256 step at tp = 2 under
    torch.profiler: wall, device busy, idle share, kernels, peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.parallel import train_step as ts
    from rrs_tpu_torch.train.finetune import TrainConfig

    w32 = llama.unfused(cfg, f32_floats(w))
    counted = {}
    for label, n, dp in (("tp = 2", 2, 1), ("dp 2 x tp 2", 4, 2)):
        t0 = time.perf_counter()
        step, params, static, opt = ts.make_sharded_train_step(
            cfg, ts.make_train_mesh(devices=[dev] * n, dp=dp), w32, TrainConfig(lr=TRAIN_LR))
        b256 = mesh_batch(cfg.vocab_size, 256, dp, seed=20)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        kernels.reset_launches()
        for c in step.model.launches.values():
            c.clear()
        losses = []
        batches = [b256] * TRAIN_MESH_STEPS + [mesh_batch(cfg.vocab_size, 8, dp, seed=8)]
        with held_to_plain(f"SPMD train step, {label}", TRAIN_MESH_EXPECT) as seen:
            for b in batches:
                losses.append(float(step(params, opt, b)[2]))
        torch.cuda.synchronize()
        launches = {k: kernels.LAUNCHES[k] for k in TRAIN_MESH_EXPECT | {"tcq4_matmul",
                                                                         "flash_attention"}}
        by_shard = {",".join(map(str, k)): dict(v) for k, v in step.model.launches.items()}
        peak = torch.cuda.max_memory_allocated() / GB
        frozen = frozen_pieces_kept(params.weights, static)
        print(f"  SPMD train step, {label} on {dev}, qwen3-4b {cfg.n_layers} of 36 layers: "
              f"AdamW at lr {TRAIN_LR}, T = 256 x {TRAIN_MESH_STEPS} then T = 8: losses "
              f"{[round(x, 4) for x in losses]}; {time.perf_counter() - t1:.1f} s held (set-up "
              f"{t1 - t0:.1f} s), peak memory {peak:.2f} GB", flush=True)
        print(f"  {label} launches {launches}; by shard (dp row, ep rank, tp rank): {by_shard}",
              flush=True)
        print(f"  {label} held to the plain versions on every shard: " + ", ".join(
            f"{k} (worst rel {v[0]:.2e}, shapes {sorted(v[1])})" for k, v in sorted(seen.items())),
            flush=True)
        if not (all(math.isfinite(x) for x in losses) and losses[TRAIN_MESH_STEPS - 1] < losses[0]):
            raise AssertionError(f"SPMD train step, {label}: losses {losses}")
        if launches["flash_attention"] or not all(launches[k] for k in TRAIN_MESH_EXPECT):
            raise AssertionError(f"SPMD train step, {label}: launches {launches}")
        if len(by_shard) != n or not all(v.get("q8_matmul") for v in by_shard.values()):
            raise AssertionError(f"SPMD train step, {label}: launches by shard {by_shard}")
        print(f"  {label}: every frozen piece on the card ({frozen} of them: TCQ4 codes, i8p "
              f"packs, the Q8 head's codes) equal to the caller's slice it was cut from",
              flush=True)
        for k, v in launches.items():
            counted[k] = counted.get(k, 0) + v
        if dp == 1:
            step(params, opt, b256)                                 # unheld warm-up
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            step(params, opt, b256)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t2) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(params, opt, b256)
                torch.cuda.synchronize()
            events, by_name = device_ms_by_kernel(prof)
            busy = sum(by_name.values())
            if events:
                top = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                    by_name.items(), key=lambda kv_: -kv_[1])[:5])
                print(f"  SPMD train step profile, tp = 2 (two shards on one card: not a scaling "
                      f"number), T = 256: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle "
                      f"share {1 - busy / wall:.3f}, {len(events)} kernels, peak memory "
                      f"{peak:.2f} GB (phase 20's line: one device's step); device ms by kernel: "
                      f"{top}", flush=True)
            else:
                print(f"  SPMD train step profile, tp = 2: wall {wall:.2f} ms; the profiler "
                      f"recorded no device time (not measured)", flush=True)
        del step, params, static, opt
        gc.collect()
        torch.cuda.empty_cache()
        if dp > 1:
            # run to run: a fresh mesh, unheld, the same steps give the same
            # losses, bit for bit
            t2 = time.perf_counter()
            step, params, _, opt = ts.make_sharded_train_step(
                cfg, ts.make_train_mesh(devices=[dev] * n, dp=dp), w32, TrainConfig(lr=TRAIN_LR))
            again = [float(step(params, opt, b)[2]) for b in batches]
            print(f"  {label}, run again on a fresh mesh, unheld: losses "
                  f"{[round(x, 4) for x in again]}, bit-equal {again == losses} "
                  f"({time.perf_counter() - t2:.1f} s)", flush=True)
            if again != losses:
                raise AssertionError(f"SPMD train step, {label}: a second run's losses {again} "
                                     f"differ from {losses}")
            del step, params, opt
            gc.collect()
            torch.cuda.empty_cache()
    for key, name in (("i8p", "tcq4_matmul_i8p"), ("gx2", "tcq4_matmul_gx2"), ("q8", "q8_matmul")):
        reports[key].entry["launches_train_mesh"] = counted[name]


def frozen_pieces_kept(sharded, static) -> int:
    """Each distinct integer tensor of the shards' frozen leaves against the
    caller's slice it was cut from (``ShardedWeights.views``): raises where
    one differs; returns how many were compared."""
    import torch

    from rrs_tpu_torch.parallel.train_step import _flat

    seen = set()
    for (d, e, r), tree in static.items():
        for x, v in zip(_flat(tree), _flat(sharded.views[(e, r)])):
            if isinstance(x, torch.Tensor) and id(x) not in seen:
                seen.add(id(x))
                if not torch.equal(x, v.to(x.device)):
                    raise AssertionError(f"a frozen piece of shard {(d, e, r)} changed")
    return len(seen)


def qwen3moe_dense_f32(cfg, seed: int, device: str = "cuda"):
    """A qwen3moe of ``cfg``'s widths as a file loaded with f32 floats holds
    it, drawn on the device from a seeded ``torch.Generator``: dense f32
    projections, router and expert stacks N(0, 0.02), an untied dense head,
    norms of ones."""
    import torch

    from rrs_tpu_torch.models.linear import DenseLinear
    from rrs_tpu_torch.models.llama import LayerWeights, ModelWeights
    from rrs_tpu_torch.models.moe import MoEWeights

    gen = torch.Generator(device=device).manual_seed(seed)
    e, f, n_exp = cfg.n_embd, cfg.n_ff_exp, cfg.n_experts

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    ones = lambda n: torch.ones((n,), device=device)                # noqa: E731
    layers = [LayerWeights(
        attn_norm=ones(e), ffn_norm=ones(e), wq=DenseLinear(w=normal(e, cfg.n_q_dim)),
        wk=DenseLinear(w=normal(e, cfg.n_kv_dim)), wv=DenseLinear(w=normal(e, cfg.n_kv_dim)),
        wqkv=None, wo=DenseLinear(w=normal(cfg.n_q_dim, e)), q_norm=ones(cfg.head_dim),
        k_norm=ones(cfg.head_dim), w_gate=None, w_up=None, w_down=None,
        moe=MoEWeights(router=normal(e, n_exp), gate=normal(n_exp, e, f), up=normal(n_exp, e, f),
                       down=normal(n_exp, f, e)))
        for _ in range(cfg.n_layers)]
    return ModelWeights(embed=normal(cfg.vocab_size, e), layers=layers, final_norm=ones(e),
                        lm_head=DenseLinear(w=normal(e, cfg.vocab_size)))


def train_mesh_ep(dev: str = "cuda:0") -> None:
    """Phase 22 (c): the ep axis at Qwen3-30B-A3B's published widths (E
    2,048, 32 / 4 heads x 128, 128 experts x 768, top-8), 2 layers with dense
    f32 expert stacks, ep 2 x tp 2 on cuda:0: the step-0 loss against one
    device's on the same weights (reported), three AdamW steps on one
    repeated T = 128 batch, the loss falling."""
    import torch

    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.parallel import train_step as ts
    from rrs_tpu_torch.train import finetune as ft

    cfg = ModelConfig(n_layers=2, **QWEN3_30B_A3B_WIDTHS)
    t0 = time.perf_counter()
    w = qwen3moe_dense_f32(cfg, seed=23, device=dev)
    experts = sum(t.numel() * 4 for lw in w.layers for t in (lw.moe.gate, lw.moe.up, lw.moe.down))
    batch = mesh_batch(cfg.vocab_size, 128, 1, seed=24)
    with torch.no_grad():
        ref = float(ft._loss_fn(cfg, w, batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    step, params, _, opt = ts.make_sharded_train_step(
        cfg, ts.make_train_mesh(devices=[dev] * 4, ep=2), w, ft.TrainConfig(lr=TRAIN_LR))
    losses = [float(step(params, opt, batch)[2]) for _ in range(3)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / GB
    print(f"  Qwen3-30B-A3B widths, 2 layers, dense f32 expert stacks ({experts / GB:.2f} GB), ep 2 "
          f"x tp 2 on {dev} ({cfg.n_experts // 2} experts x {cfg.n_ff_exp // 2} columns a shard): "
          f"step-0 loss {losses[0]:.6f} "
          f"against one device's {ref:.6f} (|diff| {abs(losses[0] - ref):.2e}, reported); AdamW "
          f"losses {[round(x, 4) for x in losses]}; {time.perf_counter() - t1:.1f} s (weights and "
          f"one device's loss {t1 - t0:.1f} s), peak memory {peak:.2f} GB", flush=True)
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"ep at Qwen3-30B-A3B widths: losses {losses}")
    del step, params, opt, w


def phase_train_mesh(cfg_full, weights_full, reports, peaks) -> None:
    """Phase 22 on phase 3's qwen3-4b weights: (a) and (d) at full width,
    TRAIN_MESH_LAYERS layers; (b) the held gradients; (c) the ep axis."""
    import torch

    t0 = time.perf_counter()
    train_mesh_full(*first_layers(cfg_full, weights_full, TRAIN_MESH_LAYERS), reports, peaks)
    t1 = time.perf_counter()
    train_mesh_grads_held()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    train_mesh_ep()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 22 took {time.perf_counter() - t0:.1f} s (full width {t1 - t0:.1f} s, the held "
          f"gradients {t2 - t1:.1f} s, the ep axis {time.perf_counter() - t2:.1f} s)", flush=True)


def header(text: str) -> None:
    """A phase's header line, with the seconds since the script started."""
    print(f"{text} (at {time.perf_counter() - T_START:.0f} s)", flush=True)


def main() -> int:
    from pathlib import Path

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.device import set_matmul_precision

    set_matmul_precision()
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"[device] {name}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; peaks {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} TFLOP/s bf16, {peaks[2] / 1e12:.0f} TOP/s int8", flush=True)

    header("[1/23] build")
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    print(f"  built {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    from rrs_tpu_torch import native

    t0 = time.perf_counter()
    if native.build() is None or not native.available():
        raise AssertionError("the native host codec (rrs_tpu_torch/csrc/rrs_core.cpp) did not "
                             "build with g++")
    print(f"  built the native host codec {native.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    header("[2/23] kernel parity at the qwen3-4b main-path shapes")
    reports = phase_parity(peaks)
    phase_i8p(peaks, reports)
    phase_parity_kvq(peaks, reports)
    phase_variants()

    header("[3/23] main path: small-model references, the q4 halves path, then generate at "
           "qwen3-4b width over bf16, q8 and q4 KV")
    phase_small_reference(reports)
    cfg, weights = phase_main_path(reports)
    phase_generate_kvq(cfg, weights, reports)

    header("[4/23] serving at qwen3-4b width, 4 slots, ctx 4096")
    ctx = phase_serving(cfg, weights, reports)

    header("[5/23] served steps held to the plain versions; device decode run against "
           "step-by-step decode")
    phase_served_steps_held(ctx)
    phase_decode_run_check(ctx)
    del ctx
    torch.cuda.empty_cache()

    header("[6/23] served steps over q8 and q4 KV, stores held to the CPU's")
    phase_served_steps_kvq(cfg, weights)

    header("[7/23] serving with --cache-type q4 (12 of 36 layers): slot save / erase / "
           "restore, context shift, a q4 decode-run profile")
    ctx = phase_serving_q4(*first_layers(cfg, weights, SERVE_Q4_LAYERS), reports)
    shift_held(ctx, "qwen3-4b")
    phase_q4_decode_profile(ctx)
    del ctx
    gc.collect()                        # engine threads and servers hold reference cycles
    torch.cuda.empty_cache()

    header("[8/23] integer decode kernels B14-B16, the RRS_GX3 A/B, and the measuring verbs "
           "(bench, batched-bench, perplexity) at qwen3-4b width")
    t8 = time.perf_counter()
    phase_parity_int(peaks, reports)
    phase_gx3_ab(*first_layers(cfg, weights, GX3_AB_LAYERS), reports)
    phase_perplexity(cfg, weights)
    torch.cuda.empty_cache()
    phase_verbs(name)
    print(f"  phase 8 took {time.perf_counter() - t8:.1f} s", flush=True)

    header("[9/23] B17 (fused) and B18 (paired-bias) at qwen3-4b shapes, then held on every "
           "TCQ4 linear of a 512-token prefill chunk")
    t9 = time.perf_counter()
    phase_parity_extra(peaks, reports)
    phase_prefill_extra(cfg, weights, reports)
    print(f"  phase 9 took {time.perf_counter() - t9:.1f} s", flush=True)

    header("[10/23] the rest of the server at qwen3-4b width (12 of 36 layers): grammar, JSON "
           "schema, embeddings, rerank, infill, /v1/messages, the web UI; speculative and "
           "prompt-lookup decoding")
    phase_server_rest(*first_layers(cfg, weights, SERVER_REST_LAYERS), reports)
    gc.collect()
    torch.cuda.empty_cache()

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, ignore_cleanup_errors=True) as tmp_name:
        header("[20/23] training, run here on phase 3's qwen3-4b weights: the finetune verb at "
               "Qwen3-0.6B's widths and phase 21's two generate processes started; 2 layers "
               "with every launch held, the backwards and a dense model's AdamW steps card vs "
               "CPU; train() at 12 of 36 layers")
        verbs = parallel_verbs_start(Path(tmp_name))
        finetune = phase_training(cfg, weights, reports, peaks, Path(tmp_name))
        gc.collect()
        torch.cuda.empty_cache()

        header("[21/23] the parallel paths on phase 3's qwen3-4b weights (6 of 36 layers): tp = "
               "2 as two shards on cuda:0, held launches and reduces, tp 2 x dp 2 serving, the "
               "pipeline's perplexity, one NCCL process")
        phase_parallel(cfg, weights, reports, verbs)
        gc.collect()
        torch.cuda.empty_cache()

        header("[22/23] the SPMD train step on phase 3's qwen3-4b weights (12 of 36 layers): tp "
               "= 2 and dp 2 x tp 2 on cuda:0 with every launch held; gradients held to one "
               "device's at tp = 2, dp 2 x tp 2 and dp 2 x ep 2 x tp 2; ep 2 x tp 2 at "
               "Qwen3-30B-A3B's widths")
        phase_train_mesh(cfg, weights, reports, peaks)

        header("[20/23, continued] the finetune verb's result")
        t0 = time.perf_counter()
        training_verb_finish(finetune)
        print(f"  the verb's wait and reload {time.perf_counter() - t0:.1f} s", flush=True)
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  qwen3-4b phases done: {torch.cuda.memory_allocated() / GB:.2f} GB still allocated",
          flush=True)

    header("[11/23] gpt-oss-20b: MXFP4 kernel parity, a 2-layer model against the CPU, "
           "generate (6 of 24 layers), serving and held served steps")
    phase_parity_gptoss(peaks, reports)
    phase_gptoss_small_reference()
    cfg, weights = phase_gptoss_generate(reports)
    ctx = phase_serving_gptoss(cfg, weights, reports)
    phase_gptoss_served_steps(ctx)
    del ctx, weights
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  gpt-oss phases done: {torch.cuda.memory_allocated() / GB:.2f} GB still allocated",
          flush=True)

    header("[12/23] Qwen3-30B-A3B: TCQ4 expert kernel parity (B9, B10, B19), a 2-layer model "
           "against the CPU, generate, serving and held served steps")
    phase_parity_qwen3moe(peaks, reports)
    phase_qwen3moe_small_reference()
    cfg, weights = phase_qwen3moe_generate(reports)
    ctx = phase_serving_qwen3moe(cfg, weights, reports)
    kernels.reset_launches()
    with b19_diagonal("Qwen3-30B-A3B served steps") as held:
        served_steps_held(ctx, "Qwen3-30B-A3B",
                          {"tcq4_matmul_gx2", "tcq4_matmul_i8p", "q8_matmul", "flash_attention",
                           "tcq4_matmul_experts_rows"})
    n19 = kernels.LAUNCHES["tcq4_matmul_experts"]
    if held["n"] == 0 or n19 != held["n"]:
        raise AssertionError(f"Qwen3-30B-A3B served steps: {held['n']} B9 launches held, "
                             f"{n19} B19 launches")
    reports["tq_sel"].entry["held_launches"] = n19
    print(f"  Qwen3-30B-A3B served steps: every B9 launch ({held['n']}) also ran B19 on its "
          f"rows and ids, the diagonal within {held['rel']:.2e} of B9 (<= {QWEN3MOE_TOL:.0e}); "
          f"B19 shapes {sorted(held['shapes'])}", flush=True)
    del ctx, weights
    gc.collect()
    torch.cuda.empty_cache()

    header("[13/23] the GGUF pipeline at qwen3-4b widths: export, imatrix on the card, "
           "quantize (TCQ4 under imatrix permutations; Q4_K_M), gguf-split, generate, "
           "the model router, perplexity")
    t12 = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, ignore_cleanup_errors=True) as tmp_name:
        tmp = Path(tmp_name)
        # the Q4_K_M quantization goes on beside phase 14's card work
        q4_run, prompt = phase_gguf_pipeline(name, reports, tmp)
        phase_router(tmp / "tcq4.gguf")
        gc.collect()
        torch.cuda.empty_cache()
        t12 = time.perf_counter() - t12

        header("[14/23] Qwen2-57B-A14B: a 2-layer qwen2moe model against the CPU, generate at "
               "the published widths with the shared expert, held steps, its decode profile")
        t13 = time.perf_counter()
        phase_qwen2moe_small_reference()
        print(f"  small reference {time.perf_counter() - t13:.1f} s", flush=True)
        cfg, weights, ctx, prompts, sh_bytes = phase_qwen2moe_generate(reports)
        phase_qwen2moe_held(ctx, prompts)
        t13 = time.perf_counter() - t13

        header("[13/23, continued] the Q4_K_M file: generate, perplexity, card vs CPU")
        t0 = time.perf_counter()
        phase_gguf_q4km(q4_run, prompt, tmp)
        print(f"  phase 13 took {t12 + time.perf_counter() - t0:.1f} s in its two parts",
              flush=True)

    header("[14/23, continued] Qwen2-57B-A14B decode profiles, no verb process beside them")
    t0 = time.perf_counter()
    phase_qwen2moe_profile(cfg, weights, ctx, prompts, sh_bytes)
    del ctx, weights
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 14 took {t13 + time.perf_counter() - t0:.1f} s in its two parts", flush=True)

    header("[15/23] the attention families: tiny-mla and the dense families in 2 layers against "
           "the CPU, then DeepSeek-V2-Lite (MLA, 9 of 27 layers) and gemma3-4b (12 of 34) at "
           "their published widths")
    t15 = time.perf_counter()
    phase_families_small()
    phase_mla(reports)
    gc.collect()
    torch.cuda.empty_cache()
    phase_gemma3(reports)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 15 took {time.perf_counter() - t15:.1f} s", flush=True)

    header("[16/23] the recurrent families: Mamba, Falcon-Mamba, RWKV6 and Jamba in 2 layers "
           "against the CPU, then Falcon-Mamba-7B (16 of 64 layers), RWKV-6 7B (8 of 32) and "
           "Jamba-v0.1 (8 of 32) at their published widths")
    t16 = time.perf_counter()
    phase_recurrent(reports)
    print(f"  phase 16 took {time.perf_counter() - t16:.1f} s", flush=True)

    header("[17/23] the tool suite at Qwen3-4B's widths (2 of 36 layers): convert-hf from a "
           "BF16 checkpoint, quantize, tokenize, LoRA (export-lora; B5 / B4 / B1 + delta), "
           "cvector, quantize-stats, fit-params")
    t17 = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(dir=build, ignore_cleanup_errors=True) as tmp_name:
        phase_tools(reports, Path(tmp_name))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 17 took {time.perf_counter() - t17:.1f} s", flush=True)

    header("[18/23] vision: Qwen2-VL-2B at full width (28 text layers, the 32-layer tower): "
           "image encodes, generate_with_images, held steps, image parts on the server, a "
           "decode profile; the tower card vs CPU; 2-layer and projector checks; convert-hf "
           "--mmproj and serve --mmproj as processes")
    t18 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build, ignore_cleanup_errors=True) as tmp_name:
        phase_vision(reports, peaks, Path(tmp_name))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 18 took {time.perf_counter() - t18:.1f} s", flush=True)

    header("[19/23] audio and TTS: Ultravox v0.5 at full width (16 Llama-3.2-1B layers, the "
           "32-layer whisper-large-v3-turbo tower): audio encodes, multimodal_prefill, held "
           "steps, audio parts on the server, a decode profile; the tower card vs CPU; "
           "OuteTTS-0.2-500M (24 layers) with the full WavTokenizer: synthesize, held steps, a "
           "decode profile, the vocoder card vs CPU; serve --mmproj and tts as processes")
    t19 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build, ignore_cleanup_errors=True) as tmp_name:
        phase_audio(reports, peaks, Path(tmp_name))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 19 took {time.perf_counter() - t19:.1f} s", flush=True)

    header("[23/23] summary")
    order = ("gx2", "q8", "fa", "tcq4", "i8p", "fa_q8", "fa_q4hp", "fa_q4", "tq_rows", "tq_all",
             "mx_mm", "mx_rows", "mx_all", "gx3", "gx", "a8", "fused", "pb", "tq_sel")
    print(json.dumps({"kernels": [reports[k].entry for k in order]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_children()
