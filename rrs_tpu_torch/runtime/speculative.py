"""Speculative decoding: draft-model proposal + target verification.

Analog of common/speculative.cpp (common_speculative_gen_draft :185) and the
server's batch_spec path (server-context.cpp:2074+): a small draft model
proposes n tokens greedily; the target model scores all of them in ONE
batched step (that's the win: verification is a T=n+1 prefill, not n decode
steps); accepted prefix + one corrected token are kept, caches rolled back
to the accepted length.

Near-matching draft/target vocabularies are supported through
retokenization (the reference's common_speculative_are_compatible +
gen_draft translation path, common/speculative.cpp:89-262): when the
vocabs differ, token streams cross the boundary as TEXT — detokenized
through one vocab and re-tokenized through the other.

Port of ``rrs_tpu/runtime/speculative.py``. The contexts' logits are torch
tensors on their device; each greedy pick is one ``argmax`` read back. One
departure: after a round whose drafts were all accepted, the JAX package's
draft cache lacks the last proposal (proposed, never fed), so its next
round drafts from a stream one token short; here the draft is fed it.
"""

from __future__ import annotations

import dataclasses

import torch

from rrs_tpu_torch.runtime.context import InferenceContext

SPEC_VOCAB_MAX_SIZE_DIFFERENCE = 128   # common/speculative.cpp:13
SPEC_VOCAB_CHECK_START_TOKEN_ID = 5    # common/speculative.cpp:14


def speculative_are_compatible(v_tgt, v_dft) -> bool:
    """common_speculative_are_compatible (common/speculative.cpp:89-148):
    same vocab type, matching bos/eos + add_bos/add_eos, sizes within
    SPEC_VOCAB_MAX_SIZE_DIFFERENCE, and identical token text from
    SPEC_VOCAB_CHECK_START_TOKEN_ID up."""
    if v_tgt.model != v_dft.model:
        return False
    if (v_tgt.add_bos != v_dft.add_bos or v_tgt.add_eos != v_dft.add_eos
            or v_tgt.bos_id != v_dft.bos_id or v_tgt.eos_id != v_dft.eos_id):
        return False
    n_tgt, n_dft = len(v_tgt.tokens), len(v_dft.tokens)
    if abs(n_tgt - n_dft) > SPEC_VOCAB_MAX_SIZE_DIFFERENCE:
        return False
    for i in range(SPEC_VOCAB_CHECK_START_TOKEN_ID, min(n_tgt, n_dft)):
        if v_tgt.tokens[i] != v_dft.tokens[i]:
            return False
    return True


class VocabTranslator:
    """Target<->draft token translation for NEAR-matching vocabs (the
    gen_draft retokenization path, common/speculative.cpp:204-262).
    ``replacements`` are literal target->draft string substitutions
    (common_speculative_add_replacement_tgt_dft — e.g. differing special
    token spellings), applied in the target->draft direction and reversed
    coming back."""

    def __init__(self, v_tgt, v_dft, replacements: dict | None = None):
        self.v_tgt = v_tgt
        self.v_dft = v_dft
        self.replacements = dict(replacements or {})

    def tgt_to_dft(self, tokens: list[int]) -> list[int]:
        text = self.v_tgt.decode(list(tokens))
        for src, dst in self.replacements.items():
            text = text.replace(src, dst)
        return self.v_dft.encode(text, add_special=False,
                                 parse_special=True)

    def dft_to_tgt(self, tokens: list[int]) -> list[int]:
        text = self.v_dft.decode(list(tokens))
        for src, dst in self.replacements.items():
            text = text.replace(dst, src)
        return self.v_tgt.encode(text, add_special=False,
                                 parse_special=True)


@dataclasses.dataclass
class SpecStats:
    n_drafted: int = 0
    n_accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.n_accepted / max(self.n_drafted, 1)


def generate_speculative(
    target: InferenceContext,
    draft: InferenceContext,
    prompt: list[int],
    max_new_tokens: int,
    n_draft: int = 4,
    stop_tokens: tuple[int, ...] = (),
    translator: "VocabTranslator | None" = None,
) -> tuple[list[int], SpecStats]:
    """Greedy speculative generation. Returns (tokens, stats).

    ``translator``: pass a VocabTranslator when the draft model's vocab
    differs from the target's (speculative_are_compatible == False);
    the draft then runs on RETOKENIZED text and its proposals translate
    back to target ids before verification, with the draft cache reusing
    the longest common retokenized prefix each round
    (common_speculative_gen_draft, common/speculative.cpp:185-262)."""
    stats = SpecStats()
    t_seq = target.new_sequence()
    d_seq = draft.new_sequence()

    t_logits = target.prefill(t_seq, prompt)
    out: list[int] = []
    last = int(torch.argmax(t_logits[-1]))
    out.append(last)

    dft_hist: list[int] = []
    if translator is None:
        draft.prefill(d_seq, prompt)
        dft_hist = list(prompt)
    # with a translator the draft prompt is fed lazily inside the loop
    # (it depends on `last`, which must cross as text)

    def _sync_draft(tgt_stream: list[int]) -> None:
        """Bring the draft cache to the retokenized target stream,
        reusing the longest common prefix (prompt_dft tracking)."""
        nonlocal dft_hist
        want = translator.tgt_to_dft(tgt_stream)
        common = 0
        for a, b in zip(dft_hist, want):
            if a != b:
                break
            common += 1
        # the last common token's logits feed the first draft step, so
        # keep at most len(want)-1 in the cache
        common = min(common, len(want) - 1)
        if common < len(dft_hist):
            if common:
                draft.kv.seq_rm(d_seq, p0=common)
            else:
                draft.kv.seq_rm(d_seq)
                draft.kv.seq_new(d_seq)
            dft_hist = dft_hist[:common]
        if len(want) - 1 > len(dft_hist):
            draft.prefill(d_seq, want[len(dft_hist):-1], all_logits=False)
            dft_hist = want[:-1]
        return want[-1]

    while len(out) < max_new_tokens and last not in stop_tokens:
        # 1) draft proposes n tokens greedily from its own cache
        proposal = []
        if translator is None:
            cur = last
            for _ in range(n_draft):
                dl = draft.decode({d_seq: cur})[d_seq]
                cur = int(torch.argmax(dl))
                proposal.append(cur)
        else:
            cur = _sync_draft(prompt + out)
            dprop = []
            for _ in range(n_draft):
                dl = draft.decode({d_seq: cur})[d_seq]
                dft_hist.append(cur)
                cur = int(torch.argmax(dl))
                dprop.append(cur)
            proposal = translator.dft_to_tgt(dprop)[:n_draft]
            if not proposal:
                # untranslatable proposal: fall back to one target step
                logits = target.prefill(t_seq, [last])
                last = int(torch.argmax(logits[-1]))
                out.append(last)
                continue
        stats.n_drafted += len(proposal)

        # 2) target verifies [last, p0, .., p_{n-1}] in one chunked step
        verify = [last] + proposal
        logits = target.prefill(t_seq, verify)     # [n+1, V]

        want = torch.argmax(logits, dim=-1).tolist()
        accepted = []
        for i, p in enumerate(proposal):
            if want[i] == p:
                accepted.append(p)
            else:
                accepted.append(want[i])           # corrected token
                break
        else:
            # all accepted: also take the target's next token
            accepted.append(want[len(proposal)])
        stats.n_accepted += sum(
            1 for i, p in enumerate(proposal[: len(accepted)]) if accepted[i] == p
        )

        # 3) roll back caches: keep prompt + out + accepted[:-1] in the cache
        # (accepted[-1] is the next step's input, not yet fed anywhere)
        keep = len(prompt) + len(out) + len(accepted) - 1
        target.kv.seq_rm(t_seq, p0=keep)
        if translator is None:
            draft.kv.seq_rm(d_seq, p0=keep)
            # a round whose drafts were all accepted left the draft one token
            # short: it proposed its last token without feeding it
            short = keep - draft.kv.lengths[draft.kv.lane_of(d_seq)]
            if short > 0:
                draft.prefill(d_seq, proposal[len(proposal) - short:], all_logits=False)
        # translated mode: the draft cache is re-synced against the
        # retokenized target stream at the top of the next round

        for tok in accepted:
            out.append(tok)
            last = tok
            if last in stop_tokens or len(out) >= max_new_tokens:
                break

    target.kv.seq_rm(t_seq)
    draft.kv.seq_rm(d_seq)
    return out[:max_new_tokens], stats
