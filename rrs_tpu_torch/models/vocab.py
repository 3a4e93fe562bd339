"""Tokenizers: SPM (sentencepiece-style), byte-level BPE, BERT WordPiece,
T5 Unigram, PLaMo-2 and the RWKV world tokenizer, from GGUF vocab.

Host code copied from ``rrs_tpu/models/vocab.py`` (every tokenizer model of
the JAX package: ``llama`` SPM, ``gpt2`` BPE, ``bert`` WPM, ``t5`` /
``unigram`` UGM, ``plamo2`` and ``rwkv``), with the native BPE merge loop of
``rrs_tpu_torch.native`` where it builds, and the grammar slice's ``pieces``
and ``token_trie``. Behaviour of src/llama-vocab.cpp:
  * SPM (llm_tokenizer_spm): utf-8 symbols, best-score bigram merging with a
    priority queue, byte fallback <0xXX>, space -> U+2581 escaping.
  * BPE (llm_tokenizer_bpe): per-model pretokenizer regex (tokenizer.ggml.pre),
    GPT-2 byte-to-unicode mapping, lowest-rank pair merging from
    tokenizer.ggml.merges.
  * WPM (llm_tokenizer_wpm): NFD + lowercase, punctuation / CJK isolated,
    greedy longest match per "▁"-prefixed word, UNK for a word that fails.
  * UGM (llm_tokenizer_ugm): Viterbi over the piece scores with an UNK
    penalty; the first text fragment takes the space prefix.
  * PLaMo-2 (llm_tokenizer_plamo2): Viterbi over rounded scores with a
    <0xXX> byte fallback.
  * RWKV (llm_tokenizer_rwkv): greedy longest match on the raw token
    strings; decoding joins them as text.
  * Special-token partitioning before either algorithm (tokenizer_st_partition).
"""

from __future__ import annotations

import dataclasses
import heapq
from functools import lru_cache
from typing import Any, Mapping, Optional

try:
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re

SPIECE_UNDERLINE = "▁"

# token_type values (llama.h llama_token_type / gguf-py TokenType)
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6

# pretokenizer regexes keyed by tokenizer.ggml.pre (llama-vocab.cpp:279-480:
# pre string -> LLAMA_VOCAB_PRE_TYPE_* -> regex_exprs; flattened here to
# string -> regexes since the enum is an internal detail). Patterns use the
# `regex` module's \p{..} unicode categories — the role the reference's
# hand-rolled engine in src/unicode.cpp plays for C++.
_RE_LLAMA3 = r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
_RE_QWEN2 = r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
_RE_GPT2 = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
_RE_STARCODER = [r"\p{N}",
                 r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"]
_PRE_REGEX = {
    "llama3": [_RE_LLAMA3],
    "llama-v3": [_RE_LLAMA3],
    "llama-bpe": [_RE_LLAMA3],
    "falcon3": [_RE_LLAMA3],
    "pixtral": [_RE_LLAMA3],
    "dbrx": [_RE_LLAMA3],
    "smaug-bpe": [_RE_LLAMA3],
    "chatglm-bpe": [_RE_LLAMA3],
    "qwen2": [_RE_QWEN2],
    "stablelm2": [_RE_QWEN2],
    "hunyuan": [_RE_QWEN2],
    "grok-2": [_RE_QWEN2],
    "gpt-2": [_RE_GPT2],
    "mpt": [_RE_GPT2],
    "olmo": [_RE_GPT2],
    "jais": [_RE_GPT2],
    # ranges transcribed codepoint-exact from the C++ literals (several
    # chars there have confusable lookalikes, e.g. ώ vs ώ)
    "deepseek-llm": [
        r"[\r\n]",
        r"\s?[A-Za-z\u00b5\u00c0-\u00d6\u00d8-\u00f6\u00f8-\u01ba\u01bc-\u01bf\u01c4-\u0293\u0295-\u02af\u0370-\u0373\u0376\u0377\u037b-\u037d\u037f\u0386\u0388-\u038a\u038c\u038e-\u03a1\u03a3-\u03f5\u03f7-\u0481\u048a-\u052f\u0531-\u0556\u10a0-\u10c5\u13a0-\u13f5\u13f8-\u13fd\u1c90-\u1cba\u1cbd-\u1cbf\u1d00-\u1d2b\u1d6b-\u1d77\u1d79-\u1d9a\u1e00-\u1f15\u1f18-\u1f1d\u1f20-\u1f45\u1f48-\u1f4d\u1f50-\u1f57\u1f59\u1f5b\u1f5d\u1f5f-\u1f7d\u1f80-\u1fb4\u1fb6-\u1fbc\u1fbe\u1fc2-\u1fc4\u1fc6-\u1fcc\u1fd0-\u1fd3\u1fd6-\u1fdb\u1fe0-\u1fec\u1ff2-\u1ff4\u1ff6-\u1ffc\u2102\u2107\u210a-\u2113\u2115\u2119-\u211d\u2124\u2126\u2128\u212a-\u212d\u212f-\u2134\u2139\u213c-\u213f\u2145-\u2149\u214e\u2183\u2184\u2c00-\u2c7b\u2c7e-\u2ce4\u2ceb-\u2cee\u2cf2\u2cf3\ua640-\ua66d\ua680-\ua69b\ua722-\ua76f\ua771-\ua787\ua78b-\ua78e\uab70-\uabbf\ufb00-\ufb06\ufb13-\ufb17\uff21-\uff3a\uff41-\uff5a\U00010400-\U0001044f\U000104b0-\U000104d3\U000104d8-\U000104fb\U00010c80-\U00010cb2\U00010cc0-\U00010cf2\U000118a0-\U000118df\U0001e900-\U0001e943]+",
        r"\s?[!-/:-~\uff01-\uff0f\uff1a-\uff5e\u2018-\u201f\u3000-\u3002]+",
        r"\s+$",
        r"[一-龥ࠀ-一가-퟿]+",
        r"\p{N}+",
    ],
    "deepseek-coder": [
        r"[\r\n]",
        r"\s?\p{L}+",
        r"\s?\p{P}+",
        r"[一-龥ࠀ-一가-퟿]+",
        r"\p{N}",
    ],
    "deepseek-v3": [
        r"\p{N}{1,3}",
        r"[一-龥぀-ゟ゠-ヿ]+",
        r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "falcon": [
        r"[\p{P}\$\+<=>\^~\|`]+",
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)",
        r"[0-9][0-9][0-9]",
    ],
    "starcoder": _RE_STARCODER,
    "refact": _RE_STARCODER,
    "command-r": _RE_STARCODER,
    "smollm": _RE_STARCODER,
    "codeshell": _RE_STARCODER,
    "exaone": _RE_STARCODER,
    "minerva-7b": _RE_STARCODER,
    "tekken": [
        r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "gpt-4o": [
        r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "poro-chat": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "bloom": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "viking": [r" ?[^(\s|.,!?…。，、।۔،)]+", r"\p{N}"],
    "default": [
        r"[\p{P}\$\+<=>\^~\|]+",
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)",
        r"\p{N}+",
        r"[0-9][0-9][0-9]",
    ],
}

# pre types that look the whole pretokenized word up in the vocab before
# running merges (ignore_merges, llama-vocab.cpp:1863,1881,1954)
_IGNORE_MERGES_PRE = {
    "llama3", "llama-v3", "llama-bpe", "falcon3", "falcon-h1", "pixtral",
    "midm-2.0", "lfm2", "tekken", "youtu",
}


def _is_cjk(ch: str) -> bool:
    """CJK ranges (is_chinese_char, llama-vocab.cpp — mirrors HF BERT)."""
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _byte_encoder() -> dict[int, str]:
    """GPT-2 byte -> printable unicode char map (bytes_to_unicode)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@lru_cache(maxsize=1)
def _byte_decoder() -> dict[str, int]:
    return {v: k for k, v in _byte_encoder().items()}


@dataclasses.dataclass
class Vocab:
    model: str                        # "llama" (spm) | "gpt2" (bpe) | "none"
    tokens: list[str]
    scores: Optional[list[float]]
    token_types: Optional[list[int]]
    merges: Optional[list[str]]
    pre: str = "default"
    bos_id: int = -1
    eos_id: int = -1
    unk_id: int = -1
    pad_id: int = -1
    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = True
    # fill-in-the-middle special tokens (llama_vocab fim ids; /infill route)
    fim_pre_id: int = -1
    fim_suf_id: int = -1
    fim_mid_id: int = -1

    def __post_init__(self):
        self._token_to_id = {t: i for i, t in enumerate(self.tokens)}
        self._merge_ranks = {}
        if self.merges:
            for rank, m in enumerate(self.merges):
                a, sep, b = m.partition(" ")
                self._merge_ranks[(a, b)] = rank
        # (text, is_user_defined) pairs, longest-text first — the special
        # tokens cache (llama-vocab.cpp:2512-2524). USER_DEFINED tokens are
        # partitioned even when parse_special=false (tokenizer_st_partition
        # :2732-2738, the neox/mpt added-token rule); CONTROL/UNKNOWN only
        # when parse_special=true.
        self._specials = sorted(
            (
                (t, self.token_types[i] == TOKEN_TYPE_USER_DEFINED)
                for i, t in enumerate(self.tokens)
                if self.token_types is not None
                and self.token_types[i] in (TOKEN_TYPE_CONTROL,
                                            TOKEN_TYPE_USER_DEFINED,
                                            TOKEN_TYPE_UNKNOWN)
                and t
            ),
            key=lambda p: len(p[0].encode("utf-8")), reverse=True,
        )
        self._byte_tokens: dict[int, int] = {}
        if self.model in ("llama", "plamo2"):
            for b in range(256):
                tid = self._token_to_id.get(f"<0x{b:02X}>")
                if tid is not None:
                    self._byte_tokens[b] = tid

    # ------------------------------------------------------------------

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def pieces(self) -> list[str]:
        """Decoded text of every token id (cached); used by grammar masking."""
        if not hasattr(self, "_pieces"):
            self._pieces = [self.decode([i]) for i in range(len(self.tokens))]
        return self._pieces

    def token_trie(self) -> dict:
        """Character trie over pieces() (cached); grammar-mask accelerator."""
        if not hasattr(self, "_trie"):
            from rrs_tpu_torch.runtime.grammar import build_token_trie

            self._trie = build_token_trie(self.pieces())
        return self._trie

    def token_to_id(self, t: str) -> Optional[int]:
        return self._token_to_id.get(t)

    @staticmethod
    def from_gguf(md: Mapping[str, Any]) -> "Vocab":
        g = lambda k, d=None: md.get(f"tokenizer.ggml.{k}", d)
        tokens = list(g("tokens", []))
        scores = g("scores")
        ttypes = g("token_type")
        model = g("model", "llama")
        return Vocab(
            model=model,
            tokens=tokens,
            scores=None if scores is None else [float(s) for s in scores],
            token_types=None if ttypes is None else [int(t) for t in ttypes],
            merges=None if g("merges") is None else list(g("merges")),
            pre=str(g("pre", "default") or "default"),
            bos_id=int(g("bos_token_id", -1) if g("bos_token_id") is not None else -1),
            eos_id=int(g("eos_token_id", -1) if g("eos_token_id") is not None else -1),
            unk_id=int(g("unknown_token_id", -1) if g("unknown_token_id") is not None else -1),
            pad_id=int(g("padding_token_id", -1) if g("padding_token_id") is not None else -1),
            add_bos=bool(g("add_bos_token", model == "llama")),
            add_eos=bool(g("add_eos_token", False)),
            add_space_prefix=bool(g("add_space_prefix", model == "llama")),
            # new-style fim_* keys with legacy prefix/suffix/middle fallback
            fim_pre_id=int(g("fim_pre_token_id",
                             g("prefix_token_id", -1)) or -1),
            fim_suf_id=int(g("fim_suf_token_id",
                             g("suffix_token_id", -1)) or -1),
            fim_mid_id=int(g("fim_mid_token_id",
                             g("middle_token_id", -1)) or -1),
        )

    # -- encoding ------------------------------------------------------

    def encode(
        self,
        text: str,
        add_special: bool = True,
        parse_special: bool = True,
    ) -> list[int]:
        out: list[int] = []
        if add_special and self.add_bos and self.bos_id >= 0:
            out.append(self.bos_id)

        fragments = self._split_specials(text, parse_special)
        is_first = True
        for kind, frag in fragments:
            if kind == "special":
                out.append(self._token_to_id[frag])
                is_first = False
                continue
            if not frag:
                continue
            if self.model == "llama":
                raw = frag
                # llama.cpp prepends unconditionally on the first text fragment
                if self.add_space_prefix and is_first:
                    raw = " " + raw
                out.extend(self._encode_spm(raw))
            elif self.model == "gpt2":
                out.extend(self._encode_bpe(frag))
            elif self.model == "bert":
                out.extend(self._encode_wpm(frag))
            elif self.model in ("t5", "unigram"):
                raw = frag
                if is_first and self.add_space_prefix and raw and raw[0] != " ":
                    raw = " " + raw
                out.extend(self._encode_ugm(raw))
            elif self.model == "rwkv":
                out.extend(self._encode_rwkv(frag))
            elif self.model == "plamo2":
                out.extend(self._encode_plamo2(frag))
            else:
                raise NotImplementedError(f"tokenizer model {self.model!r}")
            is_first = False

        if add_special and self.add_eos and self.eos_id >= 0:
            out.append(self.eos_id)
        return out

    def _encode_wpm(self, text: str) -> list[int]:
        """BERT WordPiece (llm_tokenizer_wpm_session, llama-vocab.cpp:674):
        NFD + lowercase, isolate punctuation / ASCII symbols / CJK chars,
        then per word prepend the phantom "▁" and greedy longest-match over
        raw substrings (GGUF BERT vocabs use the ▁-prefix convention, not
        "##"); a word with any unmatched span collapses to UNK."""
        import unicodedata

        words: list[str] = [""]
        for ch in unicodedata.normalize("NFD", text):
            cat = unicodedata.category(ch)
            if ch.isspace():
                if words[-1]:
                    words.append("")
                continue
            if ord(ch) in (0, 0xFFFD) or cat.startswith("C") \
                    or cat.startswith("M"):
                # drop control chars and combining accent marks (uncased
                # BERT strip-accents; 'Äpfel' -> 'apfel')
                continue
            s = ch.lower()
            if cat.startswith("P") or (ord(ch) < 0x7F and cat.startswith("S")) \
                    or _is_cjk(ch):
                if words[-1]:
                    words.append("")
                words[-1] = s          # single-char word
                words.append("")
            else:
                words[-1] += s
        if words and not words[-1]:
            words.pop()

        if not hasattr(self, "_wpm_maxlen"):
            self._wpm_maxlen = max((len(t) for t in self.tokens if t),
                                   default=1)
        out: list[int] = []
        for word in words:
            if not word:
                continue
            word1 = SPIECE_UNDERLINE + word
            n = len(word1)
            start_len = len(out)
            i = 0
            while i < n:
                match = False
                for j in range(min(n, i + self._wpm_maxlen + 1), i, -1):
                    tid = self._token_to_id.get(word1[i:j])
                    if tid is not None:
                        out.append(tid)
                        i = j
                        match = True
                        break
                if not match:          # discard the whole word
                    del out[start_len:]
                    break
            if len(out) == start_len and self.unk_id >= 0:
                out.append(self.unk_id)
        return out

    def _encode_ugm(self, text: str) -> list[int]:
        """T5 Unigram (llm_tokenizer_ugm): Viterbi over log-prob piece
        scores; unknown bytes get the UNK penalty (score floor)."""
        text = text.replace(" ", SPIECE_UNDERLINE)
        n = len(text)
        if n == 0:
            return []
        scores = self.scores or [0.0] * len(self.tokens)
        min_score = min(scores) if scores else 0.0
        unk_score = min_score - 10.0
        max_len = max((len(t) for t in self.tokens), default=1)
        best = [float("-inf")] * (n + 1)
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            matched = False
            for end in range(i + 1, min(n, i + max_len) + 1):
                tid = self._token_to_id.get(text[i:end])
                if tid is None:
                    continue
                matched = True
                s = best[i] + scores[tid]
                if s > best[end]:
                    best[end] = s
                    back[end] = (i, tid)
            if not matched or best[i + 1] == float("-inf"):
                # single-char unknown fallback
                s = best[i] + unk_score
                if s > best[i + 1]:
                    best[i + 1] = s
                    back[i + 1] = (i, self.unk_id)
        ids: list[int] = []
        pos = n
        while pos > 0:
            i, tid = back[pos]
            if tid >= 0:
                ids.append(tid)
            pos = i
        ids.reverse()
        # merge consecutive UNKs (llm_tokenizer_ugm does)
        out: list[int] = []
        for t in ids:
            if t == self.unk_id and out and out[-1] == self.unk_id:
                continue
            out.append(t)
        return out

    def _encode_rwkv(self, text: str) -> list[int]:
        """RWKV world tokenizer (llm_tokenizer_rwkv): greedy longest match
        against the raw token strings; an unmatched character is the unknown
        token (or nothing without one)."""
        if not hasattr(self, "_rwkv_maxlen"):
            self._rwkv_maxlen = max((len(t) for t in self.tokens if t), default=1)
        out: list[int] = []
        i, n = 0, len(text)
        while i < n:
            end = min(n, i + self._rwkv_maxlen)
            tid = None
            while end > i:
                tid = self._token_to_id.get(text[i:end])
                if tid is not None:
                    break
                end -= 1
            if tid is None:
                if self.unk_id >= 0:
                    out.append(self.unk_id)
                i += 1
            else:
                out.append(tid)
                i = end
        return out

    def _encode_plamo2(self, text: str) -> list[int]:
        """PLaMo-2 tokenizer (llm_tokenizer_plamo2,
        llama-vocab.cpp:1242-1479): right-to-left Viterbi minimizing
        sum(-round(score * 1e4)) over vocab pieces, with a heavily
        penalized (UNKNOWN_SCORE = -1e7) single-codepoint fallback that
        emits <0xXX> byte tokens for the codepoint's UTF-8 bytes. The
        reference accelerates the per-position piece lookup with a
        reversed-suffix automaton table; this computes the same optimum
        with a direct bounded scan."""
        import math

        UNKNOWN = -10_000_000
        if not hasattr(self, "_plamo2_pieces"):
            pieces: dict[str, tuple[int, int]] = {}
            maxlen = 1
            for i, t in enumerate(self.tokens):
                tt = (self.token_types[i] if self.token_types
                      else TOKEN_TYPE_NORMAL)
                if tt == TOKEN_TYPE_BYTE or not t:
                    continue
                sc = self.scores[i] if self.scores else 0.0
                if not math.isfinite(sc):
                    continue                      # INVALID_SCORE rows
                pieces[t] = (i, int(round(sc * 1e4)))
                maxlen = max(maxlen, len(t))
            self._plamo2_pieces = pieces
            self._plamo2_maxlen = maxlen
        pieces, maxlen = self._plamo2_pieces, self._plamo2_maxlen

        if text and text[0] == "﻿":          # BOM skip
            text = text[1:]
        n = len(text)
        if n == 0:
            return []
        INF = 1 << 60
        scores = [INF] * (n + 1)
        scores[n] = 0
        best: list[tuple[int, int]] = [(1, -1)] * n   # (cp_len, token_id)
        for i in range(n - 1, -1, -1):
            # longest-first, strict improvement = the reference's table
            # order (prefix pieces in decreasing length, sentinel last)
            s_best = INF
            for ln in range(min(maxlen, n - i), 0, -1):
                info = pieces.get(text[i:i + ln])
                if info is None:
                    continue
                s = scores[i + ln] - info[1]
                if s < s_best:
                    s_best = s
                    best[i] = (ln, info[0])
            s_unk = scores[i + 1] - UNKNOWN
            if s_unk < s_best:
                s_best = s_unk
                best[i] = (1, -1)
            scores[i] = s_best

        out: list[int] = []
        pos = 0
        while pos < n:
            ln, tid = best[pos]
            if tid >= 0:
                out.append(tid)
            else:
                for b in text[pos].encode("utf-8"):
                    out.append(self._byte_tokens[b])
            pos += ln
        return out

    def _split_specials(self, text: str, parse_special: bool = True):
        """Greedy partition on special-token literals (tokenizer_st_partition).
        USER_DEFINED tokens always partition; CONTROL/UNKNOWN only when
        parse_special (llama-vocab.cpp:2732-2738)."""
        frags = [("text", text)]
        specials = [t for t, user in self._specials
                    if parse_special or user]
        if not specials:
            return frags
        for sp in specials:
            new = []
            for kind, frag in frags:
                if kind != "text" or sp not in frag:
                    new.append((kind, frag))
                    continue
                parts = frag.split(sp)
                for i, p in enumerate(parts):
                    if i:
                        new.append(("special", sp))
                    if p:
                        new.append(("text", p))
            frags = new
        return frags

    # SPM ---------------------------------------------------------------

    def _encode_spm(self, text: str) -> list[int]:
        text = text.replace(" ", SPIECE_UNDERLINE)
        symbols: list[list] = []  # [text, prev, next] with text="" when merged
        chars = list(text)
        for i, ch in enumerate(chars):
            symbols.append([ch, i - 1, i + 1 if i + 1 < len(chars) else -1])

        heap: list = []
        rev_merge: dict[str, tuple[int, int]] = {}
        counter = 0

        def try_add(left: int, right: int):
            nonlocal counter
            if left == -1 or right == -1:
                return
            cat = symbols[left][0] + symbols[right][0]
            tid = self._token_to_id.get(cat)
            if tid is None:
                return
            score = self.scores[tid] if self.scores else 0.0
            # max-heap on score; tie -> smaller left index (llm_bigram_spm cmp)
            heapq.heappush(heap, (-score, left, counter, right, len(cat)))
            counter += 1
            rev_merge[cat] = (left, right)

        for i in range(1, len(symbols)):
            try_add(i - 1, i)

        while heap:
            _, left, _, right, size = heapq.heappop(heap)
            ls, rs = symbols[left], symbols[right]
            if not ls[0] or not rs[0] or len(ls[0]) + len(rs[0]) != size:
                continue
            ls[0] = ls[0] + rs[0]
            rs[0] = ""
            ls[2] = rs[2]
            if rs[2] >= 0:
                symbols[rs[2]][1] = left
            try_add(ls[1], left)
            try_add(left, ls[2])

        out: list[int] = []

        def resegment(idx: int):
            text_i = symbols[idx][0]
            tid = self._token_to_id.get(text_i)
            if tid is not None:
                out.append(tid)
                return
            pair = rev_merge.get(text_i)
            if pair is None:
                for byte in text_i.encode("utf-8"):
                    bid = self._byte_tokens.get(byte)
                    out.append(bid if bid is not None else self.unk_id)
                return
            resegment(pair[0])
            resegment(pair[1])

        i = 0
        while i != -1:
            if symbols[i][0]:
                resegment(i)
            i = symbols[i][2]
        return out

    # BPE ---------------------------------------------------------------

    def _pre_split(self, text: str) -> list[str]:
        """Sequential regex splitting (unicode_regex_split, unicode.cpp:1015+):
        each pattern re-splits every fragment — matches AND gaps — from the
        previous stage."""
        words = [text]
        for pattern in _PRE_REGEX.get(self.pre, _PRE_REGEX["default"]):
            nxt: list[str] = []
            for w in words:
                pos = 0
                for m in _re.finditer(pattern, w):
                    if m.start() > pos:
                        nxt.append(w[pos : m.start()])
                    if m.group():
                        nxt.append(m.group())
                    pos = m.end()
                if pos < len(w):
                    nxt.append(w[pos:])
            words = nxt
        return words

    def _encode_bpe(self, text: str) -> list[int]:
        words = self._pre_split(text)

        enc = _byte_encoder()
        out: list[int] = []
        native_h = self._native_bpe_handle()
        ignore_merges = self.pre in _IGNORE_MERGES_PRE
        for word in words:
            frag = "".join(enc[b] for b in word.encode("utf-8"))
            if ignore_merges:
                # whole-word vocab hit bypasses merging (ignore_merges,
                # llama-vocab.cpp:540)
                tid = self._token_to_id.get(frag)
                if tid is not None:
                    out.append(tid)
                    continue
            if native_h is not None:
                from rrs_tpu_torch import native

                ids = native.bpe_encode(native_h, frag)
                if ids is not None:
                    out.extend(ids)
                    continue
            pieces = self._bpe_merge(list(frag))
            for p in pieces:
                tid = self._token_to_id.get(p)
                if tid is not None:
                    out.append(tid)
                else:
                    for ch in p:   # char-by-char fallback
                        tid = self._token_to_id.get(ch)
                        if tid is not None:
                            out.append(tid)
        return out

    def _native_bpe_handle(self):
        """The native BPE merge loop's session for this vocabulary, built at
        first use; None without merges or without the library (the Python
        loop below then merges)."""
        if not hasattr(self, "_bpe_native"):
            self._bpe_native = None
            if self.merges:
                from rrs_tpu_torch import native

                self._bpe_native = native.bpe_session(self.tokens, self.merges)
        return self._bpe_native

    def _bpe_merge(self, pieces: list[str]) -> list[str]:
        ranks = self._merge_ranks
        if not ranks:
            return pieces
        while len(pieces) > 1:
            best = None
            best_rank = None
            for i in range(len(pieces) - 1):
                r = ranks.get((pieces[i], pieces[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            pieces = pieces[:best] + [pieces[best] + pieces[best + 1]] + pieces[best + 2 :]
        return pieces

    # -- decoding ------------------------------------------------------

    def decode(self, ids: list[int], skip_special: bool = False) -> str:
        parts: list[bytes] = []
        for tid in ids:
            if tid < 0 or tid >= len(self.tokens):
                continue
            ttype = self.token_types[tid] if self.token_types else TOKEN_TYPE_NORMAL
            if ttype in (TOKEN_TYPE_CONTROL,) and skip_special:
                continue
            t = self.tokens[tid]
            if self.model == "llama":
                if ttype == TOKEN_TYPE_BYTE:
                    parts.append(bytes([int(t[3:5], 16)]))
                else:
                    parts.append(t.replace(SPIECE_UNDERLINE, " ").encode("utf-8"))
            elif self.model == "plamo2":
                # raw text pieces; <0xXX> byte tokens emit the byte
                # (llama-vocab.cpp:3162-3178)
                if ttype == TOKEN_TYPE_BYTE:
                    parts.append(bytes([int(t[3:5], 16)]))
                else:
                    parts.append(t.encode("utf-8"))
            elif self.model == "gpt2":
                if ttype in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED):
                    parts.append(t.encode("utf-8"))
                else:
                    dec = _byte_decoder()
                    parts.append(bytes(dec.get(c, ord(" ")) for c in t))
            else:
                parts.append(t.encode("utf-8"))
        return b"".join(parts).decode("utf-8", errors="replace")
