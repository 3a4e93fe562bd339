"""GBNF grammar-constrained sampling (llama-grammar.cpp analog).

Implements the llama.cpp GBNF dialect: rules of alternates, sequences,
literals, char classes/ranges with negation, rule references, grouping and
*/+/? repetition (expanded to auxiliary rules, as llama_grammar_parse does).

Runtime model mirrors llama_grammar: a set of possible parse stacks over
grammar positions; characters advance every stack; a token is admissible if
at least one stack survives all its characters. The usual llama.cpp sampling
trick applies (common_sampler: sample first, lazily build the full mask only
on rejection).

A copy of ``rrs_tpu/runtime/grammar.py``, word for word below this
paragraph: host code over plain Python, it imports nothing of either
package, so the port keeps its own copy of it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# element kinds
END = 0         # end of alternate
RULE = 1        # reference to rule id
CHAR = 2        # single char / start of class
CHAR_NOT = 3    # negated class
CHAR_ALT = 4    # additional alternative char in a class
CHAR_RNG = 5    # upper bound of a range (pairs with previous CHAR/CHAR_ALT)


@dataclasses.dataclass(frozen=True)
class Elem:
    kind: int
    value: int = 0    # rule id or codepoint


class GrammarParseError(ValueError):
    pass


class _Parser:
    """GBNF text -> rules: list[list[list[Elem]]] (rule -> alternates -> seq)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rule_ids: dict[str, int] = {}
        self.rules: dict[int, list[list[Elem]]] = {}

    def parse(self):
        while self._skip_ws() < len(self.text):
            self._parse_rule()
        if "root" not in self.rule_ids:
            raise GrammarParseError("grammar must define a 'root' rule")
        n = len(self.rule_ids)
        out = [[] for _ in range(n)]
        for rid, alts in self.rules.items():
            out[rid] = alts
        for name, rid in self.rule_ids.items():
            if not out[rid]:
                raise GrammarParseError(f"undefined rule {name!r}")
        return out, self.rule_ids["root"]

    # -- lexing helpers ----------------------------------------------------

    def _skip_ws(self):
        t = self.text
        while self.pos < len(t):
            c = t[self.pos]
            if c == "#":
                while self.pos < len(t) and t[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t\r\n":
                self.pos += 1
            else:
                break
        return self.pos

    def _skip_ws_inline(self):
        t = self.text
        while self.pos < len(t):
            c = t[self.pos]
            if c == "#":
                while self.pos < len(t) and t[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t":
                self.pos += 1
            elif c in "\r\n":
                # newline ends a rule unless continued
                break
            else:
                break
        return self.pos

    def _name(self) -> str:
        t = self.text
        start = self.pos
        while self.pos < len(t) and (t[self.pos].isalnum() or t[self.pos] in "-_"):
            self.pos += 1
        if self.pos == start:
            raise GrammarParseError(f"expected name at {start}: {t[start:start+20]!r}")
        return t[start : self.pos]

    def _rule_id(self, name: str) -> int:
        if name not in self.rule_ids:
            self.rule_ids[name] = len(self.rule_ids)
        return self.rule_ids[name]

    def _fresh_rule(self, base: str) -> int:
        i = 1
        while f"{base}_{i}" in self.rule_ids:
            i += 1
        return self._rule_id(f"{base}_{i}")

    def _char(self) -> int:
        """One (possibly escaped) char inside quotes/class."""
        t = self.text
        c = t[self.pos]
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = t[self.pos]
        self.pos += 1
        if e == "x":
            v = int(t[self.pos : self.pos + 2], 16)
            self.pos += 2
            return v
        if e == "u":
            v = int(t[self.pos : self.pos + 4], 16)
            self.pos += 4
            return v
        if e == "U":
            v = int(t[self.pos : self.pos + 8], 16)
            self.pos += 8
            return v
        return {"n": 10, "r": 13, "t": 9}.get(e, ord(e))

    # -- grammar structure -------------------------------------------------

    def _parse_rule(self):
        name = self._name()
        rid = self._rule_id(name)
        self._skip_ws()
        if not self.text.startswith("::=", self.pos):
            raise GrammarParseError(f"expected ::= after {name}")
        self.pos += 3
        self._skip_ws()
        self.rules[rid] = self._parse_alternates(name)

    def _parse_alternates(self, base: str, nested: bool = False) -> list[list[Elem]]:
        alts = [self._parse_sequence(base, nested)]
        while True:
            self._skip_ws() if nested else self._skip_ws_inline()
            if self.pos < len(self.text) and self.text[self.pos] == "|":
                self.pos += 1
                self._skip_ws()
                alts.append(self._parse_sequence(base, nested))
            else:
                break
        return alts

    def _parse_sequence(self, base: str, nested: bool) -> list[Elem]:
        seq: list[Elem] = []
        t = self.text
        while True:
            self._skip_ws() if nested else self._skip_ws_inline()
            if self.pos >= len(t):
                break
            c = t[self.pos]
            if c == '"':
                self.pos += 1
                while t[self.pos] != '"':
                    seq.append(Elem(CHAR, self._char()))
                self.pos += 1
            elif c == "[":
                self.pos += 1
                neg = t[self.pos] == "^"
                if neg:
                    self.pos += 1
                first = True
                while t[self.pos] != "]":
                    v = self._char()
                    kind = (CHAR_NOT if neg else CHAR) if first else CHAR_ALT
                    seq.append(Elem(kind, v))
                    first = False
                    if t[self.pos] == "-" and t[self.pos + 1] != "]":
                        self.pos += 1
                        seq.append(Elem(CHAR_RNG, self._char()))
                self.pos += 1
            elif c == "(":
                self.pos += 1
                sub = self._parse_alternates(base, nested=True)
                self._skip_ws()
                if t[self.pos] != ")":
                    raise GrammarParseError(f"expected ) at {self.pos}")
                self.pos += 1
                rid = self._fresh_rule(base)
                self.rules[rid] = sub
                seq.append(Elem(RULE, rid))
            elif c.isalnum() or c in "-_":
                save = self.pos
                name = self._name()
                # lookahead: "name ::=" starts a new rule
                save2 = self.pos
                self._skip_ws()
                if self.text.startswith("::=", self.pos):
                    self.pos = save
                    break
                self.pos = save2
                seq.append(Elem(RULE, self._rule_id(name)))
            else:
                break

            # repetition operators bind to the last element (or char class)
            self._maybe_repeat(seq, base)

            if not nested and self.pos < len(t) and t[self.pos] in "\r\n":
                break
        return seq

    def _last_group(self, seq: list[Elem]) -> list[Elem]:
        """Pop the trailing atomic unit (char class or single elem)."""
        i = len(seq) - 1
        if seq[i].kind in (CHAR_ALT, CHAR_RNG):
            while seq[i].kind in (CHAR_ALT, CHAR_RNG):
                i -= 1
        unit = seq[i:]
        del seq[i:]
        return unit

    def _maybe_repeat(self, seq: list[Elem], base: str):
        t = self.text
        if self.pos >= len(t) or t[self.pos] not in "*+?{":
            return
        op = t[self.pos]
        if op == "{":
            # {m}, {m,}, {m,n}
            self.pos += 1
            j = t.index("}", self.pos)
            body = t[self.pos : j]
            self.pos = j + 1
            if "," in body:
                lo_s, hi_s = body.split(",")
                lo = int(lo_s)
                hi = int(hi_s) if hi_s.strip() else -1
            else:
                lo = hi = int(body)
            unit = self._last_group(seq)
            for _ in range(lo):
                seq.extend(unit)
            if hi < 0:
                rid = self._fresh_rule(base)
                self.rules[rid] = [unit + [Elem(RULE, rid)], []]
                seq.append(Elem(RULE, rid))
            else:
                for _ in range(hi - lo):
                    rid = self._fresh_rule(base)
                    self.rules[rid] = [unit, []]
                    seq.append(Elem(RULE, rid))
            return
        self.pos += 1
        unit = self._last_group(seq)
        rid = self._fresh_rule(base)
        if op == "*":
            self.rules[rid] = [unit + [Elem(RULE, rid)], []]
            seq.append(Elem(RULE, rid))
        elif op == "+":
            self.rules[rid] = [unit + [Elem(RULE, rid)], unit]
            seq.append(Elem(RULE, rid))
        elif op == "?":
            self.rules[rid] = [unit, []]
            seq.append(Elem(RULE, rid))


def _class_matches(seq: list[Elem], i: int, ch: int) -> tuple[bool, int]:
    """Match char against the class starting at seq[i]; returns (ok, next_i)."""
    neg = seq[i].kind == CHAR_NOT
    found = False
    lo = seq[i].value
    j = i + 1
    if j < len(seq) and seq[j].kind == CHAR_RNG:
        found |= lo <= ch <= seq[j].value
        j += 1
    else:
        found |= ch == lo
    while j < len(seq) and seq[j].kind == CHAR_ALT:
        lo = seq[j].value
        j += 1
        if j < len(seq) and seq[j].kind == CHAR_RNG:
            found |= lo <= ch <= seq[j].value
            j += 1
        else:
            found |= ch == lo
    return (found != neg), j


def build_token_trie(pieces: list[str]) -> dict:
    """Character trie over token pieces: nested {ord(ch): subtrie} dicts;
    key -1 holds the list of token ids ending at that node. Build once per
    vocab (Vocab.token_trie caches)."""
    root: dict = {}
    for tid, piece in enumerate(pieces):
        if not piece:
            continue
        node = root
        for ch in piece:
            node = node.setdefault(ord(ch), {})
        node.setdefault(-1, []).append(tid)
    return root


class Grammar:
    """Push-down recognizer over parse stacks (llama_grammar semantics).

    ``lazy`` grammars (llama-grammar.h:119-143) buffer output unconstrained
    until a trigger token or regex pattern fires, then constrain from the
    match start — the tool-call-grammar enforcement mode."""

    def __init__(self, gbnf: str, lazy: bool = False,
                 trigger_tokens=(), trigger_patterns=(), trigger_words=()):
        import re as _re

        self.gbnf = gbnf
        self.rules, self.root = _Parser(gbnf).parse()
        # stack entries are (rule_id, alt_idx, pos); expand to frames of
        # remaining element tuples for hashability
        self.stacks: set[tuple] = set()
        for alt in self.rules[self.root]:
            self._push(tuple(), tuple(alt), self.stacks, set())
        self.lazy = bool(lazy)
        self.awaiting_trigger = bool(lazy)
        self.trigger_tokens = frozenset(trigger_tokens)
        self.trigger_patterns = [
            _re.compile(p, _re.S) for p in trigger_patterns
        ] + [_re.compile(_re.escape(w)) for w in trigger_words]
        self._trigger_buffer = ""

    # -- stack machinery ---------------------------------------------------

    def _push(self, below: tuple, seq: tuple, out: set, seen: set):
        """Advance over rule refs until the stack top is a char matcher."""
        key = (below, seq)
        if key in seen:
            return
        seen.add(key)
        if not seq:
            if below:
                self._push(below[:-1], below[-1], out, seen)
            else:
                out.add(tuple())          # accepted (empty stack)
            return
        el = seq[0]
        if el.kind == RULE:
            rest = seq[1:]
            # tail-call elimination: a rule ref in FINAL position resumes
            # directly in `below` — pushing an empty continuation frame
            # here made right-recursive rules (x+ / x*) grow the stack by
            # one dead frame per iteration, so PDA states never recurred
            # (defeating the mask memo) and _advance_char slowed linearly
            # with generation length (llama.cpp's llama_grammar stacks
            # are bounded the same way)
            below2 = below + (rest,) if rest else below
            for alt in self.rules[el.value]:
                self._push(below2, tuple(alt), out, seen)
        else:
            out.add(below + (seq,))

    def _advance_char(self, stacks: set, ch: int) -> set:
        out: set = set()
        seen: set = set()
        for st in stacks:
            if not st:
                continue
            seq = st[-1]
            ok, nxt = _class_matches(list(seq), 0, ch)
            if ok:
                self._push(st[:-1], tuple(seq[nxt:]), out, seen)
        return out

    # -- public API --------------------------------------------------------

    def accepts_text(self, text: str) -> bool:
        """Would the grammar allow this continuation (prefix acceptance)?"""
        stacks = self.stacks
        for ch in text:
            stacks = self._advance_char(stacks, ord(ch))
            if not stacks:
                return False
        return True

    def accept_text(self, text: str) -> bool:
        """Consume text, updating state. Returns False (state unchanged) if rejected."""
        stacks = self.stacks
        for ch in text:
            stacks = self._advance_char(stacks, ord(ch))
            if not stacks:
                return False
        self.stacks = stacks
        return True

    @property
    def done(self) -> bool:
        """True if the grammar can terminate here."""
        return tuple() in self.stacks

    @property
    def must_end(self) -> bool:
        return self.stacks == {tuple()}

    def feed_token(self, token: int, piece: str) -> None:
        """llama_grammar_accept_impl with lazy-trigger buffering
        (llama-grammar.cpp:1296-1344): while awaiting a trigger, output is
        buffered; a trigger token consumes just its own piece, a trigger
        pattern replays the buffer from the match start."""
        if self.awaiting_trigger:
            if token in self.trigger_tokens:
                self.awaiting_trigger = False
                self._trigger_buffer = ""
                self.accept_text(piece)
                return
            self._trigger_buffer += piece
            for rx in self.trigger_patterns:
                m = rx.search(self._trigger_buffer)
                if m:
                    self.awaiting_trigger = False
                    constrained = self._trigger_buffer[m.start():]
                    self._trigger_buffer = ""
                    self.accept_text(constrained)
                    return
            return
        self.accept_text(piece)

    def allowed_mask(self, token_texts: list[str], trie=None) -> list[bool]:
        """Admissibility of each candidate token.

        With a token ``trie`` (build_token_trie) the mask is computed by a
        prefix-sharing DFS with subtree pruning: a char that empties the
        stacks rejects every token sharing that prefix in one step —
        replacing the O(vocab x piece-walk) per-token loop that made
        grammar serving unusable at real vocab sizes (r1 weak-#7)."""
        if self.awaiting_trigger:
            return [True] * len(token_texts)
        if trie is None:
            return [bool(t) and self.accepts_text(t) for t in token_texts]
        # Memoize by PDA state: the mask is a pure function of (rules,
        # stacks), and generation revisits states constantly — a
        # self-looping rule like ``[a-z ]+`` has ONE mid-stream state, so
        # every violation resample after the first is O(1) instead of a
        # full-vocab trie walk (~4 s at 151k pieces — this walk was the
        # served-grammar bottleneck). The cache is shared across slot
        # copies (same rules object) and bounded.
        key = frozenset(self.stacks)
        cache = getattr(self, "_mask_cache", None)
        if cache is None:
            cache = self._mask_cache = {}
        hit = cache.get(key)
        if hit is not None:
            return hit
        mask = [False] * len(token_texts)

        def dfs(node, stacks):
            tid = node.get(-1)
            if tid is not None:
                for t in tid:
                    mask[t] = True
            for ch, child in node.items():
                if ch == -1:
                    continue
                ns = self._advance_char(stacks, ch)
                if ns:
                    dfs(child, ns)

        dfs(trie, self.stacks)
        if len(cache) < 64:
            cache[key] = mask
        return mask

    def copy(self) -> "Grammar":
        g = object.__new__(Grammar)
        g.gbnf = getattr(self, "gbnf", "")
        g.rules = self.rules
        g.root = self.root
        g.stacks = set(self.stacks)
        g.lazy = self.lazy
        g.awaiting_trigger = self.lazy
        g.trigger_tokens = self.trigger_tokens
        g.trigger_patterns = self.trigger_patterns
        g._trigger_buffer = ""
        # share the state->mask memo: masks depend only on (rules, stacks)
        g._mask_cache = getattr(self, "_mask_cache", None) \
            or self.__dict__.setdefault("_mask_cache", {})
        return g


class TokenDFA:
    """Token-level DFA compiled from a Grammar's reachable PDA states
    (round 5): dense per-state legality masks + next-state table, built
    for grammars whose state space closes within ``max_states``. The
    serving engine uploads (masks, trans) once and enforces the grammar
    INSIDE the device decode scan — zero violations, chaining stays on,
    so constrained decoding runs at the unconstrained fast-path rate
    (the reference applies its grammar per token inside the sampler at
    full speed, common/sampling.cpp:104-179; this is the batched-device
    equivalent)."""

    def __init__(self, masks, trans, done, state_index, gbnf):
        self.masks = masks              # np.bool_ [S, V(+eog cols set)]
        self.trans = trans              # np.int16 [S, V] next state
        self.done = done                # np.bool_ [S]
        self.state_index = state_index  # frozenset(stacks) -> row
        self.gbnf = gbnf

    def index_of(self, grammar) -> int:
        """Row for the grammar's CURRENT state, or -1 if unknown (e.g.
        mid-token byte state reached through a path the token trie never
        produces)."""
        return self.state_index.get(frozenset(grammar.stacks), -1)


def compile_token_dfa(grammar: "Grammar", pieces: list[str], trie,
                      max_states: int = 48, eog_ids=(),
                      time_budget_s: float = 120.0):
    """BFS the PDA's token-reachable state space; one trie walk per state
    yields both the legality mask and the successor state per token.
    Returns a TokenDFA, or None when the grammar doesn't close within
    ``max_states`` states (deep JSON-schema grammars — those keep the
    optimistic host-validated path) or the time budget."""
    import time as _time

    import numpy as np

    if grammar.awaiting_trigger:
        return None
    v = len(pieces)
    t0 = _time.monotonic()
    visits = [0]                       # GIL-yield counter: the trie walk
    # is seconds of pure Python per state and runs on a background
    # thread; without periodic sleeps it starves the serving engine
    # thread (measured 0.9 tok/s during compile vs ~36 without)
    start = frozenset(grammar.stacks)
    index = {start: 0}
    order = [start]
    rows_mask, rows_next = [], []
    i = 0
    while i < len(order):
        if _time.monotonic() - t0 > time_budget_s:
            return None
        stacks = set(order[i])
        mask = np.zeros((v,), np.bool_)
        nxt = np.full((v,), -1, np.int16)
        overflow = []

        def dfs(node, st):
            visits[0] += 1
            if visits[0] % 2048 == 0:
                _time.sleep(0.001)
            key = None
            tids = node.get(-1)
            if tids is not None:
                key = frozenset(st)
                idx = index.get(key)
                if idx is None:
                    if len(index) >= max_states:
                        overflow.append(True)
                        return
                    idx = len(order)
                    index[key] = idx
                    order.append(key)
                for t in tids:
                    mask[t] = True
                    nxt[t] = idx
            for ch, child in node.items():
                if ch == -1 or overflow:
                    continue
                ns = grammar._advance_char(st, ch)
                if ns:
                    dfs(child, ns)

        dfs(trie, stacks)
        if overflow:
            return None
        rows_mask.append(mask)
        rows_next.append(nxt)
        i += 1
    s = len(order)
    masks = np.stack(rows_mask)
    trans = np.stack(rows_next)
    done = np.zeros((s,), np.bool_)
    for key, idx in index.items():
        done[idx] = tuple() in key
    for eid in eog_ids:
        if 0 <= eid < v:
            masks[:, eid] = done          # EOS legal once the PDA can end
            trans[:, eid] = np.arange(s)  # terminal self-loop
    return TokenDFA(masks, trans, done, index, getattr(grammar, "gbnf", ""))
