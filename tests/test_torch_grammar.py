"""The port's copies of the GBNF grammar and the JSON-schema converter
(``rrs_tpu_torch/runtime/{grammar,json_schema}.py``) against the JAX
package's: the grammars and schemas of tests/test_grammar.py and
tests/test_json_schema.py, each text's acceptance (every prefix, and as a
whole), the token mask over a character vocabulary, lazy triggers, and the
compiled token DFA's arrays. Host code on both sides: everything is held
exactly (no tolerance)."""

import numpy as np
import pytest

from rrs_tpu.runtime import grammar as jg
from rrs_tpu.runtime.json_schema import json_schema_to_gbnf as jax_schema
from rrs_tpu_torch.runtime import grammar as tg
from rrs_tpu_torch.runtime.json_schema import json_schema_to_gbnf as torch_schema

JSON_GBNF = r'''
root ::= object
object ::= "{" ws ( string ":" ws value ("," ws string ":" ws value)* )? "}" ws
value ::= object | array | string | number | ("true" | "false" | "null") ws
array ::= "[" ws ( value ("," ws value)* )? "]" ws
string ::= "\"" [^"\\]* "\"" ws
number ::= ("-"? [0-9]+ ("." [0-9]+)?) ws
ws ::= [ \t\n]*
'''

# (GBNF text, texts to hold) from tests/test_grammar.py
GRAMMARS = [
    ('root ::= "ab" "c"', ["abc", "ab", "abd", "x"]),
    ('root ::= "yes" | "no"', ["yes", "no", "maybe"]),
    ("root ::= [a-z0-9]+", ["abc123", "ABC"]),
    ('root ::= [^"]* "\\""', ['hello"', "hello"]),
    ('root ::= "a"* "b"', ["b", "ab", "aaab"]),
    ('root ::= "a"+ "b"', ["b", "ab"]),
    ('root ::= "a"? "b"', ["b", "ab", "aab"]),
    ('root ::= "a"{2,3}', ["a", "aa", "aaa", "aaaa"]),
    ('root ::= greeting " " name\ngreeting ::= "hello" | "hi"\nname ::= ("world" | "there")',
     ["hello world", "hi there", "hello  "]),
    ('root ::= "(" inner ")"\ninner ::= root | ""', ["()", "(())", ")"]),
    (JSON_GBNF, ['{"a": 1, "b": [true, null], "c": {"d": "x"}}', '{"a": ', '{"a" 1', "[1]"]),
    ('root ::= "hi"', ["hi", "xx"]),
    ('root ::= "{" ws "\\"a\\"" ws ":" ws [0-9]+ ws "}" \nws ::= [ \\t]*',
     ['{"a": 12}', '{ "a" :3 }', '{"b"']),
    ("root ::= [a-z ]+", ["hello world", "Hello"]),
]

# (schema, documents to hold) from tests/test_json_schema.py
SCHEMAS = [
    ({"type": "object", "properties": {"name": {"type": "string"}, "age": {"type": "integer"}},
      "required": ["name"]},
     ['{"name":"bob","age":42}', '{"name":"bob"}', '{"age":42}', '{"name":42}']),
    ({"enum": ["red", "green", 3]}, ['"red"', "3", '"blue"']),
    ({"const": True}, ["true", "false"]),
    ({"type": "array", "items": {"type": "number"}}, ["[1,2.5,-3e2]", "[]", '["x"]']),
    ({}, ['{"a":[1,{"b":null}]}', "[true,false]", '"str"', "12.5", "{broken"]),
    ({"type": "object",
      "properties": {"user": {"type": "object", "properties": {"id": {"type": "integer"}},
                              "required": ["id"]},
                     "tags": {"type": "array", "items": {"type": "string"}}},
      "required": ["user", "tags"]},
     ['{"user":{"id":7},"tags":["a","b"]}', '{"user":{},"tags":[]}']),
]


def _complete(g, s: str) -> bool:
    c = g.copy()
    return c.accept_text(s) and c.done


def _char_vocab():
    """Single characters, a few multi-character pieces and an empty piece."""
    chars = [chr(c) for c in range(32, 127)] + ["\t", "\n"]
    return chars + ["ab", "yes", "no!", "hello", '{"', '": 1}', "true", "nul", "12", ""]


def _hold(gbnf: str, texts) -> None:
    j, t = jg.Grammar(gbnf), tg.Grammar(gbnf)
    for text in texts:
        for i in range(len(text) + 1):
            assert t.accepts_text(text[:i]) == j.accepts_text(text[:i]), (gbnf, text[:i])
        assert _complete(t, text) == _complete(j, text), (gbnf, text)
    pieces = _char_vocab()
    trie_t, trie_j = tg.build_token_trie(pieces), jg.build_token_trie(pieces)
    assert trie_t == trie_j
    assert t.allowed_mask(pieces) == j.allowed_mask(pieces)
    # the mask mid-way through each text, with and without the trie
    for text in texts:
        jc, tc = j.copy(), t.copy()
        half = text[: len(text) // 2]
        assert tc.accept_text(half) == jc.accept_text(half)
        assert tc.allowed_mask(pieces, trie=trie_t) == jc.allowed_mask(pieces, trie=trie_j)
        assert tc.allowed_mask(pieces) == jc.allowed_mask(pieces)
        assert (tc.done, tc.must_end) == (jc.done, jc.must_end)


@pytest.mark.parametrize("gbnf,texts", GRAMMARS, ids=[f"g{i}" for i in range(len(GRAMMARS))])
def test_gbnf_accepts_and_masks_as_jax(gbnf, texts):
    _hold(gbnf, texts)


@pytest.mark.parametrize("schema,docs", SCHEMAS, ids=[f"s{i}" for i in range(len(SCHEMAS))])
def test_json_schema_text_and_grammar_as_jax(schema, docs):
    text = torch_schema(schema)
    assert text == jax_schema(schema)
    _hold(text, docs)


@pytest.mark.parametrize("bad", ['start ::= "a"', 'root ::= undefined_rule', 'root ::= "a'])
def test_parse_errors_as_jax(bad):
    """A bad grammar raises what JAX's raises (an unterminated literal runs
    off the text: IndexError in both); the server answers either with 400."""
    with pytest.raises(Exception) as je:
        jg.Grammar(bad)
    with pytest.raises(Exception) as te:
        tg.Grammar(bad)
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)


def _lazy_trace(mod, kind):
    """The steps of tests/test_grammar.py's lazy-trigger cases, recorded."""
    out = []
    if kind == "word":
        g = mod.Grammar('root ::= "<tool_call>" [a-z]+ "</tool_call>"', lazy=True,
                        trigger_words=["<tool_call>"])
        out += [g.awaiting_trigger, tuple(g.allowed_mask(["xyz", "!!!", "<tool"]))]
        g.feed_token(1, "free text ")
        out.append(g.awaiting_trigger)
        g.feed_token(2, "ok <tool_call>ab")
        out += [g.awaiting_trigger, g.accept_text("c"), g.accepts_text("9"),
                g.accept_text("</tool_call>"), g.done]
    elif kind == "token":
        g = mod.Grammar('root ::= "{" [a-z]* "}"', lazy=True, trigger_tokens=[42])
        g.feed_token(7, "anything at all")
        out.append(g.awaiting_trigger)
        g.feed_token(42, "{")
        out += [g.awaiting_trigger, g.accept_text("ab}"), g.done,
                mod.Grammar('root ::= "x"', lazy=True, trigger_words=["x"]).copy()
                .awaiting_trigger]
    else:
        g = mod.Grammar('root ::= "[" [0-9]+ "]"', lazy=True, trigger_patterns=[r"\[\d"])
        g.feed_token(3, "list: ")
        out.append(g.awaiting_trigger)
        g.feed_token(4, "[4")
        out += [g.awaiting_trigger, g.accept_text("2]"), g.done]
    return out


@pytest.mark.parametrize("kind", ["word", "token", "pattern"])
def test_lazy_triggers_as_jax(kind):
    assert _lazy_trace(tg, kind) == _lazy_trace(jg, kind)


def _plain(x):
    """A state index with each package's ``Elem`` as its (kind, value)."""
    if isinstance(x, dict):
        return {_plain(k): v for k, v in x.items()}
    if isinstance(x, frozenset):
        return frozenset(_plain(e) for e in x)
    if isinstance(x, tuple):
        return tuple(_plain(e) for e in x)
    if hasattr(x, "kind") and hasattr(x, "value"):
        return ("elem", x.kind, x.value)
    return x


def _dfa_pieces(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    alphabet = list("abcxyz {}:\"0123456789,")
    return ["".join(rng.choice(alphabet, int(rng.integers(1, 4)))) if rng.random() < 0.9
            else "<|x|>" for _ in range(n)]


@pytest.mark.parametrize("gbnf", ["root ::= [a-z ]+", 'root ::= "yes" | "no"',
                                  'root ::= "{" [a-z]* "}"', 'root ::= [0-9]+ ("," [0-9]+)*',
                                  JSON_GBNF])
def test_compile_token_dfa_arrays_as_jax(gbnf):
    """masks, trans, done and the state index are equal to JAX's; a grammar
    that does not close within the state budget gives None in both."""
    pieces = _dfa_pieces(0)
    eog = (len(pieces) - 1,)
    tj = jg.compile_token_dfa(jg.Grammar(gbnf), pieces, jg.build_token_trie(pieces),
                              eog_ids=eog)
    tt = tg.compile_token_dfa(tg.Grammar(gbnf), pieces, tg.build_token_trie(pieces),
                              eog_ids=eog)
    assert (tt is None) == (tj is None)
    if tt is None:
        return
    assert tt.masks.dtype == tj.masks.dtype and tt.trans.dtype == tj.trans.dtype
    np.testing.assert_array_equal(tt.masks, tj.masks)
    np.testing.assert_array_equal(tt.trans, tj.trans)
    np.testing.assert_array_equal(tt.done, tj.done)
    assert _plain(tt.state_index) == _plain(tj.state_index) and tt.gbnf == tj.gbnf
    g = tg.Grammar(gbnf)
    assert tt.index_of(g) == 0
