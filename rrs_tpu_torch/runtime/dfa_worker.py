"""The token-DFA compile as a spawned process's entry point.

The serving engine compiles a grammar's token DFA (``grammar.TokenDFA``) in
a separate process: seconds of pure-Python trie walking on a sibling thread
hold the GIL against the engine thread (the JAX package measured its engine
falling from 36 to 1.0 tok/s, and the walk itself from 8 to ~250 s). A
spawn-context child starts a fresh interpreter, so this module imports
neither torch nor anything that does: the child starts in well under a
second and never touches the card.
"""

from __future__ import annotations

import pickle


def dfa_worker(gbnf: str, pieces: list, eog_ids: tuple, out_path: str) -> None:
    """Rebuild the grammar and the token trie here (cheaper than pickling a
    151k-node trie in), compile, and pickle the ``TokenDFA`` (or None when
    the grammar does not close within the state budget) to ``out_path``."""
    from rrs_tpu_torch.runtime.grammar import Grammar, build_token_trie, compile_token_dfa

    try:
        g = Grammar(gbnf)
        dfa = compile_token_dfa(g, pieces, build_token_trie(pieces), eog_ids=eog_ids)
    except Exception:                                         # noqa: BLE001
        dfa = None
    with open(out_path, "wb") as f:
        pickle.dump(dfa, f)
