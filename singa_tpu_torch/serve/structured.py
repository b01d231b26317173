"""Structured decoding: host-side token automata that drive per-slot
vocabulary masks (counterpart of ``singa_tpu/serve/structured.py``).

The grammar state lives on the host.  Between steps the engine advances
each structured request's automaton with the token it emitted and asks
the new state for its ``(vocab,)`` bool mask; the masks of a step's
lanes go to the device in one ``(slots, vocab)`` buffer that the
captured decode step reads, so the step's graph is the same for every
grammar (a masked step is captured once per decode width).

* :class:`TokenAutomaton`: the protocol the engine consumes
  (``GenerationRequest(structured=...)``).  States are immutable,
  hashable values: the engine keeps one a slot, and fork branches
  (``serve/fork.py``) start from the parent's state and advance their
  own.
* :class:`JsonSchemaAutomaton`: a small JSON-schema subset compiled to
  a character program of literal, repeat, integer and alternation
  nodes, lifted to tokens by running each vocabulary string through it
  (those whose first character the state accepts); masks are memoized
  per state, so a state's mask is built once.
  Determinism is checked at construction (a repeat's characters may not
  start what follows it, alternation arms differ in their first
  character), so every (state, character) pair has at most one
  successor and a schema that breaks this raises ``ValueError`` before
  any request is served.

The subset: ``{"type": "object", "properties": {...}}``, every property
emitted in declaration order, each ``integer`` (canonical JSON: ``0`` or
a nonzero-led run of at most ``max_digits`` digits), ``boolean``,
``string`` (at most ``maxLength`` or ``max_string`` word characters) or
``enum`` (distinct non-empty strings).  The automaton completes on the
closing brace, and the engine then retires the request with
``finish_reason="stop"``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TokenAutomaton", "JsonSchemaAutomaton"]


class TokenAutomaton:
    """Protocol for ``GenerationRequest(structured=)``.

    The engine calls::

        state = a.initial()
        mask  = a.mask(state)        # (vocab_size,) bool np.ndarray
        state = a.advance(state, t)  # after emitting token t
        a.done(state)                # -> retire with "stop"

    Contract: states are immutable hashable values (fork branches
    share them); ``mask`` returns a ``(vocab_size,)`` bool array, which
    the engine only reads (a memoized implementation may return one
    array a state); ``advance`` raises ``ValueError`` for a token the
    state's mask disallows; ``vocab_size`` is the token space the masks
    cover, checked against the model's at submit.  Subclassing is
    optional: any object with the four methods serves."""

    vocab_size: int

    def initial(self):
        raise NotImplementedError

    def mask(self, state) -> np.ndarray:
        raise NotImplementedError

    def advance(self, state, token):
        raise NotImplementedError

    def done(self, state) -> bool:
        raise NotImplementedError


_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")


class JsonSchemaAutomaton(TokenAutomaton):
    """Char-program automaton for a JSON-schema subset.

    ``schema``: the object schema (see module docstring for the
    subset).  ``vocab``: sequence mapping token id -> the token's
    string (what detokenizing that id appends to the output); empty
    strings are never legal emissions.  ``max_digits`` bounds integer
    literals, ``max_string`` bounds free-string content — both keep
    every accepted output finite, so ``done`` is always reachable
    within a computable token budget.

    States are ``(node_idx, aux)`` tuples over the compiled node
    list: ``aux`` is the position inside a literal, the repeat count
    inside a repeat node, or ``(arm, pos)`` inside an alternation;
    ``aux is None`` means "at the node's entry, nothing consumed".
    The terminal state is ``(len(nodes), None)``.
    """

    def __init__(self, schema, vocab, max_digits=8, max_string=16):
        self._tok = [str(s) for s in vocab]
        self.vocab_size = len(self._tok)
        if self.vocab_size < 1:
            raise ValueError("vocab must be non-empty")
        self.schema = schema
        self._nodes = self._compile(schema, int(max_digits),
                                    int(max_string))
        self._check_deterministic()
        self._mask_memo = {}
        # token ids by their first character: a state's mask simulates
        # only the tokens whose first character it accepts
        by_first = {}
        for tid, tok in enumerate(self._tok):
            if tok:
                by_first.setdefault(tok[0], []).append(tid)
        self._by_first = by_first

    # -- schema -> char program ------------------------------------------
    @staticmethod
    def _compile(schema, max_digits, max_string):
        if not isinstance(schema, dict) \
                or schema.get("type") != "object" \
                or not isinstance(schema.get("properties"), dict) \
                or not schema["properties"]:
            raise ValueError(
                "schema must be {'type': 'object', 'properties': "
                "{...}} with at least one property (the supported "
                "structured-output subset; see serve/structured.py)")
        nodes = []
        lit = []  # pending literal chars, coalesced into one node

        def flush():
            if lit:
                nodes.append(("lit", "".join(lit)))
                del lit[:]

        props = list(schema["properties"].items())
        lit.append("{")
        for i, (name, sub) in enumerate(props):
            lit.extend(f'"{name}":')
            if isinstance(sub, dict) and "enum" in sub:
                choices = sub["enum"]
                if not choices or not all(
                        isinstance(c, str) and c for c in choices):
                    raise ValueError(
                        f"property {name!r}: enum must be non-empty "
                        f"strings, got {choices!r}")
                lit.append('"')
                flush()
                nodes.append(("alt", tuple(str(c) for c in choices)))
                lit.append('"')
            elif isinstance(sub, dict) and sub.get("type") == "integer":
                flush()
                # JSON's canonical integer: "0" alone or a nonzero
                # lead digit — a plain digit-repeat would emit "066"
                nodes.append(("int", max_digits))
            elif isinstance(sub, dict) and sub.get("type") == "boolean":
                flush()
                nodes.append(("alt", ("true", "false")))
            elif isinstance(sub, dict) and sub.get("type") == "string":
                n = int(sub.get("maxLength", max_string))
                lit.append('"')
                flush()
                nodes.append(("rep", _WORD, 0, n))
                lit.append('"')
            else:
                raise ValueError(
                    f"property {name!r}: unsupported value schema "
                    f"{sub!r} (supported: integer, boolean, string, "
                    f"enum of strings)")
            lit.append("," if i + 1 < len(props) else "}")
        flush()
        return nodes

    def _entry_chars(self, idx):
        """Chars that can be the FIRST char consumed at node ``idx``
        (following lo=0 repeats through to their successor)."""
        if idx >= len(self._nodes):
            return frozenset()
        kind = self._nodes[idx][0]
        if kind == "lit":
            return frozenset(self._nodes[idx][1][0])
        if kind == "alt":
            return frozenset(s[0] for s in self._nodes[idx][1])
        if kind == "int":
            return _DIGITS
        _, cs, lo, _hi = self._nodes[idx]
        return cs | self._entry_chars(idx + 1) if lo == 0 else cs

    def _check_deterministic(self):
        """Compile-time determinism: every (state, char) has at most
        one successor.  Repeat charsets must be disjoint from their
        successor's entry chars (otherwise "another repeat char or
        the next node?" is ambiguous) and alternation arms must
        differ in their first char."""
        for i, node in enumerate(self._nodes):
            if node[0] in ("rep", "int"):
                cs = _DIGITS if node[0] == "int" else node[1]
                clash = cs & self._entry_chars(i + 1)
                if clash:
                    raise ValueError(
                        f"ambiguous schema: repeat node {i}'s charset "
                        f"overlaps what follows it ({sorted(clash)!r})"
                        f" — the automaton could not decide when the "
                        f"repeat ends")
            elif node[0] == "alt":
                firsts = [s[0] for s in node[1]]
                if len(set(firsts)) != len(firsts):
                    raise ValueError(
                        f"ambiguous schema: alternation {node[1]!r} "
                        f"arms share a first character — choices must "
                        f"be distinguishable at their first char")

    # -- char-level stepping ---------------------------------------------
    def _enter(self, idx, ch):
        """Consume ``ch`` as the first char at node ``idx``'s entry.
        Returns the successor state or None (illegal char)."""
        if idx >= len(self._nodes):
            return None  # program complete: no char is legal
        node = self._nodes[idx]
        if node[0] == "lit":
            s = node[1]
            if ch != s[0]:
                return None
            return (idx + 1, None) if len(s) == 1 else (idx, 1)
        if node[0] == "alt":
            for a, s in enumerate(node[1]):
                if s[0] == ch:
                    return ((idx + 1, None) if len(s) == 1
                            else (idx, (a, 1)))
            return None
        if node[0] == "int":
            if ch == "0":
                return (idx + 1, None)  # "0" is a complete integer
            if ch in _DIGITS:
                return (idx + 1, None) if node[1] == 1 else (idx, 1)
            return None
        _, cs, lo, hi = node
        if ch in cs and hi >= 1:
            return (idx, 1)
        if lo == 0:
            return self._enter(idx + 1, ch)
        return None

    def _step_char(self, state, ch):
        idx, aux = state
        if aux is None:
            return self._enter(idx, ch)
        node = self._nodes[idx]
        if node[0] == "lit":
            s = node[1]
            if ch != s[aux]:
                return None
            return (idx + 1, None) if aux + 1 == len(s) else (idx,
                                                              aux + 1)
        if node[0] == "alt":
            a, pos = aux
            s = node[1][a]
            if ch != s[pos]:
                return None
            return (idx + 1, None) if pos + 1 == len(s) \
                else (idx, (a, pos + 1))
        if node[0] == "int":
            # aux digits consumed, the first was nonzero: any digit
            # extends up to max_digits, anything else exits
            if ch in _DIGITS and aux < node[1]:
                return (idx, aux + 1)
            return self._enter(idx + 1, ch)
        _, cs, lo, hi = node
        if ch in cs and aux < hi:
            return (idx, aux + 1)
        if aux >= lo:
            return self._enter(idx + 1, ch)
        return None

    def _step_token(self, state, tid):
        s = self._tok[tid]
        if not s:
            return None
        for ch in s:
            state = self._step_char(state, ch)
            if state is None:
                return None
        return state

    # -- the TokenAutomaton surface --------------------------------------
    def initial(self):
        return (0, None)

    def mask(self, state):
        """The tokens whose whole string the char program accepts from
        ``state``, built at a state's first visit (the tokens of each
        first character it accepts, run from the state that character
        leads to) and memoized."""
        m = self._mask_memo.get(state)
        if m is None:
            m = np.zeros(self.vocab_size, bool)
            for ch, ids in self._by_first.items():
                after = self._step_char(state, ch)
                if after is None:
                    continue
                for tid in ids:
                    st = after
                    for c in self._tok[tid][1:]:
                        st = self._step_char(st, c)
                        if st is None:
                            break
                    else:
                        m[tid] = True
            self._mask_memo[state] = m
        return m

    def advance(self, state, token):
        nxt = self._step_token(state, int(token))
        if nxt is None:
            raise ValueError(
                f"token {int(token)} ({self._tok[int(token)]!r}) is "
                f"not accepted at automaton state {state!r} — the "
                f"applied mask and the emitted token disagree")
        return nxt

    def done(self, state):
        return state[0] >= len(self._nodes)
