"""Grammar / JSON-schema constrained decoding: compiled token-level
DFAs applied as per-row logit masks in the sampling step.

The port's own copy of ``paddle_tpu/serving/constraints.py`` (pure
host-side numpy; no torch, no device state). Its tables, records and
``content_hash`` are the reference's, byte for byte, so a record written
by either package loads in the other.

Free-form sampling cannot promise schema-valid output — production
traffic that feeds parsers (function calls, JSON APIs, SQL) either
retries on parse failure or post-hoc repairs. Constrained decoding
makes validity STRUCTURAL: a grammar compiles ONCE into a token-level
DFA (dense ``(states, vocab)`` transition table), each constrained row
carries a DFA state, the engine applies each row's allowed-token mask
in the sampling step (``logits.masked_fill(~mask, -inf)`` before the
argmax or the draw), and the state advances at COMMIT with the token
that actually landed. The device cost is one ``(B, vocab)`` bool
operand, uploaded only after a host-side change.

Three compilation layers, cheapest first:

- :func:`dfa_from_sequences` — a trie DFA accepting exactly the given
  token sequences (closed answer sets, tool-name menus).
- :func:`dfa_from_regex` — a character-class regex (literals, ``|``,
  ``*``, ``+``, ``?``, ``()``, ``[a-z]`` classes, ``.``, escapes)
  compiled Thompson-style to an NFA, subset-constructed to a char DFA,
  then LIFTED to token level: token ``t`` transitions state ``s`` to
  the state reached by running ``t``'s string through the char DFA
  from ``s`` (tokens that die mid-string are masked out). The lift is
  what makes the per-step cost a table lookup instead of a parse.
- :func:`json_schema_dfa` — a restricted JSON-schema subset (objects
  with fixed properties: string / integer / boolean / enum) rendered
  to a regex in canonical key order and delegated to the regex
  compiler — schema-guaranteed output without a runtime parser.

Parity contract: masking can only EXCLUDE tokens, so whenever the
grammar admits the unconstrained argmax, constrained greedy decode is
TOKEN-IDENTICAL to unconstrained decode, and every emitted token is
grammar-valid.
"""
from __future__ import annotations

import base64
from typing import Dict, List, Optional, Sequence

import numpy as np


class TokenDFA:
    """Dense token-level DFA: ``next[(state, token)]`` (-1 = reject),
    ``accepting[state]``. States are small ints; the per-state allowed
    mask is one vectorized compare, the per-token advance one lookup.

    The dense ``(states, vocab)`` table trades memory for a branch-free
    per-step mask gather — at serving vocab sizes (32–128k) one state
    row is a few hundred KB of host bools, built once per grammar."""

    def __init__(self, next_table: np.ndarray, accepting: np.ndarray,
                 start: int = 0):
        self._hash: Optional[str] = None
        self.next = np.asarray(next_table, np.int32)
        if self.next.ndim != 2:
            raise ValueError(
                f"TokenDFA: next_table must be (states, vocab), got "
                f"shape {self.next.shape}")
        self.accepting = np.asarray(accepting, bool).reshape(-1)
        if self.accepting.size != self.next.shape[0]:
            raise ValueError(
                f"TokenDFA: {self.accepting.size} accepting flags for "
                f"{self.next.shape[0]} states")
        self.start = int(start)

    @property
    def vocab(self) -> int:
        return self.next.shape[1]

    @property
    def num_states(self) -> int:
        return self.next.shape[0]

    def allowed(self, state: int) -> np.ndarray:
        """(vocab,) bool — tokens with a live transition from
        ``state``."""
        return self.next[state] >= 0

    def advance(self, state: int, token: int) -> int:
        """The successor state; -1 when ``token`` is not admitted."""
        return int(self.next[state, int(token)])

    def content_hash(self) -> str:
        """Stable identity of this grammar (sha1 of the table bytes):
        checkpoint and WAL records DEDUPE the dense table by it —
        many sessions sharing one grammar serialize the table once, and
        per-session records carry only the hash (at serving vocab sizes
        the table is MBs; re-encoding it per record would dominate every
        journal frame)."""
        if self._hash is None:
            import hashlib
            h = hashlib.sha1(np.ascontiguousarray(self.next).tobytes())
            h.update(np.packbits(self.accepting).tobytes())
            h.update(str(self.start).encode())
            self._hash = h.hexdigest()
        return self._hash

    def to_record(self) -> Dict:
        """JSON-able serialization of the dense table (the
        drain-checkpoint and WAL shape — base64 of the raw int32
        table plus the accepting bitmap, so a mid-grammar session
        survives a drain or a cold restart with its grammar intact)."""
        return {
            "shape": list(self.next.shape),
            "table": base64.b64encode(
                np.ascontiguousarray(self.next).tobytes()).decode(),
            "accepting": base64.b64encode(
                np.packbits(self.accepting).tobytes()).decode(),
            "start": self.start,
        }

    @classmethod
    def from_record(cls, rec: Dict) -> "TokenDFA":
        shape = tuple(int(x) for x in rec["shape"])
        table = np.frombuffer(base64.b64decode(rec["table"]),
                              np.int32).reshape(shape)
        accepting = np.unpackbits(np.frombuffer(
            base64.b64decode(rec["accepting"]),
            np.uint8))[:shape[0]].astype(bool)
        return cls(table, accepting, start=int(rec.get("start", 0)))


class ConstraintState:
    """One request's live grammar state: the DFA, the current state id,
    and its counters (``tokens_masked_total``, ``dead_ends``).

    The state advances at COMMIT time only (with the token that
    actually landed), so preempt→resume needs no replay-side handling:
    committed tokens are never re-sampled, and the host-side state
    object rides the request handle through evictions, swaps and
    requeues untouched. ``finished`` latches once eos lands."""

    def __init__(self, dfa: TokenDFA, eos_token_id: Optional[int] = None):
        self.dfa = dfa
        self.state = dfa.start
        self.eos_token_id = eos_token_id
        self.finished = False
        self.tokens_masked_total = 0
        self.dead_ends = 0

    def mask(self, vocab: int, eos_token_id=None) -> np.ndarray:
        """(vocab,) bool allowed-token mask for the CURRENT state: live
        DFA transitions, plus eos whenever the state is accepting (a
        complete grammar production may terminate). Fail-safe: a dead
        end (no live transition, not accepting) admits ONLY eos —
        counted, so a grammar hole terminates the stream instead of
        wedging the row — and a finished stream pins to eos (the
        engine's post-eos pad contract). On an EOS-LESS engine a state
        with no live transitions latches ``finished`` instead (the
        stream cannot terminate, so the tail free-runs unconstrained
        rather than crashing the commit)."""
        eos = (self.eos_token_id if eos_token_id is None
               else eos_token_id)
        m = np.zeros((vocab,), bool)
        if self.finished:
            if eos is not None:
                m[int(eos)] = True
            else:
                m[:] = True
            return m
        allowed = self.dfa.allowed(self.state)
        m[:allowed.size] |= allowed[:vocab]
        if self.dfa.accepting[self.state] and eos is not None:
            m[int(eos)] = True
        if not m.any():
            if not self.dfa.accepting[self.state]:
                self.dead_ends += 1
            if eos is not None:
                m[int(eos)] = True
            else:
                # no live transition and no terminator to emit: the
                # grammar can constrain nothing further (a COMPLETED
                # production on an eos-less engine, or a counted
                # grammar hole) — latch finished so the commit-time
                # advance tolerates the free-running tail instead of
                # raising on it
                self.finished = True
                m[:] = True
        self.tokens_masked_total += int(vocab - m.sum())
        return m

    def advance(self, token: int) -> None:
        """Fold one COMMITTED token into the state. Eos from an
        accepting (or dead-end) state finishes the stream; any other
        inadmissible token is a masking bug and raises loudly."""
        if self.finished:
            return
        eos = self.eos_token_id
        if eos is not None and int(token) == int(eos):
            self.finished = True
            return
        nxt = self.dfa.advance(self.state, token)
        if nxt < 0:
            raise ValueError(
                f"constrained decode committed inadmissible token "
                f"{int(token)} from state {self.state} — the sampling "
                f"mask was not applied")
        self.state = nxt

    def to_record(self, grammars: Optional[Dict] = None) -> Dict:
        """Serialize the LIVE state: dense DFA table + the current
        state id + the counters, so drain/restore and cold-restart
        recovery re-attach an equivalent constraint (through the
        engine's ``attach_constraint``). ``grammars`` (hash → table
        record) dedupes the table: the record then carries only
        ``dfa_hash`` and the caller ships the shared dict once
        (checkpoint meta / WAL grammar records)."""
        rec = {"state": int(self.state),
               "eos_token_id": self.eos_token_id,
               "finished": bool(self.finished),
               "dead_ends": int(self.dead_ends),
               "tokens_masked_total": int(self.tokens_masked_total)}
        if grammars is None:
            rec["dfa"] = self.dfa.to_record()
        else:
            h = self.dfa.content_hash()
            grammars.setdefault(h, self.dfa.to_record())
            rec["dfa_hash"] = h
        return rec

    @classmethod
    def from_record(cls, rec: Dict,
                    grammars: Optional[Dict] = None) -> "ConstraintState":
        if "dfa" in rec:
            dfa_rec = rec["dfa"]
        else:
            h = rec.get("dfa_hash")
            dfa_rec = (grammars or {}).get(h)
            if dfa_rec is None:
                raise ValueError(
                    f"ConstraintState.from_record: grammar {h!r} is "
                    f"not in the supplied grammar table — the "
                    f"checkpoint/WAL record set is incomplete")
        st = cls(TokenDFA.from_record(dfa_rec),
                 eos_token_id=rec.get("eos_token_id"))
        st.state = int(rec.get("state", st.dfa.start))
        st.finished = bool(rec.get("finished", False))
        st.dead_ends = int(rec.get("dead_ends", 0))
        st.tokens_masked_total = int(rec.get("tokens_masked_total", 0))
        return st

    def state_record(self) -> Dict:
        """The cheap per-step delta (the WAL's ``cstate``):
        everything but the table — folded over the submit-time record
        at replay."""
        return {"state": int(self.state), "finished": bool(self.finished),
                "dead_ends": int(self.dead_ends),
                "tokens_masked_total": int(self.tokens_masked_total)}


def dfa_from_sequences(sequences: Sequence[Sequence[int]],
                       vocab: int) -> TokenDFA:
    """Trie DFA accepting EXACTLY the given token sequences (each leaf
    accepting). Closed answer sets — classification labels, tool-name
    menus — compile in one pass with states == trie nodes."""
    if not sequences:
        raise ValueError("dfa_from_sequences: need at least one sequence")
    children: List[Dict[int, int]] = [{}]
    accepting = [False]
    for seq in sequences:
        seq = [int(t) for t in np.asarray(seq, np.int64).reshape(-1)]
        if not seq:
            accepting[0] = True
            continue
        node = 0
        for t in seq:
            if not (0 <= t < vocab):
                raise ValueError(
                    f"dfa_from_sequences: token {t} outside vocab "
                    f"{vocab}")
            nxt = children[node].get(t)
            if nxt is None:
                children.append({})
                accepting.append(False)
                nxt = len(children) - 1
                children[node][t] = nxt
            node = nxt
        accepting[node] = True
    table = np.full((len(children), vocab), -1, np.int32)
    for s, kids in enumerate(children):
        for t, nxt in kids.items():
            table[s, t] = nxt
    return TokenDFA(table, np.asarray(accepting, bool))


# ---------------- character-regex → char DFA → token lift ----------------

_EPS = -1          # epsilon edge label in the NFA


def _parse_regex(pattern: str):
    """Recursive-descent regex parser → NFA fragment list.
    Supported: literals, escapes, ``.``, ``[a-z0-9_]`` classes (with
    ranges), grouping ``()``, alternation ``|`` and the ``* + ?``
    quantifiers — the working subset JSON-shaped grammars need."""
    pos = [0]
    n = len(pattern)
    # NFA as (transitions: list of dict char->set(states) + eps sets)
    trans: List[Dict] = []
    eps: List[set] = []

    def new_state() -> int:
        trans.append({})
        eps.append(set())
        return len(trans) - 1

    def add(s: int, ch: str, t: int):
        trans[s].setdefault(ch, set()).add(t)

    def peek():
        return pattern[pos[0]] if pos[0] < n else None

    def eat():
        c = pattern[pos[0]]
        pos[0] += 1
        return c

    def parse_class():
        """``[...]`` — returns the set of admitted characters."""
        chars = set()
        negate = False
        if peek() == "^":
            eat()
            negate = True
        while True:
            c = peek()
            if c is None:
                raise ValueError("unterminated character class")
            if c == "]":
                eat()
                break
            c = eat()
            if c == "\\":
                c = eat()
            if peek() == "-" and pos[0] + 1 < n \
                    and pattern[pos[0] + 1] != "]":
                eat()
                hi = eat()
                if hi == "\\":
                    hi = eat()
                for o in range(ord(c), ord(hi) + 1):
                    chars.add(chr(o))
            else:
                chars.add(c)
        if negate:
            universe = {chr(o) for o in range(32, 127)}
            chars = universe - chars
        return chars

    def atom():
        c = peek()
        if c == "(":
            eat()
            frag = alternation()
            if peek() != ")":
                raise ValueError("unbalanced parenthesis")
            eat()
            return frag
        s, t = new_state(), new_state()
        if c == "[":
            eat()
            for ch in parse_class():
                add(s, ch, t)
        elif c == ".":
            eat()
            for o in range(32, 127):
                add(s, chr(o), t)
        elif c == "\\":
            eat()
            add(s, eat(), t)
        else:
            add(s, eat(), t)
        return s, t

    def quantified():
        s, t = atom()
        while peek() in ("*", "+", "?"):
            q = eat()
            ns, nt = new_state(), new_state()
            eps[ns].add(s)
            eps[t].add(nt)
            if q in ("*", "?"):
                eps[ns].add(nt)
            if q in ("*", "+"):
                eps[t].add(s)
            s, t = ns, nt
        return s, t

    def concat():
        s, t = quantified()
        while peek() is not None and peek() not in ")|":
            s2, t2 = quantified()
            eps[t].add(s2)
            t = t2
        return s, t

    def alternation():
        s, t = concat()
        while peek() == "|":
            eat()
            s2, t2 = concat()
            ns, nt = new_state(), new_state()
            eps[ns] |= {s, s2}
            eps[t].add(nt)
            eps[t2].add(nt)
            s, t = ns, nt
        return s, t

    start, end = alternation()
    if pos[0] != n:
        raise ValueError(f"trailing regex at {pos[0]}: "
                         f"{pattern[pos[0]:]!r}")
    return trans, eps, start, end


class CharDFA:
    """Subset-constructed character DFA of a regex pattern — the
    intermediate the token lift runs strings through."""

    def __init__(self, pattern: str):
        trans, eps, start, end = _parse_regex(pattern)

        def closure(states):
            out = set(states)
            stack = list(states)
            while stack:
                s = stack.pop()
                for t in eps[s]:
                    if t not in out:
                        out.add(t)
                        stack.append(t)
            return frozenset(out)

        start_set = closure({start})
        index = {start_set: 0}
        self.table: List[Dict[str, int]] = [{}]
        self.accepting: List[bool] = [end in start_set]
        work = [start_set]
        while work:
            cur = work.pop()
            i = index[cur]
            chars: Dict[str, set] = {}
            for s in cur:
                for ch, targets in trans[s].items():
                    chars.setdefault(ch, set()).update(targets)
            for ch, targets in chars.items():
                nxt = closure(targets)
                j = index.get(nxt)
                if j is None:
                    index[nxt] = j = len(self.table)
                    self.table.append({})
                    self.accepting.append(end in nxt)
                    work.append(nxt)
                self.table[i][ch] = j

    def run(self, state: int, text: str) -> int:
        """Advance ``state`` through ``text``; -1 = dead."""
        for ch in text:
            state = self.table[state].get(ch, -1)
            if state < 0:
                return -1
        return state


def dfa_from_regex(pattern: str,
                   token_strings: Sequence[str]) -> TokenDFA:
    """Compile ``pattern`` to a char DFA and LIFT it to token level
    over ``token_strings`` (token id -> its decoded string; empty
    strings — pad/special ids — are never admitted). Token ``t`` is
    admitted from state ``s`` iff running its whole string through the
    char DFA from ``s`` stays alive; the successor is where it lands.
    One ``(char_states, vocab)`` table build per grammar, amortized
    over every request that carries it."""
    cd = CharDFA(pattern)
    vocab = len(token_strings)
    table = np.full((len(cd.table), vocab), -1, np.int32)
    for t, text in enumerate(token_strings):
        if not text:
            continue
        for s in range(len(cd.table)):
            table[s, t] = cd.run(s, text)
    return TokenDFA(table, np.asarray(cd.accepting, bool))


_JSON_STRING = r'"[a-zA-Z0-9_ \-]*"'
_JSON_INT = r"(0|-?[1-9][0-9]*)"
_JSON_BOOL = r"(true|false)"

_RX_META = set("\\()[]{}|*+?.")


def _rx_escape(text: str) -> str:
    """Escape regex metacharacters so ``text`` matches LITERALLY in
    the rendered grammar — schema keys and enum values are data, not
    pattern (an unescaped ``+`` in an enum would quantify, a ``.``
    would wildcard, a ``(`` would crash the compile)."""
    return "".join("\\" + c if c in _RX_META else c for c in text)


def json_schema_dfa(schema: Dict,
                    token_strings: Sequence[str]) -> TokenDFA:
    """Compile a RESTRICTED JSON schema to a token DFA: an object with
    fixed ``properties`` of type string / integer / boolean / enum,
    rendered in the schema's (canonical) key order and delegated to
    :func:`dfa_from_regex`. The subset is deliberately small — enough
    for tool-call/extraction payloads; richer schemas compose their
    own regex and call :func:`dfa_from_regex` directly."""
    if schema.get("type") != "object":
        raise ValueError(
            f"json_schema_dfa: only object schemas are supported, got "
            f"type={schema.get('type')!r}")
    props = schema.get("properties") or {}
    if not props:
        raise ValueError("json_schema_dfa: object schema has no "
                         "properties")
    parts = []
    for key, spec in props.items():
        if "enum" in spec:
            vals = "|".join(
                f'"{_rx_escape(v)}"' if isinstance(v, str)
                else _rx_escape(str(v))
                for v in spec["enum"])
            val = f"({vals})"
        elif spec.get("type") == "string":
            val = _JSON_STRING
        elif spec.get("type") == "integer":
            val = _JSON_INT
        elif spec.get("type") == "boolean":
            val = _JSON_BOOL
        else:
            raise ValueError(
                f"json_schema_dfa: unsupported property type "
                f"{spec!r} for key {key!r}")
        parts.append(f'"{_rx_escape(key)}":{val}')
    pattern = r"\{" + ",".join(parts) + r"\}"
    return json_schema_pattern_dfa(pattern, token_strings)


def json_schema_pattern_dfa(pattern: str,
                            token_strings: Sequence[str]) -> TokenDFA:
    """The regex half of :func:`json_schema_dfa`, exposed so callers
    with richer schemas can render their own pattern and share the
    lift."""
    return dfa_from_regex(pattern, token_strings)
