"""Grammar-constrained structured output: token-mask automata for the
continuous batcher (PyTorch port of
``distributed_llms_tpu/runtime/constrain.py``).

JSON-schema / regex constraints reduce to a finite-state token-mask
automaton (Willard & Louf 2023, "Outlines"): compile the constraint to a
byte-level DFA, then lift it to TOKEN level against the serving
tokenizer's vocabulary — for every (DFA state, token id) pair, walking the
token's bytes through the char DFA either survives (token allowed; the
end state is the transition target) or dies (token masked).  The result
is two dense tables the decode step gathers from with no host work per
token:

- ``bias  [n_states, V] float32`` — 0 for allowed tokens, a -1e30 mask
  for forbidden ones (plus any per-request ``logit_bias``), applied as
  ``logits + bias[state]`` before sampling, so constrained and free rows
  share one decode step (free rows ride state 0, whose bias row is all
  zeros);
- ``next  [n_states, V] int32`` — the DFA transition per token (self-loop
  on EOS; 0 for masked tokens, which are never drawn).

Compilation is host-side numpy, paid once per (constraint, tokenizer)
pair and LRU-cached (``configure_cache``); the serving gateway builds the
automaton off its event loop (``asyncio.to_thread`` in runtime/server.py)
and hands it to the batcher's ``submit``.  The compiler, the tables, the
``MASK`` value, the tokenizer fingerprint and the cache keys are the
reference's, so both stacks compile a request to array-equal tables.

Per-request ``logit_bias`` / ``banned_tokens`` ride the SAME mechanism as
a 1-state automaton whose single bias row carries the bias values — no
second mask path exists anywhere in the engine.

Grammar subset (README "Structured output"):

- regex: literals, escapes (``\\d \\w \\s \\xNN`` + escaped specials),
  char classes ``[a-z0-9]`` / ``[^...]`` (byte-valued), ``.`` (any byte
  but newline), groups ``(...)``/``(?:...)``, alternation ``|``, and
  quantifiers ``* + ? {m} {m,} {m,n}`` (n <= 256).  Semantics are
  BYTE-level over the UTF-8 encoding.
- JSON schema: ``type`` object/array/string/integer/number/boolean/null,
  ``enum``/``const``, nested compositions, ``minLength``/``maxLength``
  (strings; default max 64), ``minItems``/``maxItems`` (arrays; default
  max 8), ``minimum >= 0``.  Every declared property must be listed in
  ``required``.  Output is canonical compact JSON.

Unsupported constructs raise :class:`ConstraintError` (a ``ValueError``:
the gateway answers a structured 400 before admission).

The decode step's two per-token operations, :func:`gather_bias` and
:func:`advance_states`, are torch indexing on the device (the reference
does them with XLA inside its jitted step): no kernel.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.observability import METRICS, get_logger

log = get_logger("constrain")

# Mask value for forbidden tokens.  Finite on purpose: -inf would turn a
# fully-masked garbage row (an inactive slot's junk compute) into NaNs in
# the softmax, while -1e30 merely drives its probability to exactly 0 in
# float32 — and it dominates every finite logit/penalty/bias adjustment.
MASK = np.float32(-1e30)

# Compile-size guards: a pathological pattern must fail loudly at compile,
# not wedge the serving front-end enumerating states.
_MAX_CHAR_STATES = 4096
_MAX_REPEAT = 256


class ConstraintError(ValueError):
    """Malformed or unsupported constraint — serving answers 400."""


# ---------------------------------------------------------------------------
# regex -> byte-level DFA
# ---------------------------------------------------------------------------

_SPECIALS = set("\\.*+?()[]{}|")
_ANY_BYTE = frozenset(range(256))
_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(
    list(range(ord("a"), ord("z") + 1)) + list(range(ord("A"), ord("Z") + 1))
    + list(_DIGITS) + [ord("_")]
)
_SPACE = frozenset(b" \t\n\r\f\v")


class _Parser:
    """Recursive-descent parser for the supported regex subset.  Produces
    an AST of tuples; all literals are BYTE sets (non-ASCII characters
    expand to their UTF-8 byte sequence)."""

    def __init__(self, pattern: str) -> None:
        self.p = pattern
        self.i = 0

    def error(self, msg: str) -> ConstraintError:
        return ConstraintError(
            f"regex error at offset {self.i}: {msg} (pattern {self.p!r})"
        )

    def peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self.alt()
        if self.i != len(self.p):
            raise self.error(f"unexpected {self.p[self.i]!r}")
        return node

    def alt(self):
        branches = [self.seq()]
        while self.peek() == "|":
            self.take()
            branches.append(self.seq())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def seq(self):
        items = []
        while self.peek() not in (None, "|", ")"):
            items.append(self.repeat())
        if not items:
            return ("seq", [])
        return items[0] if len(items) == 1 else ("seq", items)

    def repeat(self):
        node = self.atom()
        while True:
            c = self.peek()
            if c == "*":
                self.take()
                node = ("rep", node, 0, None)
            elif c == "+":
                self.take()
                node = ("rep", node, 1, None)
            elif c == "?":
                self.take()
                node = ("rep", node, 0, 1)
            elif c == "{":
                node = self.braces(node)
            else:
                return node

    def braces(self, node):
        self.take()  # '{'
        spec = ""
        while self.peek() not in (None, "}"):
            spec += self.take()
        if self.peek() != "}":
            raise self.error("unterminated {m,n}")
        self.take()
        try:
            if "," in spec:
                lo_s, hi_s = spec.split(",", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s.strip() else None
            else:
                lo = hi = int(spec)
        except ValueError:
            raise self.error(f"bad repetition {{{spec}}}") from None
        if lo < 0 or (hi is not None and (hi < lo or hi > _MAX_REPEAT)):
            raise self.error(
                f"repetition bounds {{{spec}}} out of range (max "
                f"{_MAX_REPEAT})"
            )
        return ("rep", node, lo, hi)

    def atom(self):
        c = self.peek()
        if c is None:
            raise self.error("dangling quantifier or empty atom")
        if c == "(":
            self.take()
            if self.p[self.i: self.i + 2] == "?:":
                self.i += 2
            node = self.alt()
            if self.peek() != ")":
                raise self.error("unbalanced '('")
            self.take()
            return node
        if c == "[":
            return ("lit", self.char_class())
        if c == ".":
            self.take()
            return ("lit", _ANY_BYTE - {ord("\n")})
        if c == "\\":
            return ("lit", frozenset(self.escape()))
        if c in ")|":
            raise self.error(f"unexpected {c!r}")
        if c in "*+?{}":
            raise self.error(f"dangling quantifier {c!r}")
        self.take()
        enc = c.encode("utf-8")
        if len(enc) == 1:
            return ("lit", frozenset(enc))
        # Multi-byte character: a fixed byte sequence.
        return ("seq", [("lit", frozenset([b])) for b in enc])

    def escape(self) -> frozenset:
        self.take()  # '\'
        c = self.peek()
        if c is None:
            raise self.error("dangling backslash")
        self.take()
        if c == "d":
            return _DIGITS
        if c == "w":
            return _WORD
        if c == "s":
            return _SPACE
        if c == "n":
            return frozenset([ord("\n")])
        if c == "t":
            return frozenset([ord("\t")])
        if c == "r":
            return frozenset([ord("\r")])
        if c == "f":
            return frozenset([ord("\f")])
        if c == "v":
            return frozenset([ord("\v")])
        if c == "0":
            return frozenset([0])
        if c == "x":
            hexpart = self.p[self.i: self.i + 2]
            if len(hexpart) != 2:
                raise self.error("\\x needs two hex digits")
            try:
                b = int(hexpart, 16)
            except ValueError:
                raise self.error(f"bad \\x escape {hexpart!r}") from None
            self.i += 2
            return frozenset([b])
        if c in ("D", "W", "S", "b", "B", "A", "Z"):
            raise ConstraintError(
                f"unsupported escape \\{c} (grammar subset: \\d \\w \\s, "
                f"\\xNN, and escaped literals)"
            )
        enc = c.encode("utf-8")
        if len(enc) != 1:
            raise self.error(f"cannot escape multi-byte character {c!r}")
        return frozenset(enc)

    def char_class(self) -> frozenset:
        self.take()  # '['
        negate = self.peek() == "^"
        if negate:
            self.take()
        out: set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise self.error("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            if c == "\\":
                charset = self.escape()
                if len(charset) == 1 and self.peek() == "-" \
                        and self.p[self.i + 1: self.i + 2] not in ("]", ""):
                    lo = next(iter(charset))
                    self.take()  # '-'
                    hi = self._class_byte()
                    if hi < lo:
                        raise self.error("reversed class range")
                    out.update(range(lo, hi + 1))
                else:
                    out.update(charset)
                continue
            lo = self._class_byte()
            if self.peek() == "-" and self.p[self.i + 1: self.i + 2] \
                    not in ("]", ""):
                self.take()  # '-'
                hi = self._class_byte()
                if hi < lo:
                    raise self.error("reversed class range")
                out.update(range(lo, hi + 1))
            else:
                out.add(lo)
        return frozenset(_ANY_BYTE - out) if negate else frozenset(out)

    def _class_byte(self) -> int:
        c = self.peek()
        if c == "\\":
            charset = self.escape()
            if len(charset) != 1:
                raise self.error("class range endpoint must be one byte")
            return next(iter(charset))
        self.take()
        enc = c.encode("utf-8")
        if len(enc) != 1:
            raise self.error(
                f"non-ASCII character {c!r} in class (use explicit byte "
                f"escapes)"
            )
        return enc[0]


def _nfa(node, eps, trans, counter):
    """Thompson construction: returns (start, end) for ``node``.  ``eps``
    maps state -> set of epsilon targets; ``trans`` maps state -> list of
    (byteset, target)."""

    def new():
        counter[0] += 1
        return counter[0] - 1

    kind = node[0]
    if kind == "lit":
        s, e = new(), new()
        trans.setdefault(s, []).append((node[1], e))
        return s, e
    if kind == "seq":
        s = e = new()
        for item in node[1]:
            si, ei = _nfa(item, eps, trans, counter)
            eps.setdefault(e, set()).add(si)
            e = ei
        return s, e
    if kind == "alt":
        s, e = new(), new()
        for item in node[1]:
            si, ei = _nfa(item, eps, trans, counter)
            eps.setdefault(s, set()).add(si)
            eps.setdefault(ei, set()).add(e)
        return s, e
    if kind == "rep":
        _, inner, lo, hi = node
        s = e = new()
        for _ in range(lo):
            si, ei = _nfa(inner, eps, trans, counter)
            eps.setdefault(e, set()).add(si)
            e = ei
        if hi is None:  # unbounded tail: one star
            si, ei = _nfa(inner, eps, trans, counter)
            eps.setdefault(e, set()).add(si)
            eps.setdefault(ei, set()).add(si)
            tail = new()
            eps.setdefault(e, set()).add(tail)
            eps.setdefault(ei, set()).add(tail)
            return s, tail
        tail = new()
        eps.setdefault(e, set()).add(tail)
        for _ in range(hi - lo):
            si, ei = _nfa(inner, eps, trans, counter)
            eps.setdefault(e, set()).add(si)
            e = ei
            eps.setdefault(e, set()).add(tail)
        return s, tail
    raise AssertionError(f"unknown AST node {kind!r}")


@dataclass(frozen=True)
class CharDFA:
    """Byte-level DFA: ``trans [n, 256] int32`` (-1 = dead) + accepting
    states.  State 0 is the start state; dead-end states (no path to any
    accept) are pruned, so every live state either accepts or has at
    least one outgoing byte."""

    trans: np.ndarray   # [n, 256] int32, -1 = no transition
    accept: np.ndarray  # [n] bool


def regex_to_char_dfa(pattern: str) -> CharDFA:
    """Compile the regex subset to a pruned byte-level DFA (full-match
    semantics — no anchors needed or supported)."""
    ast = _Parser(pattern).parse()
    eps: dict[int, set[int]] = {}
    trans: dict[int, list] = {}
    counter = [0]
    start, end = _nfa(ast, eps, trans, counter)

    def closure(states: frozenset) -> frozenset:
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in eps.get(s, ()):
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = closure(frozenset([start]))
    index = {start_set: 0}
    order = [start_set]
    rows: list[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        # Byte -> union of NFA targets, built per distinct byteset first.
        per_byte: list[set[int] | None] = [None] * 256
        for s in cur:
            for byteset, tgt in trans.get(s, ()):
                for b in byteset:
                    if per_byte[b] is None:
                        per_byte[b] = set()
                    per_byte[b].add(tgt)
        row = np.full((256,), -1, np.int32)
        memo: dict[frozenset, int] = {}
        for b in range(256):
            tgts = per_byte[b]
            if not tgts:
                continue
            key = frozenset(tgts)
            if key in memo:
                row[b] = memo[key]
                continue
            nxt = closure(key)
            if nxt not in index:
                if len(index) >= _MAX_CHAR_STATES:
                    raise ConstraintError(
                        f"constraint automaton exceeds {_MAX_CHAR_STATES} "
                        f"states; simplify the pattern/schema"
                    )
                index[nxt] = len(order)
                order.append(nxt)
            memo[key] = row[b] = index[nxt]
        rows.append(row)
    tmat = np.stack(rows) if rows else np.full((1, 256), -1, np.int32)
    accept = np.array([end in st for st in order], bool)
    if not accept.any():
        raise ConstraintError(f"regex {pattern!r} matches nothing")
    # Prune dead states (no path to an accept): reverse reachability.
    n = len(order)
    live = accept.copy()
    changed = True
    while changed:
        changed = False
        reaches = live[np.where(tmat >= 0, tmat, 0)] & (tmat >= 0)
        new_live = live | reaches.any(axis=1)
        if (new_live != live).any():
            live, changed = new_live, True
    if not live[0]:
        raise ConstraintError(f"regex {pattern!r} matches nothing")
    dead_tgt = ~live[np.where(tmat >= 0, tmat, 0)]
    tmat = np.where((tmat >= 0) & ~dead_tgt, tmat, -1).astype(np.int32)
    return CharDFA(trans=tmat, accept=accept)


def char_dfa_matches(dfa: CharDFA, data: bytes) -> bool:
    """Host-side full-match check (tests + the bench row's validation)."""
    s = 0
    for b in data:
        s = int(dfa.trans[s, b])
        if s < 0:
            return False
    return bool(dfa.accept[s])


# ---------------------------------------------------------------------------
# JSON schema -> regex
# ---------------------------------------------------------------------------

def _re_escape(s: str) -> str:
    return "".join("\\" + c if c in _SPECIALS else c for c in s)


def _json_literal_regex(value) -> str:
    try:
        text = json.dumps(value, separators=(",", ":"), ensure_ascii=False)
    except (TypeError, ValueError) as e:
        raise ConstraintError(f"unserializable enum/const value: {e}") from e
    return _re_escape(text)

# JSON string body bytes: printable ASCII minus '"' and '\'.  No escape
# sequences and no bytes >= 0x80 in GENERATED strings: a byte-level
# character class cannot enforce multi-byte UTF-8 SEQUENCING, and a lone
# high byte would make the output invalid UTF-8 — ASCII-only is what
# keeps every completion json.loads-able and schema-valid (byte length
# == character length, too).
_STRING_CHAR = '[^"\\\\\\x00-\\x1f\\x7f-\\xff]'

# ALLOWLIST, not a blocklist: a constraint keyword this compiler does not
# enforce (maximum, pattern, multipleOf, format, ...) must 400, never be
# silently ignored — the whole point of the feature is that the output
# provably satisfies the schema the caller sent.  Annotation-only keys
# ride along harmlessly.
_ALLOWED_KEYS = frozenset({
    "type", "enum", "const", "properties", "required", "items",
    "minLength", "maxLength", "minItems", "maxItems", "minimum",
    "additionalProperties", "title", "description", "$schema",
})


def schema_to_regex(schema) -> str:
    """Compile the supported JSON-schema subset to a regex over canonical
    compact JSON (module docstring lists the subset; anything else raises
    :class:`ConstraintError`)."""
    if not isinstance(schema, dict):
        raise ConstraintError("schema must be a JSON object")
    unknown = set(schema) - _ALLOWED_KEYS
    if unknown:
        raise ConstraintError(
            f"unsupported schema keyword(s) {sorted(unknown)} — the "
            f"grammar cannot enforce them, and silently ignoring a "
            f"constraint would emit output that violates the schema"
        )
    if schema.get("additionalProperties") not in (None, False, {}):
        # Generated objects are CLOSED by construction, so `false` is
        # exactly what the grammar already guarantees; anything else
        # would require enforcing an open-object grammar we don't have.
        raise ConstraintError(
            "additionalProperties must be false (generated objects are "
            "closed: exactly the declared required properties)"
        )
    if "const" in schema:
        return _json_literal_regex(schema["const"])
    if "enum" in schema:
        options = schema["enum"]
        if not isinstance(options, list) or not options:
            raise ConstraintError("'enum' must be a non-empty list")
        return "(?:" + "|".join(_json_literal_regex(v) for v in options) + ")"
    t = schema.get("type")
    if t not in ("integer", "number") and schema.get("minimum") is not None:
        raise ConstraintError("'minimum' applies to integer/number only")
    if t == "string":
        # BYTE lengths over the UTF-8 encoding — the automaton runs at
        # byte level, and validates() checks the same measure.
        lo = int(schema.get("minLength", 0))
        hi = int(schema.get("maxLength", 64))
        if not 0 <= lo <= hi or hi > _MAX_REPEAT:
            raise ConstraintError(
                f"string length bounds [{lo}, {hi}] out of range "
                f"(max {_MAX_REPEAT})"
            )
        return f'"{_STRING_CHAR}{{{lo},{hi}}}"'
    if t in ("integer", "number"):
        # The only enforceable bound is non-negativity: 'minimum': 0
        # drops the minus sign.  Any other value would admit outputs the
        # schema rejects (the digit grammar cannot count magnitudes), so
        # it 400s instead of silently under-constraining.
        minimum = schema.get("minimum")
        if minimum not in (None, 0):
            raise ConstraintError(
                f"'minimum' must be 0 or absent (got {minimum!r}) — the "
                f"digit grammar can only enforce non-negativity"
            )
        sign = "" if minimum == 0 else "-?"
        # Bounded digit count keeps the language finite, so every greedy
        # path reaches an accept state within a known budget.
        body = f"{sign}(?:0|[1-9][0-9]{{0,14}})"
        if t == "integer":
            return body
        return f"{body}(?:\\.[0-9]{{1,6}})?"
    if t == "boolean":
        return "(?:true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = schema_to_regex(schema.get("items", {"type": "null"}))
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", 8))
        if not 0 <= lo <= hi or hi > 64:
            raise ConstraintError(
                f"array bounds [{lo}, {hi}] out of range (max 64 items)"
            )
        if hi == 0:
            return "\\[\\]"
        core = f"{item}(?:,{item}){{{max(lo - 1, 0)},{hi - 1}}}"
        return f"\\[(?:{core})?\\]" if lo == 0 else f"\\[{core}\\]"
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict):
            raise ConstraintError("'properties' must be an object")
        required = schema.get("required", [])
        if set(props) != set(required):
            raise ConstraintError(
                "grammar subset: every declared property must be listed in "
                "'required' (optional properties are not supported)"
            )
        if not props:
            return "\\{\\}"
        parts = [
            f'"{_re_escape(k)}":{schema_to_regex(v)}'
            for k, v in props.items()
        ]
        return "\\{" + ",".join(parts) + "\\}"
    raise ConstraintError(
        f"unsupported schema type {t!r} (grammar subset: object/array/"
        f"string/integer/number/boolean/null/enum/const)"
    )


def validates(schema, value) -> bool:
    """Host-side instance check for the SAME subset ``schema_to_regex``
    compiles — the tests' and bench row's parse-valid oracle."""
    if "const" in schema:
        return value == schema["const"]
    if "enum" in schema:
        return value in schema["enum"]
    t = schema.get("type")
    if t == "string":
        # Byte lengths over UTF-8, matching the grammar's measure.
        return (isinstance(value, str)
                and int(schema.get("minLength", 0))
                <= len(value.encode("utf-8"))
                <= int(schema.get("maxLength", 64)))
    if t == "integer":
        return (isinstance(value, int) and not isinstance(value, bool)
                and value >= float(schema.get("minimum", float("-inf"))))
    if t == "number":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool)
                and value >= float(schema.get("minimum", float("-inf"))))
    if t == "boolean":
        return isinstance(value, bool)
    if t == "null":
        return value is None
    if t == "array":
        return (isinstance(value, list)
                and int(schema.get("minItems", 0)) <= len(value)
                <= int(schema.get("maxItems", 8))
                and all(validates(schema.get("items", {"type": "null"}), v)
                        for v in value))
    if t == "object":
        props = schema.get("properties", {})
        return (isinstance(value, dict) and set(value) == set(props)
                and all(validates(props[k], value[k]) for k in value))
    return False


# ---------------------------------------------------------------------------
# token-level automaton
# ---------------------------------------------------------------------------

def _token_byte_table(tokenizer, vocab_size: int):
    """(bytes matrix [V, Lmax] int16 (-1 pad), lengths [V], fingerprint).
    Cached on the tokenizer object — built once per (tokenizer, vocab)."""
    cached = getattr(tokenizer, "_constrain_token_bytes", None)
    if cached is not None and cached[0] == vocab_size:
        return cached[1], cached[2], cached[3]
    rows: list[bytes] = []
    for i in range(vocab_size):
        tb = getattr(tokenizer, "token_bytes", None)
        raw = tb(i) if tb is not None else None
        if raw is None and tb is None and i < getattr(
                tokenizer, "vocab_size", 0):
            # Best-effort fallback for tokenizers without token_bytes.
            try:
                s = tokenizer.decode([i])
                raw = s.encode("utf-8") if s else None
            except Exception:
                raw = None
        rows.append(raw or b"")
    lens = np.array([len(r) for r in rows], np.int32)
    lmax = max(1, int(lens.max()))
    mat = np.full((vocab_size, lmax), -1, np.int16)
    for i, r in enumerate(rows):
        if r:
            mat[i, : len(r)] = np.frombuffer(r, np.uint8)
    fp = hashlib.blake2b(mat.tobytes(), digest_size=12).hexdigest()
    try:
        tokenizer._constrain_token_bytes = (vocab_size, mat, lens, fp)
    except Exception:  # a slotted/frozen tokenizer just recomputes
        pass
    return mat, lens, fp


@dataclass
class TokenDFA:
    """Token-level mask automaton.  ``bias[s]`` is the additive logit mask
    for state ``s`` (0 allowed / MASK forbidden, plus any logit_bias);
    ``next[s, t]`` the transition (EOS self-loops; masked entries are 0
    and never taken).  State 0 is the start state.  ``pattern`` is the
    source regex ("" for a pure bias/ban automaton)."""

    bias: np.ndarray     # [n_states, V] float32
    next: np.ndarray     # [n_states, V] int32
    accept: np.ndarray   # [n_states] bool
    allowed: np.ndarray  # [n_states, V] bool (pre-bias mask)
    eos_id: int
    pattern: str = ""

    @property
    def n_states(self) -> int:
        return self.bias.shape[0]

    def advance(self, state: int, toks) -> int:
        """Host-side replay: the DFA state after emitting ``toks`` from
        ``state``.  Preemption/swap resume rebuilds a row's device state
        this way — the state is a pure function of the emitted tokens, so
        nothing extra rides the requeued request."""
        for t in toks:
            t = int(t)
            if t == self.eos_id:
                return state
            if not self.allowed[state, t]:
                # Every emitted token was drawn under this mask; a miss
                # means the caller replayed a foreign stream.  Hold state
                # (masking stays sound) and say so.
                log.warning(
                    "DFA replay: token %d not allowed in state %d", t, state
                )
                return state
            state = int(self.next[state, t])
        return state

    def bias_row(self, state: int) -> np.ndarray:
        return self.bias[state]


def _lift_to_tokens(cdfa: CharDFA, token_mat: np.ndarray,
                    token_lens: np.ndarray, eos_id: int,
                    vocab_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Walk every token's bytes through the char DFA from every state.
    Returns (allowed [n, V] bool, next [n, V] int32)."""
    n = cdfa.trans.shape[0]
    v = vocab_size
    allowed = np.zeros((n, v), bool)
    nxt = np.zeros((n, v), np.int32)
    lmax = token_mat.shape[1]
    has_bytes = token_lens > 0
    for s in range(n):
        cur = np.full((v,), s, np.int32)
        alive = has_bytes.copy()
        for p in range(lmax):
            col = token_mat[:, p]
            step = alive & (col >= 0)
            if not step.any():
                break
            tgt = cdfa.trans[cur[step], col[step].astype(np.int32)]
            cur[step] = tgt
            dead = np.zeros_like(alive)
            dead[step] = tgt < 0
            alive &= ~dead
        allowed[s] = alive
        nxt[s] = np.where(alive, np.maximum(cur, 0), 0)
    if 0 <= eos_id < v:
        allowed[:, eos_id] = cdfa.accept
        nxt[:, eos_id] = np.arange(n)
    return allowed, nxt


def _build_token_dfa(pattern: str, tokenizer, vocab_size: int,
                     eos_id: int) -> TokenDFA:
    cdfa = regex_to_char_dfa(pattern)
    token_mat, token_lens, _fp = _token_byte_table(tokenizer, vocab_size)
    allowed, nxt = _lift_to_tokens(
        cdfa, token_mat, token_lens, eos_id, vocab_size
    )
    # Reachability check AT TOKEN level: a state the decode can reach must
    # always offer at least one token (or EOS) — a byte path no token
    # realizes would otherwise dead-end the row mid-generation.
    reach = np.zeros((cdfa.trans.shape[0],), bool)
    reach[0] = True
    frontier = [0]
    while frontier:
        s = frontier.pop()
        if not allowed[s].any():
            raise ConstraintError(
                "tokenizer cannot realize this constraint: automaton state "
                f"{s} (pattern {pattern!r}) allows no token and no EOS"
            )
        for t in np.unique(nxt[s][allowed[s]]):
            if not reach[t]:
                reach[t] = True
                frontier.append(int(t))
    bias = np.where(allowed, np.float32(0.0), MASK).astype(np.float32)
    return TokenDFA(bias=bias, next=nxt, accept=cdfa.accept,
                    allowed=allowed, eos_id=eos_id, pattern=pattern)


# ---------------------------------------------------------------------------
# request-level compile + LRU cache
# ---------------------------------------------------------------------------

class _LRU:
    """Tiny thread-safe LRU for compiled automata (compile is host numpy
    work measured in ms-to-seconds; serving must pay it once per
    (constraint, tokenizer) pair)."""

    def __init__(self, capacity: int = 64) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        self._data: dict = {}
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            if key in self._data:
                val = self._data.pop(key)
                self._data[key] = val  # move to MRU
                self.hits += 1
                return val
            self.misses += 1
            return None

    def put(self, key, val) -> None:
        with self._lock:
            self._data.pop(key, None)
            self._data[key] = val
            while len(self._data) > max(1, self.capacity):
                self._data.pop(next(iter(self._data)))

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = 0
            self.misses = 0


_CACHE = _LRU(64)


def configure_cache(capacity: int) -> None:
    """Resize the compile cache (``RuntimeConfig.constrain_cache_size`` /
    ``dlt-serve --constrain-cache``)."""
    if capacity < 1:
        raise ValueError(f"constrain cache capacity must be >= 1, got "
                         f"{capacity}")
    _CACHE.capacity = int(capacity)


def cache_stats() -> dict[str, int]:
    return {"hits": _CACHE.hits, "misses": _CACHE.misses,
            "size": len(_CACHE._data), "capacity": _CACHE.capacity}


def clear_cache() -> None:
    _CACHE.clear()


def _canon_response_format(response_format) -> tuple[str, str]:
    """Validate + canonicalize a ``response_format`` field.  Returns
    (kind, pattern): kind "regex"|"json_schema", pattern the regex to
    compile (schemas compile through :func:`schema_to_regex`)."""
    if not isinstance(response_format, dict):
        raise ConstraintError("'response_format' must be an object")
    kind = response_format.get("type")
    if kind == "regex":
        pattern = response_format.get("regex")
        if not isinstance(pattern, str) or not pattern:
            raise ConstraintError(
                "response_format.type 'regex' needs a non-empty 'regex' "
                "string"
            )
        return "regex", pattern
    if kind == "json_schema":
        spec = response_format.get("json_schema")
        if isinstance(spec, dict) and "schema" in spec:
            spec = spec["schema"]  # OpenAI nests {name, schema}
        if spec is None:
            spec = response_format.get("schema")
        if not isinstance(spec, dict):
            raise ConstraintError(
                "response_format.type 'json_schema' needs a 'json_schema' "
                "(or 'schema') object"
            )
        return "json_schema", schema_to_regex(spec)
    raise ConstraintError(
        f"response_format.type must be 'json_schema' or 'regex', got "
        f"{kind!r}"
    )


def _canon_bias(logit_bias, banned_tokens, vocab_size: int):
    """Validate logit_bias/banned_tokens.  Returns (bias items tuple,
    banned tuple) in canonical order."""
    items: list[tuple[int, float]] = []
    if logit_bias is not None:
        if not isinstance(logit_bias, dict) or not logit_bias:
            raise ConstraintError(
                "'logit_bias' must be a non-empty object of token id -> "
                "bias"
            )
        for k, val in logit_bias.items():
            try:
                tid = int(k)
            except (TypeError, ValueError):
                raise ConstraintError(
                    f"logit_bias key {k!r} is not a token id"
                ) from None
            if not 0 <= tid < vocab_size:
                raise ConstraintError(
                    f"logit_bias token {tid} outside vocab [0, {vocab_size})"
                )
            if isinstance(val, bool) or not isinstance(val, (int, float)) \
                    or not np.isfinite(val) or not -100.0 <= val <= 100.0:
                raise ConstraintError(
                    f"logit_bias value for token {tid} must be a finite "
                    f"number in [-100, 100], got {val!r}"
                )
            items.append((tid, float(val)))
    banned: list[int] = []
    if banned_tokens is not None:
        if not isinstance(banned_tokens, (list, tuple)) or not banned_tokens:
            raise ConstraintError(
                "'banned_tokens' must be a non-empty list of token ids"
            )
        for t in banned_tokens:
            if isinstance(t, bool) or not isinstance(t, int) \
                    or not 0 <= t < vocab_size:
                raise ConstraintError(
                    f"banned token {t!r} outside vocab [0, {vocab_size})"
                )
            banned.append(t)
    return tuple(sorted(set(items))), tuple(sorted(set(banned)))


def compile_request(response_format=None, logit_bias=None,
                    banned_tokens=None, *, tokenizer=None,
                    vocab_size: int, eos_id: int) -> TokenDFA | None:
    """THE front door: compile a request's constraint surface into one
    TokenDFA (or None when the request carries none).  Grammar constraints
    (``response_format``) and the bias ride-alongs fold into the SAME
    automaton: a pure logit_bias/ban request compiles to a 1-state DFA
    whose single bias row carries the values.  LRU-cached; raises
    :class:`ConstraintError` on malformed input (serving answers 400
    before admission)."""
    bias_items, banned = _canon_bias(logit_bias, banned_tokens, vocab_size)
    if response_format is None and not bias_items and not banned:
        return None
    pattern = ""
    if response_format is not None:
        kind, pattern = _canon_response_format(response_format)
        if tokenizer is None:
            raise ConstraintError(
                "constrained decoding needs a tokenizer (token-level masks "
                "are built against the vocabulary)"
            )
        if eos_id < 0:
            raise ConstraintError(
                "constrained decoding needs an EOS token to terminate "
                "accepted outputs (engine has eos_id < 0)"
            )
        del kind
    _, _, tok_fp = (_token_byte_table(tokenizer, vocab_size)
                    if response_format is not None else (None, None, "-"))
    key = (pattern, bias_items, banned, tok_fp, vocab_size, eos_id)
    hit = _CACHE.get(key)
    if hit is not None:
        METRICS.inc("batcher.constrain.cache_hits")
        return hit
    METRICS.inc("batcher.constrain.cache_misses")
    t0 = time.perf_counter()
    if response_format is not None:
        dfa = _build_token_dfa(pattern, tokenizer, vocab_size, eos_id)
    else:
        bias = np.zeros((1, vocab_size), np.float32)
        dfa = TokenDFA(
            bias=bias, next=np.zeros((1, vocab_size), np.int32),
            accept=np.ones((1,), bool),
            allowed=np.ones((1, vocab_size), bool), eos_id=eos_id,
        )
    if bias_items or banned:
        bias = dfa.bias.copy()
        allowed = dfa.allowed
        for tid, val in bias_items:
            # Bias applies only where the grammar already allows the
            # token — it must never resurrect a forbidden one.
            bias[:, tid] = np.where(allowed[:, tid], bias[:, tid] + val,
                                    bias[:, tid])
        for tid in banned:
            bias[:, tid] = MASK
        if banned:
            # A ban must not dead-end the automaton.
            ok = (bias > MASK / 2).any(axis=1)
            if not ok.all():
                raise ConstraintError(
                    "banned_tokens leave an automaton state with no "
                    "allowed token"
                )
        dfa = TokenDFA(bias=bias, next=dfa.next, accept=dfa.accept,
                       allowed=allowed, eos_id=eos_id, pattern=dfa.pattern)
    METRICS.observe(
        "batcher.constrain.compile_seconds", time.perf_counter() - t0
    )
    _CACHE.put(key, dfa)
    return dfa


# ---------------------------------------------------------------------------
# span-stack assembly (host) + the jitted gather/advance leg
# ---------------------------------------------------------------------------

def build_stack(dfas: list[TokenDFA], vocab_size: int,
                pad_states_to: int | None = None):
    """Concatenate the live rows' automata into ONE (bias, next) stack the
    decode step gathers from.  State 0 is the shared FREE state (zero
    bias, self-loop) unconstrained rows ride; automaton ``i``'s states
    occupy ``[offsets[i], offsets[i] + n_i)`` with transitions rebased to
    absolute indices.  ``pad_states_to`` pads the state axis (dead all-
    free states) so the stack walks a closed shape ladder — the compile
    key must not change with the mix of live schemas."""
    total = 1 + sum(d.n_states for d in dfas)
    n = max(total, pad_states_to or 0)
    bias = np.zeros((n, vocab_size), np.float32)
    nxt = np.zeros((n, vocab_size), np.int32)
    offsets: list[int] = []
    at = 1
    for d in dfas:
        offsets.append(at)
        k = d.n_states
        bias[at: at + k] = d.bias
        # One rebase covers every transition, EOS self-loops included
        # (the automaton stores next[s, eos] = s, so s + at is the
        # absolute self-loop).
        nxt[at: at + k] = np.where(d.allowed, d.next + at, 0)
        at += k
    return bias, nxt, offsets


def gather_bias(mask_stack: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """[S, V] stack x [B] states -> [B, V] additive logit mask (the
    decode step's per-row constraint gather)."""
    return mask_stack[state.long()]


def advance_states(next_stack: torch.Tensor, state: torch.Tensor,
                   tok: torch.Tensor) -> torch.Tensor:
    """[S, V] transitions x [B] states x [B] sampled tokens -> [B] next
    states: the DFA advance inside the decode step (one gather; the state
    stays on the device across dispatched-ahead chunks)."""
    return next_stack[state.long(), tok.long()]
