"""Encrypted regex matching (counterpart of `tfhe_tpu/examples/regex_engine.py`;
reference tfhe/examples/regex_engine/).

A pattern compiles to an NFA; matching an encrypted ASCII string keeps one
encrypted boolean per NFA state and advances them per character:

    next[s'] = OR over transitions (state[s] AND char == c)

Pattern forms (reference parser.rs:149-188):
  * "/pattern/"   — substring match (reference `has_match` semantics);
    optional `^` / `$` anchors pin the match to the start / end of the
    content, and a trailing `i` (``/pattern/i``) makes it case-insensitive.
  * "pattern"     — legacy whole-string match (equivalent to /^pattern$/).

Syntax: literals, `\\<char>` escapes, `.`, classes `[abc]` / ranges
`[a-z]` / negated `[^...]`, `*`, `+`, `?`, counted repetition `{n}`,
`{n,}`, `{n,m}`, alternation `|`, grouping `(...)` — the reference
parser.rs feature set.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import torch

from ..core.entities import LweCiphertext
from ..shortint.client_key import delta_for

EPS = None  # epsilon transition label

_PRINTABLE = frozenset(chr(x) for x in range(32, 127))


@dataclass
class Nfa:
    start: int
    accept: int
    # transitions: (src, label, dst); label = frozenset of accepted chars or EPS
    edges: List[Tuple[int, Optional[frozenset], int]] = field(default_factory=list)
    n: int = 0


class _Parser:
    """Thompson construction (grammar per reference parser.rs:190-210)."""

    def __init__(self, pattern: str, case_insensitive: bool = False):
        self.p = pattern
        self.i = 0
        self.edges = []
        self.n = 0
        self.ci = case_insensitive

    def new_state(self):
        self.n += 1
        return self.n - 1

    def parse(self) -> Nfa:
        s, a = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r}")
        return Nfa(start=s, accept=a, edges=self.edges, n=self.n)

    def _alt(self):
        s, a = self._concat()
        while self.i < len(self.p) and self.p[self.i] == "|":
            self.i += 1
            s2, a2 = self._concat()
            ns, na = self.new_state(), self.new_state()
            self.edges += [(ns, EPS, s), (ns, EPS, s2), (a, EPS, na), (a2, EPS, na)]
            s, a = ns, na
        return s, a

    def _concat(self):
        frags = []
        while self.i < len(self.p) and self.p[self.i] not in "|)":
            frags.append(self._repeat())
        if not frags:
            s = self.new_state()
            return s, s
        s, a = frags[0]
        for s2, a2 in frags[1:]:
            self.edges.append((a, EPS, s2))
            a = a2
        return s, a

    def _instantiate(self, span: str):
        """Re-parse a pattern span as a fresh sub-fragment (fragment
        duplication for counted repetition)."""
        save_p, save_i = self.p, self.i
        self.p, self.i = span, 0
        s, a = self._alt()
        assert self.i == len(span)
        self.p, self.i = save_p, save_i
        return s, a

    def _optional_copy(self, span: str):
        s, a = self._instantiate(span)
        ns, na = self.new_state(), self.new_state()
        self.edges += [(ns, EPS, s), (ns, EPS, na), (a, EPS, na)]
        return ns, na

    def _star_copy(self, span: str):
        s, a = self._instantiate(span)
        ns, na = self.new_state(), self.new_state()
        self.edges += [(ns, EPS, s), (ns, EPS, na), (a, EPS, s), (a, EPS, na)]
        return ns, na

    def _repeat(self):
        frag_start = self.i
        s, a = self._atom()
        while self.i < len(self.p) and self.p[self.i] in "*+?{":
            op = self.p[self.i]
            span = self.p[frag_start:self.i]
            self.i += 1
            if op == "{":
                # counted repetition {n} / {n,} / {n,m}
                # (reference parser.rs:309-345 Repeated{at_least, at_most})
                j = self.p.index("}", self.i)
                spec = self.p[self.i:j]
                self.i = j + 1
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s) if lo_s else 0
                    hi = int(hi_s) if hi_s else None
                else:
                    lo = hi = int(spec)
                parts = [self._instantiate(span) for _ in range(lo)]
                if hi is None:
                    parts.append(self._star_copy(span))
                else:
                    if hi < lo:
                        raise ValueError(f"bad repetition bounds {{{spec}}}")
                    parts += [self._optional_copy(span)
                              for _ in range(hi - lo)]
                if not parts:
                    ns = self.new_state()
                    s = a = ns
                else:
                    s, a = parts[0]
                    for s2, a2 in parts[1:]:
                        self.edges.append((a, EPS, s2))
                        a = a2
                continue
            ns, na = self.new_state(), self.new_state()
            if op == "*":
                self.edges += [(ns, EPS, s), (ns, EPS, na), (a, EPS, s), (a, EPS, na)]
            elif op == "+":
                self.edges += [(ns, EPS, s), (a, EPS, s), (a, EPS, na)]
            else:
                self.edges += [(ns, EPS, s), (ns, EPS, na), (a, EPS, na)]
            s, a = ns, na
        return s, a

    def _fold_case(self, chars):
        if not self.ci:
            return frozenset(chars)
        out = set()
        for c in chars:
            out.add(c.lower())
            out.add(c.upper())
        return frozenset(out)

    def _atom(self):
        c = self.p[self.i]
        if c == "\\":
            # escaped literal: \<any char> (reference parser.rs:267)
            if self.i + 1 >= len(self.p):
                raise ValueError("dangling escape")
            lit = self.p[self.i + 1]
            self.i += 2
            return self._edge(self._fold_case([lit]))
        if c == "(":
            self.i += 1
            s, a = self._alt()
            assert self.p[self.i] == ")", "unbalanced parens"
            self.i += 1
            return s, a
        if c == "[":
            j = self.p.index("]", self.i)
            spec = self.p[self.i + 1:j]
            self.i = j + 1
            negated = spec.startswith("^")
            if negated:
                spec = spec[1:]
            chars = set()
            k = 0
            while k < len(spec):
                if spec[k] == "\\" and k + 1 < len(spec):
                    chars.add(spec[k + 1])
                    k += 2
                elif k + 2 < len(spec) and spec[k + 1] == "-":
                    chars.update(chr(x) for x in range(ord(spec[k]), ord(spec[k + 2]) + 1))
                    k += 3
                else:
                    chars.add(spec[k])
                    k += 1
            chars = self._fold_case(chars)
            if negated:      # [^...] (reference RegExpr::Not)
                chars = _PRINTABLE - chars
            return self._edge(frozenset(chars))
        if c == ".":
            self.i += 1
            return self._edge(_PRINTABLE)
        self.i += 1
        return self._edge(self._fold_case([c]))

    def _edge(self, label):
        s, a = self.new_state(), self.new_state()
        self.edges.append((s, label, a))
        return s, a


def _eps_closure(nfa: Nfa, states: Set[int]) -> Set[int]:
    todo = list(states)
    out = set(states)
    while todo:
        s = todo.pop()
        for (src, lbl, dst) in nfa.edges:
            if src == s and lbl is EPS and dst not in out:
                out.add(dst)
                todo.append(dst)
    return out


def _parse_pattern(pattern: str):
    """→ (Nfa, anchored_start, anchored_end).

    `/pat/` (+ optional `i` flag) = substring semantics with optional
    anchors; a bare pattern keeps the legacy whole-string semantics."""
    if len(pattern) >= 2 and pattern.startswith("/"):
        end = pattern.rfind("/")
        if end == 0:
            raise ValueError("unterminated /pattern/")
        flags = pattern[end + 1:]
        if flags not in ("", "i"):
            raise ValueError(f"unknown flags {flags!r}")
        body = pattern[1:end]
        sof = body.startswith("^")
        if sof:
            body = body[1:]
        eof = body.endswith("$") and not body.endswith("\\$")
        if eof:
            body = body[:-1]
        nfa = _Parser(body, case_insensitive=(flags == "i")).parse()
        return nfa, sof, eof
    return _Parser(pattern).parse(), True, True


def regex_match_radix(isk, pattern: str,
                      enc_string: List) -> object:
    """Match over a list of RadixCiphertext ASCII chars.

    Returns an encrypted boolean block: 1 iff the pattern matches (under
    the pattern form's anchor semantics — see module docstring)."""
    nfa, sof, eof = _parse_pattern(pattern)
    ssk = isk.key

    active: Dict[int, object] = {}
    init = _eps_closure(nfa, {nfa.start})

    def trivial_bit(template, v: int):
        """A noiseless block of v (0 or 1) shaped as `template`, on its device."""
        data = torch.zeros_like(template.lwe.data)
        data[..., -1] = v * delta_for(ssk.params)
        return template.with_(lwe=LweCiphertext(data=data), degree=v)

    template = enc_string[0].blocks[0]
    one = trivial_bit(template, 1)
    for s in init:
        active[s] = one

    # empty-pattern / empty-prefix match at position 0
    matched = one if nfa.accept in init else None

    for enc_char in enc_string:
        nxt: Dict[int, object] = {}
        for (src, lbl, dst) in nfa.edges:
            if lbl is EPS or src not in active:
                continue
            # char-in-class test: OR over eq comparisons
            hit = None
            for c in sorted(lbl):
                e = isk.scalar_eq(enc_char, ord(c)).block
                hit = e if hit is None else ssk.bitor(hit, e)
            t = ssk.mul(active[src], hit)
            closure = _eps_closure(nfa, {dst})
            for d in closure:
                nxt[d] = t if d not in nxt else ssk.bitor(nxt[d], t)
        active = nxt
        if not sof:
            # unanchored start: a match may begin at the next position
            for s in init:
                active[s] = one if s not in active else ssk.bitor(active[s], one)
        if not eof and nfa.accept in active:
            # unanchored end: remember any accept along the way
            matched = (active[nfa.accept] if matched is None
                       else ssk.bitor(matched, active[nfa.accept]))
        if not active:
            break

    if eof:
        result = active.get(nfa.accept)
    else:
        result = matched
    return result if result is not None else trivial_bit(template, 0)
