"""Minimal Dhall *value* parser for configuration documents.

The port's own copy of nyx_tpu/io/dhall.py (pure Python, unchanged but
for this docstring and the port's `ConfigError`).

The reference serializes mission-sequence / propagator / guidance configs
as Dhall (dynamics/sequence/config.rs:57-133; fixtures in
data/02_config/*.dhall). Those files use only Dhall's value-literal
subset — records, lists, Text/Double/Integer/Bool literals, ``Some x`` /
``None T``, and union-constructor selections ``< A | B : T >.B payload`` —
so a compact recursive-descent parser covers them without a Dhall
toolchain (none exists for Python in this image).

Semantics of the returned tree:
  record            -> dict
  list              -> list
  Some v            -> v
  None T            -> None            (the type annotation is skipped)
  <...>.Tag         -> "Tag"
  <...>.Tag {r}     -> {"_tag": "Tag", **r}
  <...>.Tag v       -> {"_tag": "Tag", "_value": v}
  +399 (Integer)    -> int
  Double/Natural    -> float / int

This is NOT a general Dhall evaluator: no imports, no functions, no
let-bindings, no operators — the reference's serde_dhall output never
emits them.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

from ..errors import ConfigError

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>[+-]?(?:\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?))
  | (?P<ident>[A-Za-z_][A-Za-z0-9_/-]*)
  | (?P<punct>[{}\[\]<>,=:|.()])
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    toks = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ConfigError(f"dhall: bad token at offset {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        toks.append((kind, m.group()))
    toks.append(("eof", ""))
    return toks


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value):
        kind, tok = self.next()
        if tok != value:
            raise ConfigError(f"dhall: expected {value!r}, got {tok!r} (token {self.i})")
        return tok

    # -- values ------------------------------------------------------------
    def parse_value(self) -> Any:
        kind, tok = self.peek()
        if tok == "{":
            return self._record()
        if tok == "[":
            return self._list()
        if tok == "<":
            return self._union_select()
        if tok == "(":
            self.next()
            v = self.parse_value()
            self.expect(")")
            return v
        if kind == "string":
            self.next()
            return tok[1:-1].replace('\\"', '"').replace("\\\\", "\\")
        if kind == "number":
            self.next()
            if "." in tok or "e" in tok or "E" in tok:
                return float(tok)
            return int(tok)
        if kind == "ident":
            if tok == "True":
                self.next()
                return True
            if tok == "False":
                self.next()
                return False
            if tok == "Some":
                self.next()
                return self.parse_value()
            if tok == "None":
                self.next()
                self._skip_type()
                return None
            raise ConfigError(f"dhall: unexpected identifier {tok!r} in value position")
        raise ConfigError(f"dhall: unexpected token {tok!r} in value position")

    def _record(self) -> dict:
        self.expect("{")
        out = {}
        if self.peek()[1] == "=":  # the empty record literal {=}
            self.next()
            self.expect("}")
            return out
        if self.peek()[1] == "}":
            self.next()
            return out
        while True:
            _, key = self.next()
            self.expect("=")
            out[key] = self.parse_value()
            _, sep = self.next()
            if sep == "}":
                return out
            if sep != ",":
                raise ConfigError(f"dhall: expected ',' or '}}' in record, got {sep!r}")

    def _list(self) -> list:
        self.expect("[")
        out = []
        if self.peek()[1] == "]":
            self.next()
            return out
        while True:
            out.append(self.parse_value())
            _, sep = self.next()
            if sep == "]":
                return out
            if sep != ",":
                raise ConfigError(f"dhall: expected ',' or ']' in list, got {sep!r}")

    _VALUE_START = {"{", "[", "<", '"'}

    def _union_select(self) -> Any:
        self._skip_balanced("<", ">")
        self.expect(".")
        _, tag = self.next()
        kind, tok = self.peek()
        has_payload = (
            tok in self._VALUE_START
            or kind in ("string", "number")
            or tok in ("Some", "None", "True", "False")
        )
        if not has_payload:
            return tag
        payload = self.parse_value()
        if isinstance(payload, dict) and "_tag" not in payload:
            return {"_tag": tag, **payload}
        return {"_tag": tag, "_value": payload}

    # -- type skipping ------------------------------------------------------
    def _skip_type(self):
        """Skip one type expression (the annotation after ``None``)."""
        kind, tok = self.peek()
        if tok == "{":
            self._skip_balanced("{", "}")
        elif tok == "<":
            self._skip_balanced("<", ">")
        elif tok == "(":
            self._skip_balanced("(", ")")
        elif kind == "ident":
            self.next()
            if tok in ("List", "Optional"):
                self._skip_type()
        else:
            raise ConfigError(f"dhall: cannot skip type starting at {tok!r}")

    def _skip_balanced(self, open_tok, close_tok):
        self.expect(open_tok)
        depth = 1
        while depth:
            _, tok = self.next()
            if tok == open_tok:
                depth += 1
            elif tok == close_tok:
                depth -= 1
            elif tok == "":
                raise ConfigError("dhall: unbalanced brackets")


def loads(text: str) -> Any:
    """Parse a Dhall value document into Python dict/list/scalars."""
    p = _Parser(_tokenize(text))
    v = p.parse_value()
    if p.peek()[0] != "eof":
        raise ConfigError(f"dhall: trailing tokens at {p.peek()[1]!r}")
    return v


def load(path) -> Any:
    with open(path) as f:
        return loads(f.read())
