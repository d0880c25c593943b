"""SQL scalar-expression parser -> TypedExpr trees.

Role parity: ``velox/parse/ExpressionsParser.h`` (the reference delegates to
DuckDB's parser for tests/PlanBuilder; we implement a small Pratt parser —
no external dependency). Supports the surface used by plans and tests:

  literals       123, 1.5, 1e9, 'text', TRUE, FALSE, NULL, DATE '1994-01-01'
  columns        identifiers (resolved against an input row type)
  operators      + - * / %   = <> != < <= > >=   AND OR NOT
  predicates     BETWEEN a AND b, IN (...), IS [NOT] NULL, [NOT] LIKE
  calls          f(a, b, ...), CAST(x AS type), TRY_CAST(x AS type)
  conditionals   CASE WHEN ... THEN ... [ELSE ...] END, IF(c, a, b)
"""

from __future__ import annotations

import re
from typing import List, Optional

from velox_tpu import types as T
from velox_tpu.core import expressions as ex

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?
             |\d+[eE][+-]?\d+|\d+)
    | (?P<str>'(?:[^']|'')*')
    | (?P<name>[A-Za-z_][A-Za-z0-9_.$]*)
    | (?P<op><>|!=|<=|>=|\|\||::|->|[-+*/%(),=<>\[\]])
    )""", re.X)

_KEYWORDS = {
    "and", "or", "not", "between", "in", "is", "null", "like", "true",
    "false", "cast", "try_cast", "as", "date", "timestamp", "interval",
    "case", "when", "then", "else", "end", "if", "distinct",
}

_CMP_NAMES = {"=": "eq", "<>": "neq", "!=": "neq", "<": "lt", "<=": "lte",
              ">": "gt", ">=": "gte"}


class Token:
    def __init__(self, kind, value):
        self.kind = kind  # num | str | name | op | kw | eof
        self.value = value

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def _tokenize(s: str) -> List[Token]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"cannot tokenize at: {s[pos:pos+20]!r}")
        pos = m.end()
        if m.group("num"):
            out.append(Token("num", m.group("num")))
        elif m.group("str"):
            out.append(Token("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.group("name"):
            name = m.group("name")
            low = name.lower()
            out.append(Token("kw" if low in _KEYWORDS else "name",
                             low if low in _KEYWORDS else name))
        else:
            out.append(Token("op", m.group("op")))
    out.append(Token("eof", None))
    return out


class Parser:
    def __init__(self, tokens: List[Token], row_type: Optional[T.DataType]):
        self.toks = tokens
        self.i = 0
        self.row_type = row_type
        self.scopes: List[dict] = []  # lambda parameter type bindings

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, value=None) -> Token:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise ValueError(f"expected {value or kind}, got {t!r}")
        return t

    def accept(self, kind, value=None) -> bool:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            self.i += 1
            return True
        return False

    # Pratt precedence climbing --------------------------------------------
    def parse_expr(self) -> ex.TypedExpr:
        return self.parse_or()

    def parse_or(self):
        left = self.parse_and()
        args = [left]
        while self.accept("kw", "or"):
            args.append(self.parse_and())
        if len(args) == 1:
            return left
        return ex.Call(T.BOOLEAN, "or", tuple(args))

    def parse_and(self):
        left = self.parse_not()
        args = [left]
        while self.accept("kw", "and"):
            args.append(self.parse_not())
        if len(args) == 1:
            return left
        return ex.Call(T.BOOLEAN, "and", tuple(args))

    def parse_not(self):
        if self.accept("kw", "not"):
            return ex.Call(T.BOOLEAN, "not", (self.parse_not(),))
        return self.parse_predicate()

    def parse_predicate(self):
        left = self.parse_additive()
        t = self.peek()
        if t.kind == "op" and t.value in _CMP_NAMES:
            self.next()
            right = self.parse_additive()
            return ex.call(_CMP_NAMES[t.value], left, right)
        negate = False
        if t.kind == "kw" and t.value == "not":
            # NOT BETWEEN / NOT IN / NOT LIKE
            nxt = self.toks[self.i + 1]
            if nxt.kind == "kw" and nxt.value in ("between", "in", "like"):
                self.next()
                negate = True
                t = self.peek()
        if t.kind == "kw" and t.value == "between":
            self.next()
            lo = self.parse_additive()
            self.expect("kw", "and")
            hi = self.parse_additive()
            out = ex.Call(T.BOOLEAN, "between", (left, lo, hi))
            return ex.Call(T.BOOLEAN, "not", (out,)) if negate else out
        if t.kind == "kw" and t.value == "in":
            self.next()
            self.expect("op", "(")
            items = [self.parse_expr()]
            while self.accept("op", ","):
                items.append(self.parse_expr())
            self.expect("op", ")")
            out = ex.Call(T.BOOLEAN, "in", (left, *items))
            return ex.Call(T.BOOLEAN, "not", (out,)) if negate else out
        if t.kind == "kw" and t.value == "like":
            self.next()
            pat = self.parse_additive()
            out = ex.Call(T.BOOLEAN, "like", (left, pat))
            return ex.Call(T.BOOLEAN, "not", (out,)) if negate else out
        if t.kind == "kw" and t.value == "is":
            self.next()
            if self.accept("kw", "not"):
                self.expect("kw", "null")
                return ex.Call(T.BOOLEAN, "is_not_null", (left,))
            self.expect("kw", "null")
            return ex.Call(T.BOOLEAN, "is_null", (left,))
        return left

    def parse_additive(self):
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                right = self.parse_multiplicative()
                left = ex.call("plus" if t.value == "+" else "minus",
                               left, right)
            else:
                return left

    def parse_multiplicative(self):
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                right = self.parse_unary()
                name = {"*": "multiply", "/": "divide", "%": "mod"}[t.value]
                left = ex.call(name, left, right)
            else:
                return left

    def parse_unary(self):
        t = self.peek()
        if t.kind == "op" and t.value == "-":
            self.next()
            child = self.parse_unary()
            if isinstance(child, ex.Constant) and child.value is not None:
                return ex.Constant(child.dtype, -child.value)
            return ex.call("negate", child)
        if t.kind == "op" and t.value == "+":
            self.next()
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while self.accept("op", "::"):
            type_name = self._parse_type_name()
            e = ex.Cast(type_name, e)
        return e

    def _parse_type_name(self) -> T.DataType:
        parts = []
        t = self.next()
        if t.kind not in ("name", "kw"):
            raise ValueError(f"expected type name, got {t!r}")
        parts.append(t.value)
        if self.accept("op", "("):
            args = []
            args.append(self.expect("num").value)
            while self.accept("op", ","):
                args.append(self.expect("num").value)
            self.expect("op", ")")
            parts.append("(" + ",".join(args) + ")")
        return T.parse_type("".join(parts))

    def parse_primary(self) -> ex.TypedExpr:
        t = self.next()
        if t.kind == "num":
            txt = t.value
            if "e" in txt or "E" in txt:
                return ex.lit(float(txt))
            if "." in txt:
                # Exact numeric literals are DECIMAL (standard SQL / Presto
                # semantics): money math stays exact.
                int_part, frac = txt.split(".", 1)
                s = len(frac)
                digits = (int_part + frac).lstrip("0") or "0"
                p = max(len(digits), s + 1)
                if p <= 38:
                    # >18 digits: long decimal (int128 limb backing,
                    # ops/int128.py; ref type/DecimalUtil.h)
                    return ex.Constant(T.decimal(p, s),
                                       int((int_part + frac) or "0"))
                import warnings
                warnings.warn(
                    f"decimal literal {txt!r} exceeds DECIMAL(38);"
                    " evaluating as DOUBLE (inexact)", stacklevel=2)
                return ex.lit(float(txt))
            val = int(txt)
            dtype = T.INTEGER if -2**31 <= val < 2**31 else T.BIGINT
            return ex.Constant(dtype, val)
        if t.kind == "str":
            return ex.lit(t.value)
        if t.kind == "op" and t.value == "(":
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "kw":
            return self._parse_keyword_primary(t)
        if t.kind == "name":
            if self.accept("op", "("):
                return self._parse_call(t.value)
            return self._field(t.value)
        raise ValueError(f"unexpected token {t!r}")

    def _parse_keyword_primary(self, t):
        if t.value == "true":
            return ex.lit(True)
        if t.value == "false":
            return ex.lit(False)
        if t.value == "null":
            return ex.Constant(T.UNKNOWN, None)
        if t.value == "date":
            s = self.expect("str")
            return ex.Constant(T.DATE, s.value)
        if t.value == "timestamp":
            s = self.expect("str")
            import datetime
            dt = datetime.datetime.fromisoformat(s.value)
            micros = int(dt.replace(
                tzinfo=datetime.timezone.utc).timestamp() * 1_000_000)
            return ex.Constant(T.TIMESTAMP, micros)
        if t.value in ("cast", "try_cast"):
            self.expect("op", "(")
            e = self.parse_expr()
            self.expect("kw", "as")
            ty = self._parse_type_name()
            self.expect("op", ")")
            return ex.Cast(ty, e, is_try=(t.value == "try_cast"))
        if t.value == "if":
            self.expect("op", "(")
            args = [self.parse_expr()]
            while self.accept("op", ","):
                args.append(self.parse_expr())
            self.expect("op", ")")
            return ex.Call(args[1].dtype, "if", tuple(args))
        if t.value == "case":
            return self._parse_case()
        raise ValueError(f"unexpected keyword {t.value!r}")

    def _parse_case(self):
        # CASE WHEN c1 THEN v1 [WHEN ...] [ELSE e] END  -> nested ifs
        whens = []
        while self.accept("kw", "when"):
            c = self.parse_expr()
            self.expect("kw", "then")
            v = self.parse_expr()
            whens.append((c, v))
        els = None
        if self.accept("kw", "else"):
            els = self.parse_expr()
        self.expect("kw", "end")
        dtype = whens[0][1].dtype
        out = els if els is not None else ex.Constant(dtype, None)
        for c, v in reversed(whens):
            out = ex.Call(dtype, "if", (c, v, out))
        return out

    _LAMBDA_FNS = ("transform", "filter", "any_match", "all_match",
                   "none_match", "map_filter", "transform_values",
                   "transform_keys", "exists", "forall")

    def _parse_call(self, name: str):
        lname = name.lower()
        args = []
        if not self.accept("op", ")"):
            args.append(self.parse_expr())
            while self.accept("op", ","):
                if lname in self._LAMBDA_FNS:
                    args.append(self._parse_arg_or_lambda(args[0].dtype))
                elif lname == "zip_with" and len(args) == 2:
                    # (x, y) params type from BOTH array arguments
                    args.append(self._parse_arg_or_lambda(
                        None, ptypes=[args[0].dtype.children[0],
                                      args[1].dtype.children[0]]))
                elif lname == "map_zip_with" and len(args) == 2:
                    # (k, v1, v2) from the two map arguments
                    args.append(self._parse_arg_or_lambda(
                        None, ptypes=[args[0].dtype.children[0],
                                      args[0].dtype.children[1],
                                      args[1].dtype.children[1]]))
                elif lname in ("reduce", "aggregate") and len(args) == 2:
                    # combine (s, x): s from init, x from the array
                    args.append(self._parse_arg_or_lambda(
                        None, ptypes=[args[1].dtype,
                                      args[0].dtype.children[0]]))
                elif lname in ("reduce", "aggregate") and len(args) == 3:
                    # output s -> out: s is the combine's result type
                    args.append(self._parse_arg_or_lambda(
                        None, ptypes=[args[2].dtype]))
                else:
                    args.append(self.parse_expr())
            self.expect("op", ")")
        return ex.call(lname, *args)

    def _parse_arg_or_lambda(self, coll_type, ptypes=None):
        """Parse `x -> body` / `(k, v) -> body` with parameter types
        bound from the collection argument (or given explicitly via
        ``ptypes``), else a normal expression."""
        params = None
        if self.peek().kind == "name" \
                and self.toks[self.i + 1].kind == "op" \
                and self.toks[self.i + 1].value == "->":
            params = [self.next().value]
            self.next()  # ->
        elif self.peek().kind == "op" and self.peek().value == "(":
            # lookahead for "(name[, name...]) ->"
            j = self.i + 1
            names = []
            while self.toks[j].kind == "name":
                names.append(self.toks[j].value)
                j += 1
                if self.toks[j].kind == "op" and self.toks[j].value == ",":
                    j += 1
                    continue
                break
            if names and self.toks[j].kind == "op" \
                    and self.toks[j].value == ")" \
                    and self.toks[j + 1].kind == "op" \
                    and self.toks[j + 1].value == "->":
                params = names
                self.i = j + 2
        if params is None:
            return self.parse_expr()
        if ptypes is None:
            if coll_type.kind is T.TypeKind.ARRAY:
                ptypes = [coll_type.children[0]]
            elif coll_type.kind is T.TypeKind.MAP:
                ptypes = list(coll_type.children)[:len(params)]
            else:
                raise ValueError(
                    f"lambda over non-collection type {coll_type}")
        if len(params) != len(ptypes):
            raise ValueError(
                f"lambda arity {len(params)} != expected {len(ptypes)}")
        self.scopes.append(dict(zip(params, ptypes)))
        body = self.parse_expr()
        self.scopes.pop()
        return ex.Lambda(body.dtype, params=tuple(params), body=body)

    def _field(self, name: str):
        for scope in reversed(self.scopes):
            if name in scope:
                return ex.field(name, scope[name])
        if self.row_type is None:
            raise ValueError(
                f"cannot resolve column {name!r}: no input row type")
        if name in self.row_type.names:
            return ex.field(name, self.row_type.field_type(name))
        if "." in name:
            # ROW field dereference: r.a[.b...] (the lexer folds dotted
            # identifiers into one token)
            base, *parts = name.split(".")
            e = ex.field(base, self.row_type.field_type(base))
            for part in parts:
                if e.dtype.kind is not T.TypeKind.ROW:
                    raise ValueError(
                        f"cannot dereference .{part} on {e.dtype}")
                ft = e.dtype.field_type(part)
                e = ex.Call(ft, "get_field",
                            (e, ex.Constant(T.VARCHAR, part)))
            return e
        return ex.field(name, self.row_type.field_type(name))


def parse_expression(text: str, row_type: Optional[T.DataType] = None
                     ) -> ex.TypedExpr:
    p = Parser(_tokenize(text), row_type)
    e = p.parse_expr()
    if p.peek().kind != "eof":
        raise ValueError(f"trailing tokens after expression: {p.peek()!r}")
    return e
