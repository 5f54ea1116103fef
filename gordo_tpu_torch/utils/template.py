"""
A renderer of the subset of Jinja2 that the workflow templates and
``build --model-parameter``'s model strings use, in the standard library
only: the card's machine has no ``jinja2``.

Rendered as Jinja 3 renders it with its default environment
(``trim_blocks`` and ``lstrip_blocks`` off, no autoescape):

- statements: ``if``/``elif``/``else``/``endif``, ``for NAME in EXPR``/
  ``endfor`` (``loop.index0``, ``index``, ``first``, ``last``,
  ``length``), ``set NAME = EXPR``, ``macro``/``endmacro`` and a macro's
  call, and ``{# comments #}``;
- whitespace control with ``-`` on either side of a tag; one trailing
  newline of the template is dropped;
- expressions: names, ``.attr`` and ``[item]`` access (Jinja's order: an
  attribute, then an item, or the other way for ``[]``), calls with
  keywords and ``**mapping``, slices, string, number, list and dict
  literals, a negative number, ``~``, comparisons and ``in``,
  ``and``/``or``/``not``, ``is [not] defined`` and ``is [not]
  undefined``; the global ``dict``;
- filters: ``tojson`` (keys sorted; ``<``, ``>``, ``&`` and ``'``
  escaped as ``\\u003c``, ``\\u003e``, ``\\u0026`` and ``\\u0027``),
  ``indent(width, first=, blank=)``, ``string``, and the filters a
  caller adds (``filters=``).

``{{ value }}`` prints ``str(value)`` (``True``, ``None``). With
``strict=True`` (Jinja's ``StrictUndefined``) an undefined name raises
:class:`UndefinedError` wherever it is used, except under ``is defined``;
otherwise it prints as nothing and is false. Anything else raises
:class:`TemplateError` naming the construct and its line.

>>> Template("{%- for x in xs %}{{ loop.index0 }}={{ x ~ '!' }} {% endfor %}").render(xs=["a", "b"])
'0=a! 1=b! '
"""

import json
import re
from typing import Any, Callable, Dict, List, Optional, Tuple


class TemplateError(ValueError):
    """A template outside the subset, or not valid; names the line."""


class UndefinedError(TemplateError):
    """An undefined value used where strict rendering forbids it."""


class Undefined:
    """A name or attribute that does not exist: prints as nothing, is
    false and empty (Jinja's default ``Undefined``)."""

    def __init__(self, hint: str):
        self._hint = hint

    def _fail(self, *args: Any, **kwargs: Any) -> Any:
        raise UndefinedError(self._hint)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__") or name == "_hint":
            raise AttributeError(name)
        self._fail()

    __getitem__ = __call__ = __add__ = __radd__ = __lt__ = __le__ = __gt__ = __ge__ = _fail

    def __str__(self) -> str:
        return ""

    def __bool__(self) -> bool:
        return False

    def __iter__(self):
        return iter(())

    def __len__(self) -> int:
        return 0

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other)

    def __ne__(self, other: Any) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return id(type(self))


class StrictUndefined(Undefined):
    """An undefined value that raises wherever it is used (Jinja's
    ``StrictUndefined``)."""

    __str__ = __bool__ = __iter__ = __len__ = __eq__ = __ne__ = __hash__ = Undefined._fail


def _tojson(value: Any, indent: Optional[int] = None) -> str:
    text = json.dumps(value, sort_keys=True, indent=indent)
    return text.replace("<", "\\u003c").replace(">", "\\u003e").replace("&", "\\u0026").replace("'", "\\u0027")


def _indent(text: Any, width: Any = 4, first: bool = False, blank: bool = False) -> str:
    """Jinja 3's ``indent``, its quirk of a newline added before the split
    included."""
    indention = width if isinstance(width, str) else " " * width
    text = str(text) + "\n"
    if blank:
        rv = ("\n" + indention).join(text.splitlines())
    else:
        lines = text.splitlines()
        rv = lines.pop(0)
        if lines:
            rv += "\n" + "\n".join(indention + line if line else line for line in lines)
    return indention + rv if first else rv


FILTERS: Dict[str, Callable] = {"tojson": _tojson, "indent": _indent, "string": str}
TESTS: Dict[str, Callable] = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
}
GLOBALS: Dict[str, Any] = {"dict": dict}

# ------------------------------------------------------------------------- lexing

_TAG_OPEN = re.compile(r"\{\{|\{%|\{#")
_CLOSE = {"{{": "}}", "{%": "%}", "{#": "#}"}


def _lex(source: str) -> List[Tuple[str, str, int]]:
    """``(kind, text, line)`` tokens, ``kind`` one of ``data``, ``{{`` and
    ``{%``, with the whitespace control applied to the data."""
    source = source.replace("\r\n", "\n").replace("\r", "\n")
    if source.endswith("\n"):
        source = source[:-1]
    tokens: List[Tuple[str, str, int]] = []
    pos, line, strip_next = 0, 1, False
    while True:
        match = _TAG_OPEN.search(source, pos)
        data = source[pos:match.start() if match else len(source)]
        if strip_next:
            data = data.lstrip()
        if match and source.startswith("-", match.end()):
            data = data.rstrip()
        if data:
            tokens.append(("data", data, line))
        if not match:
            return tokens
        line += source.count("\n", pos, match.start())
        opener = match.group()
        start = match.end() + (1 if source.startswith("-", match.end()) else 0)
        end, strip_next = _tag_end(source, start, _CLOSE[opener], line)
        if opener != "{#":
            tokens.append((opener, source[start:end], line))
        pos = end + (1 if strip_next else 0) + len(_CLOSE[opener])
        line += source.count("\n", match.start(), pos)


def _tag_end(source: str, pos: int, close: str, line: int) -> Tuple[int, bool]:
    """Where the tag opened before ``pos`` closes and whether a ``-``
    strips the whitespace after it. As Jinja's lexer, a tag closes only
    outside string literals and with its brackets balanced; a comment's
    text is not scanned."""
    if close == "#}":
        end = source.find(close, pos)
        if end < 0:
            raise TemplateError(f"line {line}: unclosed comment")
        return (end - 1, True) if end > pos and source[end - 1] == "-" else (end, False)
    quote, depth, i = None, 0, pos
    while i < len(source):
        ch = source[i]
        if quote:
            if ch == "\\":
                i += 1
            elif ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}" and depth:
            depth -= 1
        elif not depth and source.startswith("-" + close, i):
            return i, True
        elif not depth and source.startswith(close, i):
            return i, False
        i += 1
    raise TemplateError(f"line {line}: unclosed tag")


# --------------------------------------------------------------------- expressions

_EXPR_TOKEN = re.compile(
    r"\s*(?:(?P<float>\d+\.\d+)|(?P<int>\d+)|(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<string>'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\")"
    r"|(?P<op>\*\*|==|!=|<=|>=|[-+*/%~|()\[\]{},.:=<>]))"
)
_CONSTANTS = {"true": True, "True": True, "false": False, "False": False, "none": None, "None": None}
_COMPARE: Dict[str, Callable[[Any, Any], bool]] = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b, "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b, "in": lambda a, b: a in b,
    "not in": lambda a, b: a not in b,
}

Expr = Callable[["_Scope"], Any]


def _getattr(obj: Any, name: str, scope: "_Scope") -> Any:
    if isinstance(obj, Undefined):
        obj._fail()
    try:
        return getattr(obj, name)
    except AttributeError:
        pass
    try:
        return obj[name]
    except (TypeError, LookupError):
        return scope.undefined(f"{type(obj).__name__!r} object has no attribute {name!r}")


def _getitem(obj: Any, key: Any, scope: "_Scope") -> Any:
    if isinstance(obj, Undefined):
        obj._fail()
    try:
        return obj[key]
    except (AttributeError, LookupError, TypeError):
        if isinstance(key, str):
            try:
                return getattr(obj, key)
            except AttributeError:
                pass
    return scope.undefined(f"{type(obj).__name__!r} object has no element {key!r}")


class _Expression:
    """A recursive-descent parser of one expression in Jinja's precedence
    (``or``, ``and``, ``not``, comparisons, ``~``, a unary minus, then a
    primary with its postfixes, filters and tests), each node compiled to
    a function of the scope."""

    def __init__(self, text: str, line: int, filters: Dict[str, Callable]):
        self.line = line
        self.filters = filters
        self.items: List[Tuple[str, Any]] = []
        pos, text = 0, text.rstrip()
        while pos < len(text):
            match = _EXPR_TOKEN.match(text, pos)
            if not match:
                raise TemplateError(f"line {line}: unexpected {text[pos:].strip()[:20]!r}")
            kind = match.lastgroup
            value: Any = match.group(kind)
            if kind == "string":
                value = value[1:-1].encode("ascii", "backslashreplace").decode("unicode-escape")
            elif kind in ("int", "float"):
                value = int(value) if kind == "int" else float(value)
            self.items.append((kind, value))
            pos = match.end()
        self.i = 0

    # -- tokens

    def peek(self, offset: int = 0) -> Tuple[str, Any]:
        j = self.i + offset
        return self.items[j] if j < len(self.items) else ("end", None)

    def is_op(self, *ops: str) -> bool:
        return self.peek()[0] == "op" and self.peek()[1] in ops

    def is_name(self, name: str) -> bool:
        return self.peek() == ("name", name)

    def take(self) -> Tuple[str, Any]:
        item = self.peek()
        self.i += 1
        return item

    def expect(self, op: str) -> None:
        if not self.is_op(op):
            raise self.error(f"expected {op!r}")
        self.i += 1

    def error(self, message: str, back: int = 0) -> TemplateError:
        kind, value = self.peek(-back)
        found = "the end" if kind == "end" else repr(value)
        return TemplateError(f"line {self.line}: {message}, found {found}")

    def whole(self) -> Expr:
        expr = self.or_()
        if self.i < len(self.items):
            raise self.error("this renderer's subset ends the expression here")
        return expr

    # -- grammar

    def or_(self) -> Expr:
        left = self.and_()
        while self.is_name("or"):
            self.take()
            left = (lambda a, b: lambda s: a(s) or b(s))(left, self.and_())
        return left

    def and_(self) -> Expr:
        left = self.not_()
        while self.is_name("and"):
            self.take()
            left = (lambda a, b: lambda s: a(s) and b(s))(left, self.not_())
        return left

    def not_(self) -> Expr:
        if self.is_name("not"):
            self.take()
            operand = self.not_()
            return lambda s: not operand(s)
        return self.compare()

    def compare(self) -> Expr:
        left = self.concat()
        ops: List[Tuple[Callable, Expr]] = []
        while True:
            if self.is_op("==", "!=", "<", "<=", ">", ">=") or self.is_name("in"):
                op = self.take()[1]
            elif self.is_name("not") and self.peek(1) == ("name", "in"):
                self.i += 2
                op = "not in"
            else:
                break
            ops.append((_COMPARE[op], self.concat()))
        if not ops:
            return left

        def chained(s):
            a = left(s)
            for compare, right in ops:
                b = right(s)
                if not compare(a, b):
                    return False
                a = b
            return True

        return chained

    def concat(self) -> Expr:
        parts = [self.unary()]
        while self.is_op("~"):
            self.take()
            parts.append(self.unary())
        if len(parts) == 1:
            return parts[0]
        return lambda s: "".join(str(part(s)) for part in parts)

    def unary(self) -> Expr:
        if self.is_op("-"):
            self.take()
            operand = self.postfix(self.primary())
            node: Expr = lambda s: -operand(s)
        else:
            node = self.postfix(self.primary())
        if self.is_op("+", "-", "*", "/", "%", "**"):
            raise self.error("arithmetic is not supported by this renderer")
        return self.filters_and_tests(node)

    def primary(self) -> Expr:
        kind, value = self.take()
        if kind == "name":
            if value in _CONSTANTS:
                return lambda s: _CONSTANTS[value]
            return lambda s: s.lookup(value)
        if kind == "string":
            while self.peek()[0] == "string":  # adjacent literals concatenate
                value += self.take()[1]
            return lambda s: value
        if kind in ("int", "float"):
            return lambda s: value
        if (kind, value) == ("op", "("):
            inner = self.or_()
            if self.is_op(","):
                raise self.error("tuples are not supported by this renderer")
            self.expect(")")
            return inner
        if (kind, value) == ("op", "["):
            items = []
            while not self.is_op("]"):
                items.append(self.or_())
                if not self.is_op(","):
                    break
                self.take()
            self.expect("]")
            return lambda s: [item(s) for item in items]
        if (kind, value) == ("op", "{"):
            pairs: List[Tuple[Expr, Expr]] = []
            while not self.is_op("}"):
                key = self.or_()
                self.expect(":")
                pairs.append((key, self.or_()))
                if not self.is_op(","):
                    break
                self.take()
            self.expect("}")
            return lambda s: {k(s): v(s) for k, v in pairs}
        raise self.error("expected an expression", back=1)

    def postfix(self, node: Expr) -> Expr:
        while True:
            if self.is_op("."):
                self.take()
                kind, name = self.take()
                if kind == "name":
                    node = (lambda n, a: lambda s: _getattr(n(s), a, s))(node, name)
                elif kind == "int":
                    node = (lambda n, a: lambda s: _getitem(n(s), a, s))(node, name)
                else:
                    raise self.error("expected an attribute", back=1)
            elif self.is_op("["):
                self.take()
                node = (lambda n, k: lambda s: _getitem(n(s), k(s), s))(node, self.subscript())
            elif self.is_op("("):
                node = (lambda n, call: lambda s: call(s, n(s)))(node, self.arguments())
            else:
                return node

    def subscript(self) -> Expr:
        """An item's key, or ``start:stop:step`` as a slice."""
        parts: List[Optional[Expr]] = [None]
        while not self.is_op("]"):
            if self.is_op(":"):
                self.take()
                parts.append(None)
            else:
                parts[-1] = self.or_()
        self.expect("]")
        if len(parts) == 1:
            if parts[0] is None:
                raise self.error("expected a subscript", back=1)
            return parts[0]
        if len(parts) > 3:
            raise self.error("a slice takes at most two colons", back=1)
        return lambda s: slice(*(p(s) if p else None for p in parts))

    def arguments(self) -> Callable[["_Scope", Callable], Any]:
        """A call's arguments (positional, ``key=value`` and ``**mapping``),
        its parentheses included, as a function of the scope and the
        callee."""
        self.expect("(")
        args: List[Expr] = []
        kwargs: List[Tuple[Optional[str], Expr]] = []
        while not self.is_op(")"):
            if self.is_op("**"):
                self.take()
                kwargs.append((None, self.or_()))
            elif self.peek()[0] == "name" and self.peek(1) == ("op", "="):
                name = self.take()[1]
                self.take()
                kwargs.append((name, self.or_()))
            else:
                args.append(self.or_())
            if not self.is_op(","):
                break
            self.take()
        self.expect(")")

        def call(s, fn):
            if isinstance(fn, Undefined):
                fn._fail()
            keywords: Dict[str, Any] = {}
            for name, value in kwargs:
                if name is None:
                    keywords.update(value(s))
                else:
                    keywords[name] = value(s)
            return fn(*(a(s) for a in args), **keywords)

        return call

    def filters_and_tests(self, node: Expr) -> Expr:
        while True:
            if self.is_op("|"):
                self.take()
                kind, name = self.take()
                if kind != "name" or name not in self.filters:
                    raise TemplateError(f"line {self.line}: the filter {name!r} is not supported by this renderer")
                call = self.arguments() if self.is_op("(") else (lambda s, fn: fn())
                fn = self.filters[name]
                node = (lambda n, fn, call: lambda s: call(s, lambda *a, **k: fn(n(s), *a, **k)))(node, fn, call)
            elif self.is_name("is"):
                self.take()
                negate = self.is_name("not")
                if negate:
                    self.take()
                kind, name = self.take()
                if kind != "name" or name not in TESTS:
                    raise TemplateError(f"line {self.line}: the test {name!r} is not supported by this renderer")
                node = (lambda n, test, neg: lambda s: test(n(s)) != neg)(node, TESTS[name], negate)
            else:
                return node


# ---------------------------------------------------------------------- statements


class _Scope:
    def __init__(self, values: Dict[str, Any], parent: Optional["_Scope"], strict: bool):
        self.values = values
        self.parent = parent
        self.strict = strict

    def child(self, values: Dict[str, Any]) -> "_Scope":
        return _Scope(values, self, self.strict)

    def undefined(self, hint: str) -> Undefined:
        return (StrictUndefined if self.strict else Undefined)(hint)

    def lookup(self, name: str) -> Any:
        scope: Optional[_Scope] = self
        while scope is not None:
            if name in scope.values:
                return scope.values[name]
            scope = scope.parent
        if name in GLOBALS:
            return GLOBALS[name]
        return self.undefined(f"{name!r} is undefined")


class _Loop:
    def __init__(self, index0: int, length: int):
        self.index0 = index0
        self.index = index0 + 1
        self.length = length
        self.first = index0 == 0
        self.last = index0 == length - 1


Node = Callable[[_Scope, List[str]], None]
_NAME = r"[A-Za-z_][A-Za-z0-9_]*"


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str, int]], filters: Dict[str, Callable]):
        self.tokens = tokens
        self.i = 0
        self.filters = filters

    def expr(self, text: str, line: int) -> Expr:
        return _Expression(text, line, self.filters).whole()

    def body(self, ends: Tuple[str, ...]) -> Tuple[List[Node], str, str, int]:
        """Nodes up to one of the ``ends`` tags: ``(nodes, the end's word,
        the end's rest, its line)``."""
        nodes: List[Node] = []
        while self.i < len(self.tokens):
            kind, text, line = self.tokens[self.i]
            self.i += 1
            if kind == "data":
                nodes.append((lambda t: lambda scope, out: out.append(t))(text))
            elif kind == "{{":
                nodes.append(self.output(self.expr(text, line), line))
            else:
                word, _, rest = text.strip().partition(" ")
                if word in ends:
                    return nodes, word, rest.strip(), line
                nodes.append(self.statement(word, rest.strip(), line))
        if ends:
            raise TemplateError(f"missing {{% {ends[-1]} %}} at the end of the template")
        return nodes, "", "", 0

    @staticmethod
    def output(expr: Expr, line: int) -> Node:
        def render(scope: _Scope, out: List[str]) -> None:
            try:
                out.append(str(expr(scope)))
            except UndefinedError as exc:
                raise UndefinedError(f"line {line}: {exc}") from None

        return render

    def statement(self, word: str, rest: str, line: int) -> Node:
        if word == "if":
            return self.if_(rest, line)
        if word == "for":
            return self.for_(rest, line)
        if word == "set":
            match = re.fullmatch(rf"({_NAME})\s*=(.*)", rest, re.S)
            if not match:
                raise TemplateError(f"line {line}: only '{{% set NAME = EXPR %}}' is supported by this renderer")
            name, expr = match.group(1), self.expr(match.group(2), line)

            def assign(scope: _Scope, out: List[str]) -> None:
                scope.values[name] = expr(scope)

            return assign
        if word == "macro":
            return self.macro(rest, line)
        raise TemplateError(f"line {line}: '{{% {word} %}}' is not supported here by this renderer")

    def if_(self, test: str, line: int) -> Node:
        branches: List[Tuple[Optional[Expr], List[Node]]] = []
        condition: Optional[Expr] = self.expr(test, line)
        while True:
            nodes, end, rest, end_line = self.body(("elif", "else", "endif"))
            branches.append((condition, nodes))
            if end == "endif":
                break
            if end == "else":
                branches.append((None, self.body(("endif",))[0]))
                break
            condition = self.expr(rest, end_line)

        def render(scope: _Scope, out: List[str]) -> None:
            for cond, nodes in branches:
                if cond is None or cond(scope):
                    for node in nodes:
                        node(scope, out)
                    return

        return render

    def for_(self, header: str, line: int) -> Node:
        match = re.fullmatch(rf"({_NAME})\s+in\s+(.*)", header, re.S)
        if not match:
            raise TemplateError(f"line {line}: only '{{% for NAME in EXPR %}}' is supported by this renderer")
        target, iterable = match.group(1), self.expr(match.group(2), line)
        body = self.body(("endfor",))[0]

        def render(scope: _Scope, out: List[str]) -> None:
            items = list(iterable(scope))
            for index, item in enumerate(items):
                inner = scope.child({target: item, "loop": _Loop(index, len(items))})
                for node in body:
                    node(inner, out)

        return render

    def macro(self, header: str, line: int) -> Node:
        match = re.fullmatch(rf"({_NAME})\s*\((.*)\)", header, re.S)
        if not match:
            raise TemplateError(f"line {line}: expected '{{% macro NAME(ARGS) %}}'")
        name = match.group(1)
        params: List[Tuple[str, Optional[Expr]]] = []
        for part in filter(None, (p.strip() for p in match.group(2).split(","))):
            param, eq, default = part.partition("=")
            params.append((param.strip(), self.expr(default, line) if eq else None))
        body = self.body(("endmacro",))[0]

        def define(scope: _Scope, out: List[str]) -> None:
            def call(*args: Any, **kwargs: Any) -> str:
                values = {}
                for i, (param, default) in enumerate(params):
                    if i < len(args):
                        values[param] = args[i]
                    elif param in kwargs:
                        values[param] = kwargs[param]
                    else:
                        values[param] = default(scope) if default else scope.undefined(f"{param!r} is undefined")
                inner = scope.child(values)
                rendered: List[str] = []
                for node in body:
                    node(inner, rendered)
                return "".join(rendered)

            scope.values[name] = call

        return define


class Template:
    """A template's source, parsed once; :meth:`render` it with a context."""

    def __init__(self, source: str, strict: bool = True, filters: Optional[Dict[str, Callable]] = None):
        self.strict = strict
        self.nodes = _Parser(_lex(source), {**FILTERS, **(filters or {})}).body(())[0]

    def render(self, **context: Any) -> str:
        scope = _Scope(dict(context), None, self.strict)
        out: List[str] = []
        for node in self.nodes:
            node(scope, out)
        return "".join(out)
