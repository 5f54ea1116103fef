"""
A dataset's ``row_filter``: the subset of ``DataFrame.query`` that the
JAX dataset runs on its joined frame (``gordo_tpu/dataset/datasets.py``,
``data.query(self.row_filter)``), evaluated over ``ast`` and numpy,
never ``eval``.

The text is prepared as pandas prepares it (``pandas/core/computation``:
``parsing.tokenize_string``, then ``expr._preparse``): backtick-quoted
names, which may hold ``-``, spaces or dots, become placeholders; the
text is tokenized, ``&`` and ``|`` become ``and`` and ``or``, and the
tokens are joined again and parsed. So ``&`` binds
as ``and`` does, below the comparisons: `` `tag-1` > 1 & b > 1 `` is
``(tag-1 > 1) and (b > 1)``, not Python's ``tag-1 > (1 & b) > 1``.

The subset: column names, bare or backticked; int and float literals,
unary ``-`` and ``+``; ``+ - * / ** %``; ``< <= > >= == !=``, chained
too (`` 1 < `a` <= 3 ``); ``and``, ``or``, ``not``, ``~`` (``&`` and
``|``) and parentheses; ``abs(...)``. Arithmetic follows numpy's float64
rules, as pandas' python engine does; the operands of ``and``, ``or``,
``not`` and ``~`` are boolean. Anything else (``@local``, strings,
``in``, ``index``, other calls, attributes) raises :class:`RowFilterError`
naming the construct and the text, and an unknown column
:class:`UnknownColumnError`; both are ``ValueError``s.

>>> data = np.array([[1.0, 5.0], [2.0, -1.0], [3.0, 2.0]])
>>> row_mask("`tag-1` > 1 & b > 1", ["tag-1", "b"], data)
array([False, False,  True])
"""

import ast
import io
import tokenize
from typing import Dict, List, Sequence, Tuple

import numpy as np

_PLACEHOLDER = "__row_filter_column_{}"
_COMPARE = {
    ast.Lt: np.less, ast.LtE: np.less_equal, ast.Gt: np.greater, ast.GtE: np.greater_equal,
    ast.Eq: np.equal, ast.NotEq: np.not_equal,
}
_ARITHMETIC = {
    ast.Add: np.add, ast.Sub: np.subtract, ast.Mult: np.multiply, ast.Div: np.true_divide,
    ast.Pow: np.power, ast.Mod: np.mod,
}


class RowFilterError(ValueError):
    """A ``row_filter`` outside the subset the port evaluates."""


class UnknownColumnError(RowFilterError):
    """A ``row_filter`` naming a column the dataset does not have (pandas
    raises its ``UndefinedVariableError``)."""

    def __init__(self, name: str, text: str):
        super().__init__(f"name {name!r} is not defined: row_filter {text!r} names no column {name!r}")
        self.name = name


def _split_by_backtick(text: str) -> List[Tuple[bool, str]]:
    """The text in pieces, each backtick-quoted or not (the quotes kept off;
    a doubled backtick inside is one), backticks inside quotes left alone:
    pandas' ``_split_by_backtick``."""
    pieces: List[Tuple[bool, str]] = []
    current: List[str] = []
    quote = None
    i = 0
    while i < len(text):
        char = text[i]
        if quote == "`":
            if char == "`" and text[i + 1: i + 2] == "`":
                current.append("`")
                i += 2
                continue
            if char == "`":
                pieces.append((True, "".join(current)))
                current, quote = [], None
                i += 1
                continue
        elif quote is None and char == "`":
            if current:
                pieces.append((False, "".join(current)))
            current, quote = [], "`"
            i += 1
            continue
        elif quote is None and char in "'\"":
            quote = char
        elif quote == char and text[i - 1] != "\\":
            quote = None
        current.append(char)
        i += 1
    if quote == "`":
        raise RowFilterError(f"row_filter {text!r} has an unclosed backtick")
    if current:
        pieces.append((False, "".join(current)))
    return pieces


def prepare(text: str) -> Tuple[str, Dict[str, str]]:
    """The Python text pandas parses for ``text``, and the column each
    placeholder stands for."""
    placeholders: Dict[str, str] = {}
    parts = []
    for quoted, piece in _split_by_backtick(text):
        if quoted:
            name = _PLACEHOLDER.format(len(placeholders))
            placeholders[name] = piece
            parts.append(name)
        else:
            parts.append(piece)
    tokens = []
    try:
        for token in tokenize.generate_tokens(io.StringIO("".join(parts)).readline):
            kind, value = token.type, token.string
            if kind == tokenize.OP and value == "@":
                raise RowFilterError(f"row_filter {text!r}: local variables (@name) are not read")
            if kind == tokenize.OP and value in ("&", "|"):
                kind, value = tokenize.NAME, "and" if value == "&" else "or"
            tokens.append((kind, value))
        return tokenize.untokenize(tokens), placeholders
    except (tokenize.TokenError, SyntaxError) as exc:
        raise RowFilterError(f"row_filter {text!r} does not parse: {exc}") from None


class _Evaluator:
    def __init__(self, text: str, columns: Dict[str, np.ndarray], placeholders: Dict[str, str]):
        self.text, self.columns, self.placeholders = text, columns, placeholders

    def refuse(self, what: str) -> RowFilterError:
        return RowFilterError(f"row_filter {self.text!r}: {what} is not read; the port reads column names, "
                              "numbers, + - * / ** %, comparisons, and/or/not/&/|/~ and abs()")

    def boolean(self, value, what: str):
        if np.asarray(value).dtype != bool:
            raise RowFilterError(f"row_filter {self.text!r}: the operand of {what} is not a comparison")
        return value

    def __call__(self, node: ast.AST):
        method = getattr(self, "visit_" + type(node).__name__, None)
        if method is None:
            raise self.refuse(_describe(node))
        return method(node)

    def visit_Expression(self, node: ast.Expression):
        return self(node.body)

    def visit_Name(self, node: ast.Name):
        name = self.placeholders.get(node.id, node.id)
        if name in self.columns:
            return self.columns[name]
        if node.id == "index":
            raise self.refuse("the index")
        raise UnknownColumnError(name, self.text)

    def visit_Constant(self, node: ast.Constant):
        if isinstance(node.value, bool) or not isinstance(node.value, (int, float)):
            raise self.refuse(f"the literal {node.value!r}")
        return node.value

    def visit_UnaryOp(self, node: ast.UnaryOp):
        operand = self(node.operand)
        if isinstance(node.op, ast.USub):
            return -operand
        if isinstance(node.op, ast.UAdd):
            return +operand
        what = "not" if isinstance(node.op, ast.Not) else "~"
        return np.logical_not(self.boolean(operand, what))

    def visit_BinOp(self, node: ast.BinOp):
        function = _ARITHMETIC.get(type(node.op))
        if function is None:
            raise self.refuse(f"the operator {type(node.op).__name__}")
        left, right = self(node.left), self(node.right)
        if np.ndim(left) == 0 and np.ndim(right) == 0:  # two literals: Python's arithmetic, as pandas folds them
            try:
                return {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b, ast.Mult: lambda a, b: a * b,
                        ast.Div: lambda a, b: a / b, ast.Pow: lambda a, b: a ** b,
                        ast.Mod: lambda a, b: a % b}[type(node.op)](left, right)
            except (ZeroDivisionError, OverflowError) as exc:
                raise RowFilterError(f"row_filter {self.text!r}: {exc}") from None
        return function(left, right)

    def visit_BoolOp(self, node: ast.BoolOp):
        what = "and" if isinstance(node.op, ast.And) else "or"
        combine = np.logical_and if what == "and" else np.logical_or
        result = self.boolean(self(node.values[0]), what)
        for value in node.values[1:]:
            result = combine(result, self.boolean(self(value), what))
        return result

    def visit_Compare(self, node: ast.Compare):
        left = self(node.left)
        result = None
        for op, comparator in zip(node.ops, node.comparators):
            function = _COMPARE.get(type(op))
            if function is None:
                raise self.refuse(f"the comparison {type(op).__name__}")
            right = self(comparator)
            step = function(left, right)
            result = step if result is None else np.logical_and(result, step)
            left = right
        return result

    def visit_Call(self, node: ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "abs" and len(node.args) == 1 and not node.keywords:
            return np.abs(self(node.args[0]))
        if isinstance(node.func, ast.Attribute):
            raise self.refuse(f"the method call .{node.func.attr}(...)")
        name = node.func.id if isinstance(node.func, ast.Name) else type(node.func).__name__
        raise self.refuse(f"the call {name}(...)")


def _describe(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return f"the attribute .{node.attr}"
    return {ast.Subscript: "a subscript", ast.List: "a list", ast.Tuple: "a tuple", ast.Dict: "a dict",
            ast.Lambda: "a lambda", ast.IfExp: "a conditional"}.get(type(node), f"the construct {type(node).__name__}")


def row_mask(text: str, names: Sequence[str], data: np.ndarray) -> np.ndarray:
    """The rows of ``data`` (``[rows, columns]``, columns named ``names``)
    that ``text`` keeps, as a boolean mask."""
    source, placeholders = prepare(text)
    try:
        tree = ast.parse(source.strip(), mode="eval")
    except SyntaxError as exc:
        raise RowFilterError(f"row_filter {text!r} does not parse: {exc.msg}") from None
    data = np.asarray(data, np.float64)
    columns = {name: data[:, i] for i, name in enumerate(names)}
    with np.errstate(all="ignore"):
        try:
            result = _Evaluator(text, columns, placeholders)(tree)
        except TypeError as exc:  # e.g. -(a > 1): numpy refuses the operand
            raise RowFilterError(f"row_filter {text!r}: {exc}") from None
    result = np.asarray(result)
    if result.dtype != bool or result.shape != (len(data),):
        raise RowFilterError(f"row_filter {text!r} does not give one boolean a row")
    return result
