"""Safe arithmetic-expression compiler for coefficient expressions.

The same whitelisted grammar as the JAX package's `ops/exprs.py` (numbers,
named variables, + - * / ** with unary minus, and exp, log, log10, sqrt,
abs, sin, cos, tanh, minimum, maximum), parsed with `ast` — no code
execution — and evaluated on torch tensors, so the result differentiates
under `torch.func` like any other part of the residual.
"""

from __future__ import annotations

import ast
import math
from typing import Callable, Dict

import torch


def _binary(fn):
    def call(a, b):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        return fn(a, b)

    return call


_FUNCS = {
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "sqrt": torch.sqrt,
    "abs": torch.abs,
    "sin": torch.sin,
    "cos": torch.cos,
    "tanh": torch.tanh,
    "minimum": _binary(torch.minimum),
    "maximum": _binary(torch.maximum),
}

_CONSTS = {"pi": math.pi, "e": math.e}

_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.Pow: lambda a, b: a**b,
}


class ExpressionError(ValueError):
    pass


def _check(node: ast.AST) -> None:
    if isinstance(node, ast.Expression):
        _check(node.body)
    elif isinstance(node, ast.BinOp):
        if type(node.op) not in _BINOPS:
            raise ExpressionError(f"operator {ast.dump(node.op)} not allowed")
        _check(node.left)
        _check(node.right)
    elif isinstance(node, ast.UnaryOp):
        if not isinstance(node.op, (ast.USub, ast.UAdd)):
            raise ExpressionError("only unary +/- allowed")
        _check(node.operand)
    elif isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name) or node.func.id not in _FUNCS:
            raise ExpressionError(
                f"function call not allowed: {ast.dump(node.func)}")
        if node.keywords:
            raise ExpressionError("keyword arguments not allowed")
        for arg in node.args:
            _check(arg)
    elif isinstance(node, ast.Constant):
        if not isinstance(node.value, (int, float)):
            raise ExpressionError(f"constant {node.value!r} not allowed")
    elif not isinstance(node, ast.Name):
        raise ExpressionError(f"syntax not allowed: {ast.dump(node)}")


def _evaluate(node: ast.AST, env: Dict):
    if isinstance(node, ast.Expression):
        return _evaluate(node.body, env)
    if isinstance(node, ast.BinOp):
        return _BINOPS[type(node.op)](_evaluate(node.left, env),
                                      _evaluate(node.right, env))
    if isinstance(node, ast.UnaryOp):
        v = _evaluate(node.operand, env)
        return -v if isinstance(node.op, ast.USub) else v
    if isinstance(node, ast.Call):
        return _FUNCS[node.func.id](*[_evaluate(a, env) for a in node.args])
    if isinstance(node, ast.Constant):
        return node.value
    if node.id in env:
        return env[node.id]
    if node.id in _CONSTS:
        return _CONSTS[node.id]
    raise ExpressionError(f"unknown variable '{node.id}'")


def compile_expression(text: str) -> Callable[..., object]:
    """Compile an arithmetic expression string into `f(**variables)`."""
    try:
        tree = ast.parse(text.strip(), mode="eval")
    except SyntaxError as exc:
        raise ExpressionError(f"cannot parse expression: {text!r}") from exc
    _check(tree)

    def fn(**variables):
        return _evaluate(tree, variables)

    fn.source = text
    return fn
