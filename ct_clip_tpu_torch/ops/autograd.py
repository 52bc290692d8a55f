"""Autograd helpers shared by the sublayers' plain backwards."""
from __future__ import annotations

import torch


def vjp(fn, inputs, dout):
    """torch.autograd.grad of fn(*inputs) at dout, for detached copies of
    the inputs (None stays None); an input without a gradient gets zeros."""
    leaves = [None if t is None else t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
        live = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(out, live, dout, allow_unused=True))
    res = []
    for t in leaves:
        g = None if t is None else next(grads)
        res.append(torch.zeros_like(t) if t is not None and g is None else g)
    return tuple(res)
