"""Tensor parallelism (Megatron) over the mesh's tp axis.

The reference lays a model out by its partition specs and lets GSPMD insert
the collectives; its model reads the ambient mesh (``set_mesh`` /
``get_abstract_mesh``).  Torch has neither, so here the trainer enters a
:func:`tp_context` around the loss and its backward, holding the tp size,
this rank's index on the tp axis and the all-reduce over its tp group, and
the model, reading :func:`current`, writes out what XLA infers:

* :func:`copy_to_tp`: identity forward, all-reduce of the gradient
  backward (the input of a column-parallel matmul);
* :func:`reduce_from_tp`: all-reduce forward, identity backward (the
  partial sums a row-parallel matmul leaves on each rank);
* :func:`vocab_parallel_embed`: the lookup in a table whose vocabulary is
  split over tp, each rank its contiguous rows;
* :func:`vocab_parallel_cross_entropy`: the mean next-token loss over
  logits whose vocabulary is split over tp (three all-reduces of a
  ``[b, s]`` row, forward only).

Each is exact against its whole-tensor version up to the order of the
sums.  Outside a context (:func:`current` None) nothing is split.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist

from edl_tpu_torch.ops.embedding import embed_lookup_local


@dataclass(frozen=True)
class TPContext:
    """What a tp-split model needs of the mesh: the tp axis' size, this
    rank's index on it (its vocabulary rows and head columns are the
    ``rank``-th contiguous block), and ``reduce(t, op)``, the in-place
    all-reduce of ``t`` over this rank's tp group."""

    size: int
    rank: int
    reduce: Callable[[torch.Tensor, Any], None]


_current: Optional[TPContext] = None


def current() -> Optional[TPContext]:
    """The tp context the model runs in, or None (nothing split)."""
    return _current


@contextlib.contextmanager
def tp_context(ctx: TPContext) -> Iterator[TPContext]:
    """Run the body in ``ctx``; the previous context comes back on exit,
    whatever the body raised."""
    global _current
    prev, _current = _current, ctx
    try:
        yield ctx
    finally:
        _current = prev


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        ctx.tp.reduce(grad, dist.ReduceOp.SUM)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        out = x.clone(memory_format=torch.contiguous_format)
        tp.reduce(out, dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the tp group."""
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """``x`` summed over the tp group; the gradient passed through."""
    return _ReduceFromTP.apply(x, tp)


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                         tp: TPContext, *, one_hot: bool,
                         dtype: torch.dtype) -> torch.Tensor:
    """``embed_lookup`` of the whole table, from this rank's block of its
    rows (``table``, rows ``[rank·V/tp, (rank+1)·V/tp)``): each rank looks
    up the tokens its rows hold, zeros elsewhere, and the sum over the tp
    group is every token's row, exactly."""
    start = tp.rank * table.shape[0]
    return reduce_from_tp(embed_lookup_local(table, tokens, start,
                                             one_hot=one_hot, dtype=dtype),
                          tp)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, tp):
        vocab = logits.shape[-1]
        ids = targets.long() - tp.rank * vocab
        inside = (ids >= 0) & (ids < vocab)
        ids = torch.where(inside, ids, 0)
        top = logits.amax(dim=-1)
        tp.reduce(top, dist.ReduceOp.MAX)
        sumexp = (logits - top[..., None]).exp_().sum(dim=-1)
        tp.reduce(sumexp, dist.ReduceOp.SUM)
        lse = torch.log(sumexp) + top
        tgt = torch.where(inside, logits.gather(-1, ids[..., None])[..., 0],
                          0.0)
        tp.reduce(tgt, dist.ReduceOp.SUM)
        # the backward recomputes the softmax from the logits it was
        # handed: no [b, s, V/tp] copy is kept
        ctx.save_for_backward(logits, lse, ids, inside)
        return (lse - tgt).mean()

    @staticmethod
    def backward(ctx, grad):
        logits, lse, ids, inside = ctx.saved_tensors
        out = (logits - lse[..., None]).exp_()
        out.scatter_add_(-1, ids[..., None],
                         -inside.to(out.dtype)[..., None])
        out.mul_(grad / lse.numel())
        return out, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 tp: TPContext) -> torch.Tensor:
    """mean(logsumexp(logits) − logits[target]) over the whole vocabulary,
    from this rank's columns of the logits (``[..., V/tp]``, fp32): the
    forward all-reduces the row maxima (MAX), the sums of exp and the
    target's logit (SUM); the backward is ``(softmax − onehot) / N`` on
    the local columns, with no collective."""
    return _VocabParallelCE.apply(logits, targets, tp)
