"""Ring attention: exact causal attention over a sequence split over the
mesh's sp axis — the port of edl_tpu.parallel.ring_attention.

Each rank of an sp group holds one contiguous chunk of the sequence: its
queries stay resident while every key/value chunk visits it around the ring
(one point-to-point exchange a hop, :func:`exchange`: send to the next rank
of the line, receive from the previous one), and each visiting chunk is
folded into an online-softmax accumulator — the flash recurrence lifted one
level, blocks being ring chunks.  Peak memory is O(sc²) a chunk instead of
O(s²).

The reference reads the ambient mesh inside ``shard_map``; torch has
neither, so the trainer enters an :func:`sp_context` (:class:`SPContext`:
the sp size, this rank's index on the axis and its ``hop``) around the loss
and its backward, and the transformer, reading :func:`current`, takes this
rank's chunk of the sequence and routes its attention here.

Two rings, as in the reference:

* :func:`ring_attention_sharded`, the plain ring (``_ring_local``): each
  chunk's scores as a whole ``[sc, sc]`` fp32 block; autograd runs its
  backward, each hop's gradient going back the other way round the ring.
* :func:`ring_flash_attention_sharded` (``_ring_flash_local``): the flash
  forward once a visiting chunk (causal on the diagonal, full below it,
  nothing above), the chunks merged by logsumexp; its backward runs the dQ
  and dK/dV kernels a chunk against the GLOBAL out and lse, dQ summed in
  fp32 at home while dK/dV (fp32) ride the ring with their chunk and come
  home after one more hop.  Shapes the kernels do not take (a chunk not a
  multiple of 128) go to the plain ring on repeated kv heads.
  :func:`ring_flash_attention_plain` is the same ring on the kernels'
  plain versions, on any device: what the kernels' launches inside the
  ring are held to on the card.

Chunks are contiguous, as in the reference, so causal work is unbalanced:
rank r of the ring computes r + 1 chunks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Iterator, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from edl_tpu_torch.ops import flash_attention as fa

_NEG_INF = -1e30

#: a visiting chunk's case under causality: its source on the diagonal, below
#: it (every key precedes every query), or above it (no key is visible)
DIAG, BELOW, ABOVE = 0, 1, 2


@dataclass(frozen=True)
class SPContext:
    """What a sequence-split model needs of the mesh: the sp axis' size,
    this rank's index on it (its chunk of the sequence is the ``rank``-th
    contiguous one), and ``hop(tensors, reverse=False)``: every rank of the
    sp line sends each tensor to the next rank (the previous one with
    ``reverse``) and gets back, in order, the tensors of the same shapes
    the other neighbour sent.  Every rank of the line calls ``hop`` with the
    same shapes at the same point."""

    size: int
    rank: int
    hop: Callable[..., list]


_current: Optional[SPContext] = None


def current() -> Optional[SPContext]:
    """The sp context the model runs in, or None (the sequence is whole)."""
    return _current


@contextlib.contextmanager
def sp_context(ctx: SPContext) -> Iterator[SPContext]:
    """Run the body in ``ctx``; the previous context comes back on exit,
    whatever the body raised."""
    global _current
    prev, _current = _current, ctx
    try:
        yield ctx
    finally:
        _current = prev


def local_chunk(x: torch.Tensor, sp: SPContext, dim: int = 1
                ) -> torch.Tensor:
    """This rank's contiguous chunk of ``x`` along its sequence dim."""
    s = x.shape[dim]
    if s % sp.size:
        raise ValueError(f"a sequence of {s} does not split over sp "
                         f"{sp.size}")
    sc = s // sp.size
    return x.narrow(dim, sp.rank * sc, sc)


def exchange(tensors: Sequence[torch.Tensor], dst: int, src: int,
             group=None) -> list[torch.Tensor]:
    """One ring hop: each tensor sent to global rank ``dst`` and one of its
    shape and dtype received from ``src``, all in one
    ``dist.batch_isend_irecv`` (so neither side of a two-rank ring blocks on
    the other), each pair under its own tag.  gloo moves host memory only
    through ``send``/``recv``, so on a gloo group a CUDA tensor is staged
    through host memory here; NCCL moves it as it is."""
    backend = dist.get_backend(group)
    ops, got = [], []
    for tag, t in enumerate(tensors):
        t = t.detach().contiguous()
        wire = t.cpu() if backend == "gloo" and t.is_cuda else t
        recv = torch.empty_like(wire)
        ops += [dist.P2POp(dist.isend, wire, dst, group, tag),
                dist.P2POp(dist.irecv, recv, src, group, tag)]
        got.append((recv, t.device))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(dev) for r, dev in got]


def _case(idx: int, src: int, causal: bool) -> int:
    if not causal or src < idx:
        return BELOW
    return DIAG if src == idx else ABOVE


# -- the plain ring -----------------------------------------------------------


class _Hop(torch.autograd.Function):
    """k/v one hop forward; their gradients one hop back the other way."""

    @staticmethod
    def forward(ctx, sp, *tensors):
        ctx.sp = sp
        return tuple(sp.hop(list(tensors)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.sp.hop([g.contiguous() for g in grads],
                                  reverse=True))


def _chunk_attention(q, k, v, q_off: int, k_off: int, scale: float,
                     causal: bool):
    """One visiting chunk folded into the recurrence (``_ring_chunk_
    attention``): q [b, sq, h, d], k/v [b, sk, h, d], offsets the global
    positions of element 0 → (row max, probs @ v in fp32, row sums), the
    max and sums ``[b, h, sq, 1]``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        rows = q_off + torch.arange(sq, device=q.device)[:, None]
        cols = k_off + torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(~(rows >= cols), _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return m, pv, p.sum(dim=-1, keepdim=True)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           sp: Optional[SPContext] = None) -> torch.Tensor:
    """The plain ring (``_ring_local``) on this rank's chunks, q/k/v
    ``[b, sc, h, d]`` with matched heads → ``[b, sc, h, d]``; exact against
    attention over the whole sequence up to the order of the sums."""
    sp = _require(sp, "ring_attention_sharded")
    b, sc, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("the plain ring takes matched heads: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    scale = 1.0 / (d ** 0.5)
    n, idx = sp.size, sp.rank
    acc = torch.zeros(b, sc, h, d, dtype=torch.float32, device=q.device)
    m_run = torch.full((b, h, sc, 1), _NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros(b, h, sc, 1, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (idx - step) % n  # whose kv chunk this rank holds now
        m_blk, pv, l_blk = _chunk_attention(q, k_cur, v_cur, idx * sc,
                                            src * sc, scale, causal)
        m_new = torch.maximum(m_run, m_blk)
        alpha = torch.exp(m_run - m_new)  # rescale the old accumulator
        beta = torch.exp(m_blk - m_new)  # and the new block
        l_run = alpha * l_run + beta * l_blk
        acc = acc * alpha.transpose(1, 2) + pv * beta.transpose(1, 2)
        m_run = m_new
        if step + 1 < n:
            k_cur, v_cur = _Hop.apply(sp, k_cur, v_cur)
    out = acc / l_run.transpose(1, 2).clamp_min(1e-30)
    return out.to(q.dtype)


# -- the flash ring -----------------------------------------------------------


class _Chunk(NamedTuple):
    """A chunk's flash forward and backward (the folded signatures of
    :func:`~edl_tpu_torch.ops.flash_attention.flash_forward` and
    :func:`~edl_tpu_torch.ops.flash_attention.flash_backward`)."""

    forward: Callable
    backward: Callable


#: the kernels on the card, their plain versions on the CPU
_KERNELS = _Chunk(fa.flash_forward, fa.flash_backward)
#: the plain versions on any device
_PLAIN = _Chunk(fa.flash_forward_plain, fa.flash_backward_plain)


class _RingFlash(torch.autograd.Function):
    """The flash ring on folded chunks: q ``[b·h, sc, d]``, k/v
    ``[b·hk, sc, d]`` (GQA unrepeated), each chunk through ``chunk``."""

    @staticmethod
    def forward(ctx, qf, kf, vf, sp: SPContext, causal: bool, h: int,
                hk: int, chunk: _Chunk):
        n, idx = sp.size, sp.rank
        out = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
        lse = torch.full(qf.shape[:2], _NEG_INF, dtype=torch.float32,
                         device=qf.device)
        k_cur, v_cur = kf, vf
        for step in range(n):
            case = _case(idx, (idx - step) % n, causal)
            if case != ABOVE:  # a chunk above the diagonal adds nothing
                out_c, lse_c = chunk.forward(qf, k_cur, v_cur,
                                             case == DIAG, h, hk)
                lse_new = torch.logaddexp(lse, lse_c)
                # a row that has seen nothing yet sits at the _NEG_INF
                # sentinel, not at -inf: keep it at zero instead of
                # exp(sentinel - sentinel) = 1
                dead = lse_new < _NEG_INF * 0.5
                keep = torch.where(dead, 0.0, torch.exp(lse - lse_new))
                add = torch.where(dead, 0.0, torch.exp(lse_c - lse_new))
                out = out * keep[..., None] + out_c.float() * add[..., None]
                lse = lse_new
            if step + 1 < n:
                k_cur, v_cur = sp.hop([k_cur, v_cur])
        out = out.to(qf.dtype)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.sp, ctx.causal, ctx.h, ctx.hk = sp, causal, h, hk
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, out, lse = ctx.saved_tensors
        sp, n, idx = ctx.sp, ctx.sp.size, ctx.sp.rank
        do = do.contiguous()
        dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
        # dK/dV accumulate in fp32 and ride the ring with their chunk
        dk = torch.zeros(kf.shape, dtype=torch.float32, device=kf.device)
        dv = torch.zeros(vf.shape, dtype=torch.float32, device=vf.device)
        k_cur, v_cur = kf, vf
        for step in range(n):
            case = _case(idx, (idx - step) % n, ctx.causal)
            if case != ABOVE:
                # p = exp(s - lse_global) are the true probabilities, and
                # delta comes from the global out: each chunk's dQ share
                # and the visiting chunk's dK/dV are exact
                dq_c, dk_c, dv_c = ctx.chunk.backward(
                    qf, k_cur, v_cur, out, lse, do, case == DIAG, ctx.h,
                    ctx.hk)
                dq += dq_c.float()
                dk += dk_c.float()
                dv += dv_c.float()
            if step + 1 < n:
                k_cur, v_cur, dk, dv = sp.hop([k_cur, v_cur, dk, dv])
        if n > 1:  # one final hop brings every chunk's gradient home
            dk, dv = sp.hop([dk, dv])
        return (dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype), None,
                None, None, None, None)


def flash_eligible(sc: int) -> bool:
    """The reference's eligibility of a chunk of ``sc`` tokens for the
    flash ring: 128-aligned and divided by the shape-adapted blocks (a
    grid of ``sc // block`` would drop the tail rows otherwise)."""
    bq, bk = fa.fit_blocks(sc) if sc else (1, 1)
    return sc > 0 and sc % 128 == 0 and sc % bq == 0 and sc % bk == 0


def ring_flash_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, causal: bool = True,
                                 sp: Optional[SPContext] = None
                                 ) -> torch.Tensor:
    """Ring attention whose chunk arithmetic runs in the flash kernels, on
    this rank's chunks: q ``[b, sc, h, d]``, k/v ``[b, sc, hk, d]`` with GQA
    unrepeated → ``[b, sc, h, d]``.  A chunk :func:`flash_eligible` refuses
    takes the plain ring on repeated kv heads.

    The reference also repeats the kv heads when tp does not divide them;
    the port's transformer refuses that layout before attention
    (``models/transformer.py::_local_heads``), so the heads here are always
    a rank's whole query groups."""
    return _flash_ring(q, k, v, causal, _require(
        sp, "ring_flash_attention_sharded"), _KERNELS)


def ring_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = True,
                               sp: Optional[SPContext] = None
                               ) -> torch.Tensor:
    """:func:`ring_flash_attention_sharded` with each chunk through the
    kernels' plain versions, on any device: the same ring, rounding where
    the kernels round."""
    return _flash_ring(q, k, v, causal, _require(
        sp, "ring_flash_attention_plain"), _PLAIN)


def _flash_ring(q, k, v, causal: bool, sp: SPContext,
                chunk: _Chunk) -> torch.Tensor:
    b, sc, h, d = q.shape
    hk = k.shape[2]
    if h % hk or v.shape[2] != hk:
        raise ValueError(f"q heads {h} are not whole groups of the kv heads "
                         f"{hk} (k) / {v.shape[2]} (v)")
    if not flash_eligible(sc):
        if hk != h:
            k = k.repeat_interleave(h // hk, dim=2)
            v = v.repeat_interleave(h // hk, dim=2)
        return ring_attention_sharded(q, k, v, causal=causal, sp=sp)

    def fold(x):
        return x.transpose(1, 2).reshape(-1, sc, d).contiguous()

    out = _RingFlash.apply(fold(q), fold(k), fold(v), sp, causal, h, hk,
                           chunk)
    return out.reshape(b, h, sc, d).transpose(1, 2)


def _require(sp: Optional[SPContext], what: str) -> SPContext:
    sp = sp if sp is not None else _current
    if sp is None:
        raise RuntimeError(f"{what} needs an sp context (sp_context)")
    return sp
