"""The port's paged decode surface (edl_tpu_torch.models.llama) against the
JAX package's (edl_tpu.models.llama) on the same seeded inputs at TINY
fp32: prefill, decode_step and verify_step, bf16-layout and int8 pools,
dead slots, padded prefill rows, a context over several blocks with a
sentinel-padded table; the host and device gather/scatter round trips;
and that live rows never share a cache cell.

Tolerances: logits and float cache contents within 1e-5 (fp32 through two
layers, summed in other orders); int8 codes equal except where the value
lies on a rounding tie (at most one code), scales within 1e-6 relative."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import llama as jl
from edl_tpu.models.transformer import TINY as JTINY
from edl_tpu_torch.models import llama
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.runtime.kvcache import KVBlockPool
from edl_tpu_torch.runtime.serving import DecodeFleet
from tests.torch_decode_ref import MODEL, PARAMS

NB, BS, MAXB = 12, 4, 6
ATOL = 1e-5


def _close(jax_arr, t: torch.Tensor, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(jax_arr), rtol=0,
                               atol=atol)


def _check_cache(jcache: dict, tcache: dict) -> None:
    assert set(jcache) == set(tcache)
    for name in jcache:
        a, b = np.asarray(jcache[name]), tcache[name].numpy()
        if a.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            # a code may differ only where the value sits on a rounding
            # tie, which the two frameworks' divisions can put either side
            assert diff.max() <= 1, name
            assert int((diff > 0).sum()) <= 1, (name, int((diff > 0).sum()))
        elif name.endswith("_scale"):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)


def _tables(rows):
    t = np.full((len(rows), MAXB), NB, np.int32)
    for i, blocks in enumerate(rows):
        t[i, :len(blocks)] = blocks
    return t


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_prefill_decode_verify_match_jax(quantize):
    rng = np.random.default_rng(3)
    jc = jl.init_cache(JTINY, NB, BS, quantize=quantize)
    tc = llama.init_cache(tfm.TINY, NB, BS, quantize=quantize, device="cpu")
    # session A: 13 prompt tokens over 5 scattered blocks, chunked 8 + 5
    # (3 padded rows); session B: 6 tokens over 2 blocks
    a_blocks, b_blocks = [7, 2, 10, 4, 0], [5, 11]
    a = rng.integers(1, 255, 13).astype(np.int32)
    b = rng.integers(1, 255, 6).astype(np.int32)
    for blocks, toks, start, n in ((a_blocks, a[:8], 0, 8),
                                   (a_blocks, a[8:], 8, 5),
                                   (b_blocks, b, 0, 6)):
        chunk = np.zeros(8, np.int32)
        chunk[:n] = toks
        table = _tables([blocks])[0]
        jlog, jc = jl.prefill(PARAMS, jc, jnp.asarray(chunk),
                              jnp.asarray(table), jnp.asarray(start, "int32"),
                              jnp.asarray(n, "int32"), JTINY)
        tlog, tc = llama.prefill(MODEL, tc, chunk, table, start, n)
        _close(jlog, tlog)  # padded rows too: both clamp alike
    _check_cache(jc, tc)
    # decode across A's block boundary (13 → 16), B live, slot 2 dead
    tables = _tables([a_blocks, b_blocks, []])
    pos = np.array([13, 6, 0], np.int32)
    for step in range(4):
        toks = rng.integers(1, 255, 3).astype(np.int32)
        live = np.array([True, True, False])
        jlog, jc = jl.decode_step(PARAMS, jc, jnp.asarray(toks),
                                  jnp.asarray(pos), jnp.asarray(tables),
                                  jnp.asarray(live), JTINY)
        tlog, tc = llama.decode_step(MODEL, tc, toks, pos, tables, live)
        _close(jlog, tlog)
        pos = pos + np.array([1, 1, 0], np.int32)
    _check_cache(jc, tc)
    # verify: A feeds 3 rows, B 2, slot 2 none
    vt = rng.integers(1, 255, (3, 3)).astype(np.int32)
    nts = np.array([3, 2, 0], np.int32)
    jlog, jc = jl.verify_step(PARAMS, jc, jnp.asarray(vt), jnp.asarray(pos),
                              jnp.asarray(nts), jnp.asarray(tables), JTINY)
    tlog, tc = llama.verify_step(MODEL, tc, vt, pos, nts, tables)
    assert tlog.shape == (3, 3, tfm.TINY.vocab_size)
    _close(jlog, tlog)
    _check_cache(jc, tc)


def test_dead_rows_and_sentinel_cells_leave_the_cache_untouched():
    tc = llama.init_cache(tfm.TINY, NB, BS, device="cpu")
    for t in tc.values():
        t.fill_(7.0)
    before = {k: v.clone() for k, v in tc.items()}
    # every row dead, or live past its blocks (the sentinel cell)
    llama.decode_step(MODEL, tc, [3, 4], [0, 9], _tables([[1], [2, 3]]),
                      [False, True])
    for name in tc:
        assert torch.equal(tc[name], before[name])


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_gather_scatter_round_trips_bitwise(quantize):
    src = llama.init_cache(tfm.TINY, NB, BS, quantize=quantize, device="cpu")
    dst = llama.init_cache(tfm.TINY, NB, BS, quantize=quantize, device="cpu")
    toks = np.arange(1, 11)
    llama.prefill(MODEL, src, toks, _tables([[3, 8, 1]])[0], 0, 10)
    host = llama.gather_session_kv(src, [3, 8, 1], 10, BS)
    assert host["k"].shape == (2, 10, 2, 16)
    llama.scatter_session_kv(dst, [0, 5, 9], host, BS)
    again = llama.gather_session_kv(dst, [0, 5, 9], 10, BS)
    for name in ("k", "v"):
        if quantize:  # re-quantizing dequantized rows gives the same rows
            torch.testing.assert_close(again[name], host[name], rtol=0,
                                       atol=1e-6)
        else:
            assert torch.equal(again[name], host[name])
    payload = llama.gather_session_kv_device(src, [3, 8, 1])
    dst2 = llama.init_cache(tfm.TINY, NB, BS, quantize=quantize,
                            device="cpu")
    llama.scatter_session_kv_device(dst2, [6, 2, 11], payload)
    for name in src:
        assert torch.equal(dst2[name][:, [6, 2, 11]], src[name][:, [3, 8, 1]])
    # the payload is a copy: the source may reuse its blocks at once
    src["k"].zero_()
    assert torch.equal(payload["k"], dst2["k"][:, [6, 2, 11]])
    if quantize:
        with pytest.raises(ValueError, match="quantization modes"):
            llama.scatter_session_kv_device(
                llama.init_cache(tfm.TINY, NB, BS, device="cpu"), [0, 1, 2],
                payload)


def test_host_round_trip_matches_jax_gather():
    jc = jl.init_cache(JTINY, NB, BS)
    tc = llama.init_cache(tfm.TINY, NB, BS, device="cpu")
    toks = np.arange(5, 14).astype(np.int32)
    table = _tables([[4, 9, 1]])[0]
    _, jc = jl.prefill(PARAMS, jc, jnp.asarray(toks), jnp.asarray(table),
                       jnp.asarray(0, "int32"), jnp.asarray(9, "int32"),
                       JTINY)
    llama.prefill(MODEL, tc, toks, table, 0, 9)
    jh = jl.gather_session_kv(jc, [4, 9, 1], 9, BS)
    th = llama.gather_session_kv(tc, [4, 9, 1], 9, BS)
    for name in ("k", "v"):
        np.testing.assert_allclose(th[name].numpy(), jh[name], rtol=0,
                                   atol=ATOL)


def test_cache_bytes_match_jax():
    for q in (None, "int8"):
        assert (llama.cache_bytes(tfm.TINY, NB, BS, q)
                == jl.cache_bytes(JTINY, NB, BS, q))
        cache = llama.init_cache(tfm.TINY, NB, BS, quantize=q, device="cpu")
        assert sum(t.numel() * t.element_size() for t in cache.values()) \
            == llama.cache_bytes(tfm.TINY, NB, BS, q)


def test_bf16_weights_cast_once_round_like_the_reference():
    """One cast copy per generation rounds exactly as casting at every
    use: the logits equal those of the model's own per-use casts."""
    import dataclasses

    cfg = dataclasses.replace(tfm.TINY, dtype=torch.bfloat16)
    model = tfm.Transformer(cfg, device="cpu", seed=1)
    params = llama.as_decode_params(model)
    assert params.layers[0]["wq"].dtype == torch.bfloat16
    assert params.layers[0]["attn_norm"].dtype == torch.float32
    cache = llama.init_cache(cfg, NB, BS, device="cpu")
    toks = np.arange(1, 9)
    a, _ = llama.prefill(params, cache, toks, _tables([[0, 1]])[0], 0, 8)
    cache = llama.init_cache(cfg, NB, BS, device="cpu")
    b, _ = llama.prefill(model, cache, toks, _tables([[0, 1]])[0], 0, 8)
    assert torch.equal(a, b)


def _cells_recorder(monkeypatch):
    """Wrap the step's input staging: record every call's write cells and
    assert no two live rows share one (index_put_ with duplicate indices
    is not deterministic on the device)."""
    calls = []
    real = llama._step_inputs

    def recording(cache, *args):
        out = real(cache, *args)
        blk, off = out[4], out[5]
        cells = list(zip(blk.tolist(), off.tolist()))
        assert len(cells) == len(set(cells)), cells
        calls.append(cells)
        return out

    monkeypatch.setattr(llama, "_step_inputs", recording)
    return calls


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("spec_tokens", [0, 4])
def test_live_rows_never_share_a_cell_in_the_fleet(monkeypatch,
                                                   spec_tokens):
    """Prefill, decode and (with speculation) verify through a fleet whose
    sessions share a prompt prefix (prefix-cache hits) and whose slots
    pack and re-pack."""
    calls = _cells_recorder(monkeypatch)
    fleet = DecodeFleet(MODEL, tfm.TINY, job=f"t/cells{spec_tokens}",
                        slots=4, prefill_chunk=8, kv_blocks=48,
                        kv_block_size=8, max_blocks_per_session=8,
                        spec_tokens=spec_tokens, device="cpu")
    try:
        shared = list(range(3, 27))  # 24 tokens: three sealed blocks
        first = fleet.submit(shared, 10)
        first.wait(60)
        ss = [fleet.submit(shared, 10), fleet.submit(shared[:20] + [9], 8),
              fleet.submit([11, 4, 11, 4, 11, 4, 11, 4], 12),
              fleet.submit([5, 9, 17], 12)]
        for s in ss:
            s.wait(60)
        assert fleet.sessions_failed == 0
    finally:
        fleet.stop()
    assert sum(len(c) > 1 for c in calls) > 5


def test_forked_sessions_write_distinct_cells_after_copy_on_write():
    pool = KVBlockPool(tfm.TINY, NB, BS, MAXB, job="t/cells-fork",
                       device="cpu")
    pool.ensure_capacity(1, 6)
    llama.prefill(MODEL, pool.cache, np.arange(1, 7), pool.block_table(1),
                  0, 6)
    pool.fork_session(1, 2)
    tables = np.stack([pool.block_table(1), pool.block_table(2)])
    pos, live = np.array([6, 6]), np.array([True, True])
    blk, off = llama._write_indices(pos, tables, live, NB, BS)
    assert blk[0] == blk[1] and off[0] == off[1]  # shared tail: a clash
    assert pool.make_writable(2, 6, 7) == 1
    tables[1] = pool.block_table(2)
    blk, off = llama._write_indices(pos, tables, live, NB, BS)
    assert (blk[0], off[0]) != (blk[1], off[1])
