"""Real data end to end in the port: the scenarios of tests/test_real_data.py
on edl_tpu_torch.runtime.corpus and the port's train_ft, the corpus' shards
and vocab.json byte-equal to the JAX package's on the shipped
tiny_corpus.txt, and the port's word2vec held to JAX's on converted params
(fp32, 1e-5)."""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import word2vec as ref_w2v
from edl_tpu.runtime import corpus as ref_corpus
from edl_tpu_torch.interop import params_to_numpy, word2vec_from_numpy
from edl_tpu_torch.models import word2vec
from edl_tpu_torch.runtime import corpus
from edl_tpu_torch.runtime.data import FileShardStore

CORPUS = Path(__file__).resolve().parent.parent / "examples" / "data" / \
    "tiny_corpus.txt"
#: fp32 agreement of the port's word2vec with JAX's on the same params
ATOL = 1e-5


def test_vocab_and_windows_roundtrip():
    text = CORPUS.read_text()
    vocab = corpus.build_vocab(text, 512)
    assert vocab == ref_corpus.build_vocab(text, 512)
    assert vocab["<unk>"] == corpus.UNK
    assert vocab["the"] == 4  # the most common word of the corpus
    ids = corpus.tokenize(text, vocab)
    assert ids.dtype == np.int32
    assert np.array_equal(ids, ref_corpus.tokenize(text, vocab))
    assert (ids == corpus.BOS).sum() == (ids == corpus.EOS).sum() > 0
    ctx, tgt = corpus.context_windows(ids, 4)
    assert ctx.shape == (len(ids) - 4, 4)
    assert np.array_equal(ctx[1, :3], ctx[0, 1:])
    assert tgt[0] == ids[4]
    with pytest.raises(ValueError, match="corpus too small"):
        corpus.context_windows(ids[:3], 4)


@pytest.mark.parametrize("num_shards,vocab_size,context",
                         [(8, 512, 4), (16, 2048, 4), (3, 64, 2)])
def test_shards_and_vocab_byte_equal_to_the_reference(tmp_path, num_shards,
                                                      vocab_size, context):
    ours = corpus.prepare_shards(str(CORPUS), str(tmp_path / "port"),
                                 num_shards=num_shards,
                                 vocab_size=vocab_size, context=context)
    ref = ref_corpus.prepare_shards(str(CORPUS), str(tmp_path / "ref"),
                                    num_shards=num_shards,
                                    vocab_size=vocab_size, context=context)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in ref]
    for a, b in zip(ours, ref):
        assert Path(a).read_bytes() == Path(b).read_bytes(), a
    assert (tmp_path / "port" / "vocab.json").read_bytes() == \
        (tmp_path / "ref" / "vocab.json").read_bytes()
    assert corpus.load_vocab_meta(str(tmp_path / "port")) == \
        ref_corpus.load_vocab_meta(str(tmp_path / "ref"))


def test_prepare_shards_writes_real_files(tmp_path):
    out = str(tmp_path / "shards")
    beats = []
    paths = corpus.prepare_shards(str(CORPUS), out, num_shards=8,
                                  vocab_size=512, context=4,
                                  on_shard=lambda: beats.append(1))
    assert len(paths) == 8 == len(beats)
    meta = corpus.load_vocab_meta(out)
    assert meta["vocab_size"] <= 512 and meta["context"] == 4
    total = 0
    for p in paths:
        ctx, tgt = FileShardStore.fetch_path(p)
        assert ctx.shape[1] == 4 and ctx.dtype == np.int32
        assert int(ctx.max()) < meta["vocab_size"]
        total += len(tgt)
    assert total == meta["tokens"] - 4
    before = open(paths[0], "rb").read()
    corpus.prepare_shards(str(CORPUS), out, num_shards=8, vocab_size=512,
                          context=4)
    assert open(paths[0], "rb").read() == before


def _reference_params(seed: int, vocab: int, context: int, emb: int,
                      hidden: int) -> dict:
    params = ref_w2v.init(jax.random.key(seed), vocab, context, emb, hidden)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("vocab,context,emb,hidden,batch",
                         [(306, 4, 32, 256, 32), (64, 2, 8, 16, 5)])
def test_word2vec_logits_and_loss_equal_jax(vocab, context, emb, hidden,
                                            batch):
    tree = _reference_params(3, vocab, context, emb, hidden)
    model = word2vec_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(7)
    ctx = rng.integers(0, vocab, (batch, context), dtype=np.int32)
    tgt = rng.integers(0, vocab, (batch,), dtype=np.int32)
    want = np.asarray(ref_w2v.apply(tree, jnp.asarray(ctx)))
    with torch.no_grad():
        got = word2vec.apply(model, torch.from_numpy(ctx)).numpy()
        loss = float(word2vec.loss_fn(model, (torch.from_numpy(ctx),
                                              torch.from_numpy(tgt))))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    ref_loss = float(ref_w2v.loss_fn(tree, (jnp.asarray(ctx),
                                            jnp.asarray(tgt))))
    assert abs(loss - ref_loss) <= ATOL
    # the converter's inverse gives the tree back
    back = params_to_numpy(model)
    assert sorted(back) == sorted(tree)
    for k in tree:
        assert np.array_equal(back[k], tree[k])


def test_word2vec_grads_equal_jax():
    tree = _reference_params(0, 64, 4, 8, 16)
    model = word2vec_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(1)
    ctx = rng.integers(0, 64, (6, 4), dtype=np.int32)
    tgt = rng.integers(0, 64, (6,), dtype=np.int32)
    word2vec.loss_fn(model, (torch.from_numpy(ctx),
                             torch.from_numpy(tgt))).backward()
    grads = jax.grad(ref_w2v.loss_fn)(tree, (jnp.asarray(ctx),
                                             jnp.asarray(tgt)))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads[name]),
                                   rtol=0, atol=ATOL)


def test_word2vec_init_shapes_and_scales():
    model = word2vec.Word2Vec(300, 4, 32, 256, device="cpu", seed=0)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ref = {k: v.shape for k, v in _reference_params(0, 300, 4, 32,
                                                    256).items()}
    assert shapes == ref
    assert abs(float(model.emb.detach().std()) - 32 ** -0.5) < 0.01
    assert float(model.b_h.detach().abs().sum()) == 0.0


def test_train_ft_trains_on_bytes_from_disk(tmp_path, capsys, monkeypatch):
    """The port's example end to end on the real corpus, on the CPU: the
    seeder bakes file shards, the queue leases them, the loss falls, and
    the accounting is exactly-once."""
    from edl_tpu_torch.examples import train_ft

    data_dir = str(tmp_path / "data")
    monkeypatch.setenv("EDL_DATA_FILE", str(CORPUS))
    monkeypatch.setenv("EDL_DATA_DIR", data_dir)
    monkeypatch.delenv("EDL_COORD_HOST", raising=False)
    assert train_ft.main(["--device", "cpu", "--passes", "1"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"corpus tiny_corpus\.txt: (\d+) tokens, vocab (\d+)", out)
    assert m, out
    assert int(m.group(2)) < 1024
    m = re.search(r"loss ([0-9.]+) -> ([0-9.]+); queue done=(\d+) "
                  r"todo=(\d+) dropped=(\d+)", out)
    assert m, out
    assert float(m.group(2)) < float(m.group(1))
    assert tuple(int(m.group(i)) for i in (3, 4, 5)) == (train_ft.SHARDS,
                                                          0, 0)
    meta = json.load(open(os.path.join(data_dir, "vocab.json")))
    shard_files = [f for f in os.listdir(data_dir)
                   if f.startswith("shard-") and f.endswith(".npz")]
    assert len(shard_files) == train_ft.SHARDS
    assert meta["source"] == "tiny_corpus.txt"


def test_train_ft_synthetic_fallback(tmp_path, capsys, monkeypatch):
    from edl_tpu_torch.examples import train_ft

    monkeypatch.setenv("EDL_DATA_FILE", "")
    monkeypatch.delenv("EDL_COORD_HOST", raising=False)
    assert train_ft.main(["--device", "cpu", "--passes", "1"]) == 0
    out = capsys.readouterr().out
    assert "corpus" not in out and "queue done=16" in out


def test_train_ft_defaults_to_the_card(monkeypatch):
    from edl_tpu_torch.examples import train_ft

    if torch.cuda.is_available():  # pragma: no cover - a machine with a card
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("EDL_COORD_HOST", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ft.main([])
