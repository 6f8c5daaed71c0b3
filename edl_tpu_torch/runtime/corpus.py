"""Text corpus → tokenized, sharded training data on disk — the port's copy
of edl_tpu.runtime.corpus (the same bytes from the same text).

Role of the reference's data-preparation bake (reference
example/Dockerfile:1-8: `paddle.dataset.common.convert` pre-converts the
imikolov corpus into RecordIO chunk files inside the job image; trainers
then lease chunks through the master, example/train_ft.py:112).  Here the
same pipeline is a library:

  text file → frequency-ranked word vocab → token ids → CBOW context
  windows → :class:`~edl_tpu_torch.runtime.data.FileShardStore` ``.npz``
  shards + a ``vocab.json`` next to them.

The shards are leased through the coordination service's task queue like
any other file shards — nothing downstream knows the data came from text.
Examples are fixed-shape int32 arrays, batchable straight onto the device;
the vocab is capped, which bounds the output projection's width.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter

import numpy as np

#: ids 0..3 reserved (role of imikolov's <unk>/<s>/<e> specials)
PAD, UNK, BOS, EOS = 0, 1, 2, 3
_SPECIALS = ["<pad>", "<unk>", "<s>", "</s>"]

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def words(text: str) -> list[str]:
    """Lowercased word stream (the reference's imikolov preprocessing is
    also a lowercase word split)."""
    return _TOKEN_RE.findall(text.lower())


def build_vocab(text: str, vocab_size: int) -> dict[str, int]:
    """Frequency-ranked vocab, specials first, capped at ``vocab_size``."""
    counts = Counter(words(text))
    vocab = {w: i for i, w in enumerate(_SPECIALS)}
    for w, _n in counts.most_common(max(vocab_size - len(_SPECIALS), 0)):
        vocab[w] = len(vocab)
    return vocab


def tokenize(text: str, vocab: dict[str, int]) -> np.ndarray:
    """Token ids per sentence line, BOS/EOS framed, one flat stream."""
    ids: list[int] = []
    for line in text.splitlines():
        ws = words(line)
        if not ws:
            continue
        ids.append(BOS)
        ids.extend(vocab.get(w, UNK) for w in ws)
        ids.append(EOS)
    return np.asarray(ids, dtype=np.int32)


def context_windows(ids: np.ndarray, context: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """CBOW examples: ``context`` preceding tokens → next token (the
    reference's N-gram wordemb shape, example/train_ft.py:57-76)."""
    n = len(ids) - context
    if n <= 0:
        raise ValueError(
            f"corpus too small: {len(ids)} tokens for context {context}")
    idx = np.arange(n)[:, None] + np.arange(context)[None, :]
    return ids[idx], ids[context:].copy()


def prepare_shards(text_path: str, out_dir: str, *, num_shards: int,
                   vocab_size: int = 2048, context: int = 4,
                   on_shard=None) -> list[str]:
    """The full bake: tokenize ``text_path`` and write FileShardStore
    shards + ``vocab.json`` into ``out_dir``.  Idempotent (same inputs →
    same bytes), like the shard writer itself, so a seeding takeover
    after a crash re-writes safely."""
    from edl_tpu_torch.runtime.data import FileShardStore

    with open(text_path, encoding="utf-8") as f:
        text = f.read()
    vocab = build_vocab(text, vocab_size)
    ctx, tgt = context_windows(tokenize(text, vocab), context)
    os.makedirs(out_dir, exist_ok=True)
    vpath = os.path.join(out_dir, "vocab.json")
    tmp = vpath + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"vocab_size": len(vocab), "context": context,
                   "source": os.path.basename(text_path),
                   "tokens": int(len(tgt) + context),
                   "vocab": vocab}, f)
    os.replace(tmp, vpath)
    return FileShardStore.write_shards(out_dir, (ctx, tgt), num_shards,
                                       on_shard=on_shard)


def load_vocab_meta(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "vocab.json"), encoding="utf-8") as f:
        return json.load(f)
