"""Fault-tolerant elastic trainer example — word2vec (CBOW) on real text;
the port's copy of ``examples/train_ft.py``.

Port of the reference's flagship example (reference
example/train_ft.py:15-118: word2vec/imikolov on paddle.v2, pserver
discovery via etcd, data via the master task queue).  Here:

  * the corpus is a real text file (``examples/data/tiny_corpus.txt``)
    tokenized and sharded to disk ONCE by a claim-elected seeder
    (``runtime.corpus`` + ``FileShardStore``), then leased as file shards;
  * parameters live on the trainer's device (``ElasticTrainer``), not in
    pservers;
  * data shards are leased from the coordination service's task queue
    (``TaskLeaseBatches`` = role of cloud_reader, train_ft.py:112) — a dead
    trainer's shard is dispatched again after the task timeout;
  * trainer count appears nowhere (the property that makes the job
    elastic, SURVEY §3.4).

Run standalone (an in-process coordinator, the shipped corpus, the card):

    python -m edl_tpu_torch.examples.train_ft [--device cuda:0]

or as a pod entry under the launcher, which exports
EDL_COORD_HOST/EDL_COORD_PORT/EDL_WORKER_NAME:

    python -m edl_tpu_torch.runtime.launcher start_trainer

Env: ``EDL_DATA_FILE`` picks a different corpus (empty string →
synthetic fallback); ``EDL_DATA_DIR`` is where shards are written (shared
storage in a real deployment); ``EDL_PASSES`` the passes (default 2)."""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

VOCAB = 2048       # role of imikolov's word dict (train_ft.py:32-34)
CONTEXT = 4        # N-gram context, reference wordemb (train_ft.py:57-76)
EMBED = 32
BATCH = 32         # reference batch size (train_ft.py:113)
SHARDS = 16

#: the shipped corpus, a data file of the repository
DEFAULT_CORPUS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "examples", "data", "tiny_corpus.txt")


def synthetic_corpus(n_examples: int = 8192, seed: int = 0):
    """Synthetic context → target pairs standing in for the imikolov
    RecordIO shards the reference pre-converts into its example image."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, VOCAB, (n_examples, CONTEXT), dtype=np.int32)
    # target fully determined by the context, so the loss falls fast
    tgt = ctx[:, 0].copy()
    return ctx, tgt


def connect_coordinator(passes: int):
    """Coordinator from the launcher env, else an in-process service."""
    host = os.environ.get("EDL_COORD_HOST")
    if host:
        from edl_tpu_torch.coord.client import CoordClient

        return CoordClient(host, int(os.environ["EDL_COORD_PORT"]))
    from edl_tpu_torch.coord.service import PyCoordService

    return PyCoordService(passes=passes)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the trainer's device (the card unless asked)")
    ap.add_argument("--passes", type=int,
                    default=int(os.environ.get("EDL_PASSES", "2")))
    args = ap.parse_args(argv)

    from edl_tpu_torch.device import resolve
    from edl_tpu_torch.models import word2vec
    from edl_tpu_torch.runtime import optim
    from edl_tpu_torch.runtime.data import (FileShardStore, ShardRegistry,
                                            TaskLeaseBatches, ensure_seeded)
    from edl_tpu_torch.runtime.elastic import ElasticTrainer

    dev = resolve(args.device)
    worker = os.environ.get("EDL_WORKER_NAME", "local-0")
    coord = connect_coordinator(args.passes)

    data_file = os.environ.get("EDL_DATA_FILE", DEFAULT_CORPUS)
    if data_file and os.path.exists(data_file):
        # REAL data: tokenize + shard the corpus to disk once (the
        # claim-elected seeder with crash takeover — ensure_seeded), then
        # everyone leases the FILES (role of RecordIO chunks + master
        # task list, reference example/train_ft.py:112)
        from edl_tpu_torch.runtime import corpus

        data_dir = os.environ.get(
            "EDL_DATA_DIR",
            os.path.join(tempfile.gettempdir(),
                         f"edl-train-ft-{os.path.basename(data_file)}"))

        def seed(beat):
            FileShardStore.enqueue(coord, corpus.prepare_shards(
                data_file, data_dir, num_shards=SHARDS,
                vocab_size=VOCAB, context=CONTEXT, on_shard=beat))

        ensure_seeded(coord, worker, seed)
        meta = corpus.load_vocab_meta(data_dir)
        vocab_size, fetch = meta["vocab_size"], FileShardStore.fetch
        print(f"[{worker}] corpus {os.path.basename(data_file)}: "
              f"{meta['tokens']} tokens, vocab {vocab_size}, "
              f"{SHARDS} file shards in {data_dir}", flush=True)
    else:
        # synthetic fallback: every worker registers the same
        # deterministic split; one CAS-elected worker enqueues
        registry = ShardRegistry()
        shard_ids = registry.register_arrays(synthetic_corpus(), SHARDS)
        if coord.kv_cas("data-seeder", b"", worker.encode()):
            registry.enqueue(coord, shard_ids)
        vocab_size, fetch = VOCAB, registry.fetch

    model = word2vec.Word2Vec(vocab_size, CONTEXT, EMBED, device=dev)
    trainer = ElasticTrainer(word2vec.loss_fn, model, optim.adam(3e-3),
                             devices=[dev])

    losses = []
    batches = TaskLeaseBatches(coord, worker, fetch, BATCH)
    for i, batch in enumerate(batches):
        losses.append(trainer.step(batch))
        if i % 50 == 0:
            print(f"[{worker}] step {trainer.state.step} "
                  f"pass {coord.current_pass()} loss {losses[-1]:.4f}",
                  flush=True)
    stats = coord.stats()
    print(f"[{worker}] done on {dev}: {trainer.state.step} steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"queue done={stats.done} todo={stats.todo} "
          f"dropped={stats.dropped}", flush=True)
    if not losses[-1] < losses[0]:
        print(f"[{worker}] the loss did not fall", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
