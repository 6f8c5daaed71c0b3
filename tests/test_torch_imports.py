"""The port stands alone: no module of edl_tpu_torch, and not chip_smoke.py,
imports jax, optax or anything of the JAX package, and its entry points
refuse to run quietly on the CPU when no CUDA device exists."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "edl_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "edl_tpu", "__graft_entry__"}


def _port_modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'optax', 'edl_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {list(_port_modules())!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('imported', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "imported" in proc.stdout


#: the control plane's copies (coordinator, resource model and its
#: validation, cluster, scheduler, controller), the elastic job and the
#: fault campaign: each is in the scan and the blocked-import run above
CONTROL_PLANE = ("edl_tpu_torch.coord", "edl_tpu_torch.coord.service",
                 "edl_tpu_torch.api", "edl_tpu_torch.api.quantity",
                 "edl_tpu_torch.api.types", "edl_tpu_torch.cluster",
                 "edl_tpu_torch.cluster.base", "edl_tpu_torch.cluster.fake",
                 "edl_tpu_torch.cluster.resource",
                 "edl_tpu_torch.runtime.local",
                 "edl_tpu_torch.runtime.data",
                 "edl_tpu_torch.api.validation", "edl_tpu_torch.scheduler",
                 "edl_tpu_torch.scheduler.topology",
                 "edl_tpu_torch.scheduler.planner",
                 "edl_tpu_torch.scheduler.autoscaler",
                 "edl_tpu_torch.controller",
                 "edl_tpu_torch.controller.updater",
                 "edl_tpu_torch.controller.controller",
                 "edl_tpu_torch.runtime.chaos",
                 "edl_tpu_torch.runtime.faults")


#: the multi-process world: the native coordinator's bindings, client,
#: server and KV sweep, discovery, the supervisor and its worker
MULTI_PROCESS = ("edl_tpu_torch.coord.bindings", "edl_tpu_torch.coord.client",
                 "edl_tpu_torch.coord.server", "edl_tpu_torch.coord.gc",
                 "edl_tpu_torch.runtime.discovery",
                 "edl_tpu_torch.runtime.multihost",
                 "edl_tpu_torch.runtime.multihost_worker",
                 "edl_tpu_torch.observability.tracing",
                 "edl_tpu_torch.observability.goodput")


#: the single-shot serving plane and its control loop: the fleet and
#: serve_main, the SLO scaler, the health and address-publishing halves
#: of observability, the goodput curves, the identity optimizer
SERVING = ("edl_tpu_torch.runtime.serving",
           "edl_tpu_torch.scheduler.autoscaler",
           "edl_tpu_torch.observability.health",
           "edl_tpu_torch.observability.scrape",
           "edl_tpu_torch.observability.goodput",
           "edl_tpu_torch.observability.metrics",
           "edl_tpu_torch.runtime.optim", "edl_tpu_torch.entry")


@pytest.mark.parametrize("module", CONTROL_PLANE + MULTI_PROCESS + SERVING)
def test_the_control_plane_modules_are_covered(module):
    assert module in set(_port_modules())


def test_the_native_core_stands_alone():
    """The port's C++ coordinator is its own copy: no source includes a
    file of the JAX package, and the Makefile builds from its own
    directory into the directory it is given (never the JAX package's)."""
    native = PKG / "coord" / "native"
    assert sorted(p.name for p in native.iterdir()) == [
        "Makefile", "capi.cc", "coord.cc", "coord.hpp", "server.cc"]
    for path in native.iterdir():
        text = path.read_text()
        for line in text.splitlines():
            if line.startswith("#include"):
                assert "edl_tpu/" not in line and ".." not in line, line
        assert "edl_tpu/coord" not in text.replace(
            "edl_tpu_torch/coord", ""), path
    assert "BUILD ?= build" in (native / "Makefile").read_text()


def test_no_source_names_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from edl_tpu_torch.entry import (bert_tp_world, bert_trainer,
                                     dryrun_multichip, entry,
                                     flagship_controlled_job,
                                     flagship_elastic_world,
                                     flagship_local_job, flagship_trainer,
                                     resnet_trainer)
    from edl_tpu_torch.models import bert, resnet
    from edl_tpu_torch.models import transformer as tfm
    from edl_tpu_torch.parallel.mesh import make_mesh
    from edl_tpu_torch.runtime import optim
    from edl_tpu_torch.runtime.elastic import ElasticTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship_trainer(cfg=tfm.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):  # before joining a group
        flagship_elastic_world(0, 1, tmp_path / "store", cfg=tfm.TINY)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):  # before spawning ranks
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        resnet_trainer(batch=2, hw=32, cfg=resnet.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        bert_trainer(batch=2, seq=16, cfg=bert.TINY)
    for build in (bert_tp_world, flagship_local_job,
                  flagship_controlled_job):  # before joining
        with pytest.raises(RuntimeError, match="CUDA"):
            build(0, 1, tmp_path / "store")
        assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm.Transformer(tfm.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        resnet.ResNet(resnet.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        bert.Bert(bert.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    model = tfm.Transformer(tfm.TINY, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticTrainer(tfm.loss_fn, model, optim.adamw(1e-3))


def test_entry_on_the_cpu_builds_the_flagship():
    from edl_tpu_torch.entry import entry

    fn, (model, tokens) = entry(device="cpu")
    assert tokens.shape == (2, 256)
    assert model.cfg.use_flash and model.cfg.d_model == 1024
    assert sum(p.numel() for p in model.parameters()) > 150e6


def test_main_path_trainer_on_the_cpu_takes_a_step():
    """The helper behind chip_smoke's main path, at TINY on the CPU: the
    flash path's plain versions inside one training step."""
    from edl_tpu_torch.entry import flagship_trainer
    from edl_tpu_torch.models import transformer as tfm

    trainer, (tokens, targets) = flagship_trainer(
        batch=2, seq=128, device="cpu", cfg=tfm.TINY)
    assert trainer.state.params.cfg.use_flash and trainer.world_size == 1
    assert tokens.shape == targets.shape == (2, 128)
    assert torch.equal(targets[:, :-1], tokens[:, 1:])
    first = trainer.step((tokens, targets))
    assert np.isfinite(first) and trainer.step((tokens, targets)) < first


@pytest.mark.parametrize("model", ["resnet", "bert"])
def test_model_zoo_trainers_on_the_cpu_take_a_step(model):
    """The helpers behind chip_smoke's ResNet-50 and BERT-base paths, at
    TINY on the CPU: the kernels' plain versions inside training steps."""
    import dataclasses

    from edl_tpu_torch.entry import bert_trainer, resnet_trainer
    from edl_tpu_torch.models import bert, resnet

    if model == "resnet":
        trainer, batch = resnet_trainer(batch=4, hw=32, device="cpu",
                                        cfg=resnet.TINY)
        assert batch[0].shape == (4, 32, 32, 3) and batch[1].shape == (4,)
    else:
        cfg = dataclasses.replace(bert.TINY, use_flash=True, max_seq_len=128)
        trainer, batch = bert_trainer(batch=2, seq=128, device="cpu",
                                      cfg=cfg)
        assert [t.shape for t in batch] == [(2, 128)] * 3
        assert set(batch[2].unique().tolist()) <= {0.0, 1.0}
    first = trainer.step(batch)
    assert np.isfinite(first) and trainer.step(batch) < first


def test_decode_plane_raises_without_cuda(monkeypatch):
    from edl_tpu_torch.entry import flagship_decode_fleet
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.models import transformer as tfm
    from edl_tpu_torch.runtime.serving import DecodeFleet, DecodeReplica

    model = tfm.Transformer(tfm.TINY, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship_decode_fleet(cfg=tfm.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeFleet(model, tfm.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeReplica("r", model, tfm.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_cache(tfm.TINY, 4, 4)


@pytest.mark.timeout_s(120)
def test_decode_fleet_helper_on_the_cpu_serves():
    """The helper behind chip_smoke's serving path, at TINY on the CPU: a
    session's tokens equal the model's own full-context greedy loop."""
    from edl_tpu_torch.entry import DECODE_DEFAULTS, flagship_decode_fleet
    from edl_tpu_torch.models import transformer as tfm

    fleet = flagship_decode_fleet(device="cpu", cfg=tfm.TINY,
                                  job="t/entry-decode")
    try:
        assert fleet.kv_blocks()[1] == DECODE_DEFAULTS["kv_blocks"]
        prompt = list(range(3, 80))
        got = fleet.submit(prompt, 6).wait(60)
    finally:
        fleet.stop()
    model = tfm.Transformer(tfm.TINY, device="cpu", seed=0)
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(6):
            seq.append(int(tfm.apply(model, torch.tensor([seq]))[0, -1]
                           .argmax()))
    assert got == seq[len(prompt):]


def test_durable_loop_modules_are_scanned():
    """The virtual-worker loop's modules stand in the scans above."""
    mods = set(_port_modules())
    assert {"edl_tpu_torch.models.mlp", "edl_tpu_torch.runtime.checkpoint",
            "edl_tpu_torch.runtime.data", "edl_tpu_torch.runtime.sdc",
            "edl_tpu_torch.runtime.virtual",
            "edl_tpu_torch.runtime.watchdog"} <= mods


def test_sdc_plane_modules_are_scanned():
    """The SDC plane's modules (the grown sdc.py, faults.py) and the
    prewarm's group-build queue stand in the scans above."""
    assert {"edl_tpu_torch.runtime.sdc", "edl_tpu_torch.runtime.faults",
            "edl_tpu_torch.parallel.mesh",
            "edl_tpu_torch.observability.collector"} <= set(_port_modules())


def test_durable_loop_raises_without_cuda(monkeypatch, tmp_path):
    from edl_tpu_torch.entry import flagship_virtual_world
    from edl_tpu_torch.models import mlp
    from edl_tpu_torch.models import transformer as tfm
    from edl_tpu_torch.runtime.virtual import vw_key, vw_keys

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship_virtual_world(0, 1, None, cfg=tfm.TINY, seq=32)
    with pytest.raises(RuntimeError, match="CUDA"):  # before joining a group
        flagship_virtual_world(0, 2, tmp_path / "store", cfg=tfm.TINY, seq=32)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        mlp.MLP([16, 32, 4])
    with pytest.raises(RuntimeError, match="CUDA"):
        vw_key(0, 0, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        vw_keys(0, 8, 0)


def test_fsdp_dryrun_and_choke_points_stand_alone():
    """The dryrun and the trainer's collective choke points import nothing
    of JAX, the JAX package or ``__graft_entry__``: with those blocked,
    ``dryrun_multichip(2)`` runs (its ranks import the same modules) and
    prints its record."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'optax', 'edl_tpu',"
        " '__graft_entry__'):\n"
        "    sys.modules[name] = None\n"
        "from edl_tpu_torch.runtime.elastic import (_all_gather,"
        " _all_reduce, _broadcast, _reduce_scatter, collective_census)\n"
        "from edl_tpu_torch.entry import dryrun_multichip\n"
        "if __name__ == '__main__':\n"
        "    dryrun_multichip(2, device='cpu')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DRYRUN_COMM " in proc.stdout
    assert {"edl_tpu_torch.entry", "edl_tpu_torch.runtime.elastic",
            "edl_tpu_torch.parallel.mesh"} <= set(_port_modules())
