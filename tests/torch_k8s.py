"""Shared helpers of the port's control-plane tests: the stub apiserver of
``tests/k8s_stub.py`` installed as the ``kubernetes`` package for the
port's ``cluster/k8s.py``, GPU nodes and pods for it, a control plane over
it, and the CR manifests the scenarios apply.

The stub's ``make_node``/``make_pod`` put a TPU count under
``google.com/tpu``; :func:`gpu_node` and :func:`gpu_pod` build the same
objects claiming ``nvidia.com/gpu`` cards instead.
"""

from __future__ import annotations

import importlib
import sys
import time

import pytest

from tests.k8s_stub import StubState, build_module, make_node, make_pod

GPU = "nvidia.com/gpu"


def gpu_node(name: str, cpu: str = "8", memory: str = "16Gi", gpus: int = 0,
             labels=None):
    node = make_node(name, cpu=cpu, memory=memory, labels=labels)
    if gpus:
        node.status.allocatable[GPU] = str(gpus)
    return node


def gpu_pod(name: str, gpus: int = 0, **kw):
    pod = make_pod(name, **kw)
    if gpus:
        pod.spec.containers[0].resources.limits[GPU] = str(gpus)
    return pod


def install(monkeypatch, module):
    """``module`` as ``kubernetes``, and the port's backend reloaded so its
    import guard sees it; returns the reloaded backend module."""
    monkeypatch.setitem(sys.modules, "kubernetes", module)
    import edl_tpu_torch.cluster.k8s as k8s_mod

    importlib.reload(k8s_mod)
    assert k8s_mod._HAVE_K8S
    return k8s_mod


def uninstall(monkeypatch) -> None:
    """Back to the no-kubernetes reality for every other test."""
    import edl_tpu_torch.cluster.k8s as k8s_mod

    monkeypatch.delitem(sys.modules, "kubernetes")
    importlib.reload(k8s_mod)


@pytest.fixture
def port_kube(monkeypatch):
    """The stub apiserver with one 8-card GPU node in NVLink domain
    ``nvl-a``; yields (the port's k8s module, StubState)."""
    state = StubState()
    state.nodes = [gpu_node("a0", cpu="64", memory="128Gi", gpus=8,
                            labels={"edl-tpu/nvlink-domain": "nvl-a"})]
    k8s_mod = install(monkeypatch, build_module(state))
    yield k8s_mod, state
    uninstall(monkeypatch)


@pytest.fixture
def port_control_plane(port_kube):
    """A deployed-style control plane of the port over the stub apiserver:
    (K8sCluster, Controller, TrainingJobSyncLoop, StubState)."""
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.controller.sync import TrainingJobSyncLoop

    k8s_mod, state = port_kube
    cluster = k8s_mod.K8sCluster(kubeconfig="ignored")
    controller = Controller(cluster, updater_convert_seconds=0.05,
                            updater_confirm_seconds=0.05)
    sync = TrainingJobSyncLoop(cluster, controller, poll_seconds=0.05)
    yield cluster, controller, sync, state
    controller.stop()


def cr_manifest(name="job1", lo=2, hi=4, fault_tolerant=True) -> dict:
    """What a user would ``kubectl apply`` (k8s/crd.yaml's shape), claiming
    one card a trainer."""
    return {
        "apiVersion": "edl.tpu/v1",
        "kind": "TrainingJob",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {
            "image": "edl-tpu-job:latest",
            "fault_tolerant": fault_tolerant,
            "trainer": {
                "entrypoint": "python train.py",
                "min_instance": lo,
                "max_instance": hi,
                "resources": {
                    "requests": {"cpu": "1", "memory": "1Gi"},
                    "limits": {"cpu": "1", "memory": "1Gi", GPU: "1"},
                },
            },
        },
    }


def run_trainer_pods(state: StubState, name: str, n: int,
                     namespace: str = "default") -> None:
    """The kubelet's role: the trainer Job's pods come up Running."""
    state.pods = [p for p in state.pods
                  if (p.metadata.labels or {}).get("edl-tpu-job") != name]
    for i in range(n):
        state.pods.append(gpu_pod(
            f"{name}-trainer-{i}", namespace=namespace, phase="Running",
            node="a0", labels={"edl-tpu-job": name}, cpu="1",
            memory="1Gi", gpus=1))


def wait_phase(sync, state: StubState, name: str, phase: str,
               timeout: float = 15.0, namespace: str = "default") -> dict:
    """Tick the sync loop until the CR's *recorded* status shows phase."""
    deadline = time.monotonic() + timeout
    cr = None
    while time.monotonic() < deadline:
        sync.run_once()
        cr = state.custom_objects.get(
            ("edl.tpu", namespace, "trainingjobs", name))
        if cr is not None and (cr.get("status") or {}).get("phase") == phase:
            return cr
        time.sleep(0.05)
    raise TimeoutError(
        f"CR {name} never reached recorded phase {phase}; "
        f"have {(cr or {}).get('status')!r}")
