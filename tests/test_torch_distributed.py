"""Multi-process initialization of the port, and the coupled CLI's geometry
token: the twin of ``tests/test_distributed.py``.

``torch.distributed.init_process_group`` is monkeypatched: the
initialization's rules (idempotent, the no-argument form runs alone where
the launcher's environment is absent or unreachable, explicit coordinates
refuse to degrade) are checked without a group; the backend choice (gloo on
the CPU, nccl only with a card for every process of the node) with the
card count patched.
"""

import datetime

import pytest
import torch
import torch.distributed as dist

from nextsimdg_tpu_torch.parallel import distributed

ENV = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "4", "RANK": "2"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for key in (*ENV, "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    distributed.shutdown()
    yield
    distributed.shutdown()


def test_initialize_runs_alone_when_env_autodetect_fails(monkeypatch):
    """The no-argument form may fall back to one process."""
    calls = []

    def boom(**kwargs):
        calls.append(kwargs)
        raise RuntimeError("no coordinator reachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    distributed.initialize()  # no launcher environment: never tries
    assert calls == []
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    distributed.initialize()  # must not raise
    assert len(calls) == 1 and calls[0]["init_method"] == "env://"
    assert not distributed.is_multi_host()
    assert (distributed.local_device_count(), distributed.global_device_count()) == (1, 1)


def test_initialize_raises_on_explicit_coordinates(monkeypatch):
    """A configured launch must fail loudly, not step 1/N of the domain."""

    def boom(**kwargs):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="refusing to degrade"):
        distributed.initialize(coordinator_address="10.0.0.1:1234", num_processes=4, process_id=0)
    with pytest.raises(ValueError, match="explicit coordinates"):
        distributed.initialize(coordinator_address="10.0.0.1:1234", num_processes=4)


def test_initialize_passes_coordinates_through(monkeypatch):
    seen = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kwargs: seen.append(kwargs))
    distributed.initialize(coordinator_address="10.0.0.1:1234", num_processes=4, process_id=2,
                           ranks_per_process=2, timeout=30.0)
    assert seen == [dict(
        backend="gloo", init_method="tcp://10.0.0.1:1234", world_size=4, rank=2,
        timeout=datetime.timedelta(seconds=30.0),
    )]
    distributed.initialize(coordinator_address="file:///tmp/x", num_processes=4, process_id=2)
    assert len(seen) == 1  # idempotent
    assert distributed.local_device_count() == 2
    distributed.shutdown()
    distributed.initialize(coordinator_address="file:///tmp/rdv", num_processes=2, process_id=1)
    assert seen[-1]["init_method"] == "file:///tmp/rdv"


def test_enum_wrapper_rejects_unknown_geometry():
    """The coupled CLI's EnumWrapper raises on unmapped tokens, as the JAX
    package's."""
    from nextsimdg_tpu.runtime.coupled_main import _GEOMETRY as jax_geometry
    from nextsimdg_tpu_torch.runtime.coupled_main import _GEOMETRY, Geometry

    assert _GEOMETRY("cartesian") is Geometry.CARTESIAN
    assert _GEOMETRY(" spherical ") is Geometry.SPHERICAL
    for token in ("cartesian", " spherical ", "spherical\t"):
        assert _GEOMETRY(token).name == jax_geometry(token).name
    with pytest.raises(ValueError, match="cylindrical"):
        _GEOMETRY("cylindrical")


@pytest.mark.parametrize("cards, processes, requested, expected", [
    (1, 4, None, "gloo"), (4, 4, None, "nccl"), (8, 4, None, "nccl"), (1, 1, None, "nccl"),
    (4, 4, "gloo", "gloo"), (2, 2, "nccl", "nccl"),
])
def test_backend_choice_on_a_card(monkeypatch, cards, processes, requested, expected):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert distributed.choose_backend("cuda", processes, requested) == expected


def test_nccl_with_fewer_cards_than_processes_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="a card for each"):
        distributed.choose_backend("cuda", 4, "nccl")
    called = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kwargs: called.append(kwargs))
    with pytest.raises(RuntimeError, match="a card for each"):
        distributed.initialize("10.0.0.1:1234", 4, 0, backend="nccl", device="cuda")
    assert called == []  # raised before any init, and never retried on gloo
    with pytest.raises(ValueError, match="CUDA"):
        distributed.choose_backend("cpu", 2, "nccl")
    assert distributed.choose_backend("cpu", 2) == "gloo"
