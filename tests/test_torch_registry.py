"""The port's module registry (``nextsimdg_tpu_torch.modules``): the same
contract as the JAX package's ``ModuleRegistry``, and the momentum solver of
``CoupledModel`` selected through it. Every test that selects an
implementation of the process-wide registry resets it in ``finally``."""

import pytest
import torch

from nextsimdg_tpu.dynamics import MEVPSolver as JaxMEVPSolver
from nextsimdg_tpu.modules import ModuleRegistry as JaxModuleRegistry
from nextsimdg_tpu_torch import modules
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import MEVPSolver, MEVPSolverHO, RectMesh

torch.set_num_threads(1)

DYNAMICS = "Nextsim::IDynamics"
HO = "Nextsim::MEVPHighOrder"


@pytest.fixture
def fresh(monkeypatch):
    """A registry of its own, so that registrations do not outlive the test."""
    registry = modules.ModuleRegistry()
    monkeypatch.setattr(modules.ModuleRegistry, "_instance", registry)
    return registry


class Thing:
    def __init__(self):
        self.tag = "thing"


def test_the_default_is_the_first_registered(fresh):
    fresh.register("Test::IThing", "Test::First", lambda: "first")
    fresh.register("Test::IThing", "Test::Second", lambda: "second")
    fresh.register("Test::IThing", "Test::First", lambda: "first again")  # replaces, keeps order
    assert fresh.list_modules() == ["Test::IThing"]
    assert fresh.list_implementations("Test::IThing") == ["Test::First", "Test::Second"]
    assert fresh.selected_name("Test::IThing") == "Test::First"
    assert fresh.get_implementation("Test::IThing") == "first again"


@pytest.mark.parametrize(
    "call",
    [
        lambda r: r.set_implementation("Test::INone", "Test::First"),
        lambda r: r.set_implementation("Test::IThing", "Test::Missing"),
        lambda r: r.get_implementation("Test::INone"),
        lambda r: r.get_instance("Test::INone"),
        lambda r: r.list_implementations("Test::INone"),
        lambda r: r.set_default("Test::INone"),
    ],
    ids=["interface", "implementation", "get_implementation", "get_instance", "list", "default"],
)
def test_unknown_names_raise(fresh, call):
    fresh.register("Test::IThing", "Test::First", lambda: "first")
    with pytest.raises(modules.ModuleError):
        call(fresh)
    assert issubclass(modules.ModuleError, ValueError)


def test_select_reset_and_the_static_instance(fresh):
    modules.register_implementation("Test::IThing", "Test::Class")(Thing)
    constant = object()
    modules.register_implementation("Test::IThing", "Test::Constant")(constant)
    assert modules.get_loader() is fresh
    static = fresh.get_implementation("Test::IThing")
    assert isinstance(static, Thing) and fresh.get_implementation("Test::IThing") is static
    fresh_one = fresh.get_instance("Test::IThing")
    assert isinstance(fresh_one, Thing) and fresh_one is not static
    fresh.set_implementation("Test::IThing", "Test::Constant")
    assert fresh.get_implementation("Test::IThing") is constant
    assert fresh.get_instance("Test::IThing") is constant
    fresh.set_implementation("Test::IThing", "Test::Class")  # a new static instance
    assert fresh.get_implementation("Test::IThing") is not static
    fresh.set_implementation("Test::IThing", "Test::Constant")
    fresh.reset()
    assert fresh.selected_name("Test::IThing") == "Test::Class"
    fresh.set_implementation("Test::IThing", "Test::Constant")
    fresh.set_all_defaults()
    assert fresh.selected_name("Test::IThing") == "Test::Class"


def test_the_dynamics_solvers_are_registered_in_order():
    loader = modules.get_loader()
    assert loader.list_implementations(DYNAMICS) == [
        "Nextsim::MEVPDynamics", "Nextsim::FreeDrift", HO,
    ]
    assert loader.get_instance(DYNAMICS) is MEVPSolver  # the registered instance is the class
    loader.set_implementation(DYNAMICS, HO)
    try:
        assert loader.get_implementation(DYNAMICS) is MEVPSolverHO
    finally:
        loader.reset()
    assert loader.selected_name(DYNAMICS) == "Nextsim::MEVPDynamics"


def test_coupled_model_takes_the_ho_solver_only_when_selected():
    mesh = RectMesh(16, 16, 4e3, 4e3)
    model = CoupledModel(mesh)
    assert type(model.mevp) is MEVPSolver and not model.is_high_order
    loader = modules.get_loader()
    loader.set_implementation(DYNAMICS, HO)
    try:
        ho = CoupledModel(mesh, mevp_backend="pallas-tiled")
        # The two packages keep registries of their own.
        assert JaxModuleRegistry.get_loader().get_implementation(DYNAMICS) is JaxMEVPSolver
    finally:
        loader.reset()
    assert isinstance(ho.mevp, MEVPSolverHO) and ho.is_high_order
    assert ho.mevp.backend == "pallas-tiled" and ho.mevp_schedule() == "tiled"
    assert type(CoupledModel(mesh).mevp) is MEVPSolver
