"""The port's configuration stack (``nextsimdg_tpu_torch.config``) against the
JAX package's.

Each case of ``tests/test_configurator.py`` (the reference's
``Configurator_test.cpp``, ``CommandLineParser_test.cpp`` and
``ConfiguredModule_test.cpp``) runs through both packages on the same
sources; the parsed values, and the errors raised, must be equal. Module
selection runs on a fresh registry of each package, so the test modules it
registers do not outlive the test. Both process-wide Configurators are
cleared around every test.
"""

from types import SimpleNamespace

import pytest
import torch

import nextsimdg_tpu.config as jax_config
import nextsimdg_tpu.config.configurator as jax_configurator
import nextsimdg_tpu.config.enum_map as jax_enum_map
import nextsimdg_tpu.modules as jax_modules
import nextsimdg_tpu_torch.config as port_config
import nextsimdg_tpu_torch.config.configurator as port_configurator
import nextsimdg_tpu_torch.config.enum_map as port_enum_map
import nextsimdg_tpu_torch.modules as port_modules

torch.set_num_threads(1)


def package(config, configurator, enum_map, modules):
    return SimpleNamespace(
        Configurator=config.Configurator, OptionsDescription=config.OptionsDescription,
        Configured=config.Configured, try_configure=config.try_configure,
        CommandLineParser=config.CommandLineParser, ConfiguredModule=config.ConfiguredModule,
        parse_ini=configurator.parse_ini, EnumWrapper=enum_map.EnumWrapper, modules=modules,
    )


JAX = package(jax_config, jax_configurator, jax_enum_map, jax_modules)
PORT = package(port_config, port_configurator, port_enum_map, port_modules)


@pytest.fixture(autouse=True)
def clean_port():
    """The port's Configurator and registry selections, reset around each
    test (the JAX package's are reset by ``conftest.py``)."""
    PORT.Configurator.clear()
    PORT.modules.get_loader().reset()
    yield
    PORT.Configurator.clear()
    PORT.modules.get_loader().reset()


@pytest.fixture
def fresh_registries(monkeypatch):
    """A registry of each package's own, with the test interface's two
    implementations registered in order."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.modules.ModuleRegistry, "_instance", pkg.modules.ModuleRegistry())
        pkg.modules.register_implementation("Nextsim::ITest", "Nextsim::Impl1")(Impl1)
        pkg.modules.register_implementation("Nextsim::ITest", "Nextsim::Impl2")(Impl2)


class Impl1:
    def operation(self):
        return 1


class Impl2:
    def operation(self):
        return 2


def consumers(pkg):
    """The reference test's three consumer classes, on one package."""

    class Config1:
        """Raw-configurator consumer (Configurator_test.cpp Config1)."""

        def __init__(self):
            self.value = 0

        def configure(self):
            desc = pkg.OptionsDescription().add("config.value", int, -1)
            self.value = pkg.Configurator.parse(desc)["config.value"]

    class Config2(pkg.Configured):
        """Staged add_option/retrieve_value consumer (Config2)."""

        def __init__(self):
            self.value = 0
            self.name = ""
            Config2.add_option("config.value", -1)
            Config2.add_option("config.name", "")

        def configure(self):
            self.value = Config2.retrieve_value("config.value")
            self.name = Config2.retrieve_value("config.name")

    class Config3(pkg.Configured):
        """get_configuration consumer spanning two sections (Config3)."""

        def __init__(self):
            self.value = 0
            self.weight = 0.0

        def configure(self):
            self.value = pkg.Configured.get_configuration("config.value", -1)
            self.weight = pkg.Configured.get_configuration("data.weight", 1.0)

    return Config1, Config2, Config3


# -- the cases: each returns what it parsed -----------------------------------
def parse_one_stream_raw_configurator(pkg):
    config = consumers(pkg)[0]()
    config.configure()
    before = config.value
    pkg.Configurator.add_stream("[config]\nvalue = 42\n")
    config.configure()
    return before, config.value


def parse_one_stream_pointer_function(pkg):
    config = consumers(pkg)[1]()
    pkg.Configurator.add_stream("[config]\nvalue = 69105\nname = Zork\n")
    return pkg.try_configure(config), config.value, config.name


def parse_two_streams_one_class(pkg):
    config = consumers(pkg)[1]()
    pkg.Configurator.add_stream("[config]\nvalue = 69105\n")
    pkg.Configurator.add_stream("[config]\nname = Zork\n")
    pkg.try_configure(config)
    return config.value, config.name


def parse_streams_two_overlapping_classes(pkg):
    _, config2, config3 = consumers(pkg)
    config, confih = config2(), config3()
    pkg.Configurator.add_stream("[config]\nvalue = 69105\nname = Zork II\n")
    pkg.Configurator.add_stream("[data]\nweight = 0.467836\n")
    pkg.try_configure(config)
    pkg.try_configure(confih)
    return config.value, config.name, confih.value, confih.weight


def command_line_beats_streams(pkg):
    pkg.Configurator.set_command_line(["prog", "--config.value=7"])
    pkg.Configurator.add_stream("[config]\nvalue = 42\n")
    config = consumers(pkg)[0]()
    config.configure()
    return config.value


def earlier_stream_beats_later(pkg):
    pkg.Configurator.add_stream("[config]\nvalue = 1\n")
    pkg.Configurator.add_stream("[config]\nvalue = 2\n")
    config = consumers(pkg)[0]()
    config.configure()
    return config.value


def malformed_stream_is_skipped(pkg):
    pkg.Configurator.add_stream("this is not INI at all\n")
    pkg.Configurator.add_stream("[config]\nvalue = 13\n")
    config = consumers(pkg)[0]()
    config.configure()
    return config.value


def unknown_options_are_ignored(pkg):
    pkg.Configurator.add_stream("[other]\nsomething = 1\n[config]\nvalue = 5\nextra = 9\n")
    config = consumers(pkg)[0]()
    config.configure()
    return config.value


def parse_ini_sections_comments_and_bare_keys(pkg):
    return pkg.parse_ini(
        "# comment\nbare = 1\n[sec]\na = hello world \n; another comment\nb = 2 # trailing\n"
    )


def bool_lexical_casts(pkg):
    desc = pkg.OptionsDescription()
    texts = ("1", "0", "true", "False", "on", "OFF", "yes", "no")
    for i in range(len(texts)):
        desc.add(f"b.k{i}", bool, None)
    pkg.Configurator.add_stream("[b]\n" + "".join(f"k{i} = {t}\n" for i, t in enumerate(texts)))
    return pkg.Configurator.parse(desc)


def invalid_bool_raises(pkg):
    pkg.Configurator.add_stream("[b]\nflag = maybe\n")
    return pkg.Configurator.parse(pkg.OptionsDescription().add("b.flag", bool, True))


def enum_option(pkg):
    """An enum-typed option (``EnumWrapper.hpp``): mapped tokens convert."""
    geometry = pkg.EnumWrapper(int, {"rect": 0, "spherical": 1})
    pkg.Configurator.add_stream("[grid]\ngeometry = spherical \n")
    desc = pkg.OptionsDescription().add("grid.geometry", geometry, 0)
    return pkg.Configurator.parse(desc)


def unmapped_enum_token_raises(pkg):
    geometry = pkg.EnumWrapper(int, {"rect": 0, "spherical": 1})
    pkg.Configurator.add_stream("[grid]\ngeometry = torus\n")
    return pkg.Configurator.parse(pkg.OptionsDescription().add("grid.geometry", geometry, 0))


def command_line_parser_single_file(pkg):
    return pkg.CommandLineParser(["nextsim", "--config-file", "a.cfg"]).get_config_file_names()


def command_line_parser_multiple_files_preserve_order(pkg):
    parser = pkg.CommandLineParser(["nextsim", "--config-files", "z.cfg", "a.cfg", "m.cfg"])
    return parser.get_config_file_names()


def command_line_parser_help(pkg):
    return pkg.CommandLineParser(["nextsim", "--help"]).help_requested


def module_default_is_first_registered(pkg):
    loader = pkg.modules.ModuleRegistry.get_loader()
    loader.set_all_defaults()
    return loader.get_implementation("Nextsim::ITest").operation()


def module_selection_and_fresh_instance(pkg):
    loader = pkg.modules.ModuleRegistry.get_loader()
    loader.set_implementation("Nextsim::ITest", "Nextsim::Impl2")
    static = loader.get_implementation("Nextsim::ITest").operation()
    a = loader.get_instance("Nextsim::ITest")
    b = loader.get_instance("Nextsim::ITest")
    return static, a is not b, a.operation()


def module_static_instance_is_cached(pkg):
    loader = pkg.modules.ModuleRegistry.get_loader()
    loader.set_default("Nextsim::ITest")
    return loader.get_implementation("Nextsim::ITest") is loader.get_implementation("Nextsim::ITest")


def unknown_implementation_raises(pkg):
    pkg.modules.ModuleRegistry.get_loader().set_implementation("Nextsim::ITest", "Nextsim::NoSuchImpl")


def unknown_interface_raises(pkg):
    pkg.modules.ModuleRegistry.get_loader().set_implementation("Nextsim::NoSuchInterface", "Nextsim::Impl1")


def configured_module_selects_from_config(pkg):
    loader = pkg.modules.ModuleRegistry.get_loader()
    loader.set_all_defaults()
    pkg.Configurator.add_stream("[Modules]\nNextsim::ITest = Nextsim::Impl2\n")
    pkg.ConfiguredModule.parse_configurator()
    return loader.get_implementation("Nextsim::ITest").operation()


def configured_module_unknown_impl_raises(pkg):
    pkg.modules.ModuleRegistry.get_loader().set_all_defaults()
    pkg.Configurator.add_stream("[Modules]\nNextsim::ITest = Nextsim::Punk\n")
    pkg.ConfiguredModule.parse_configurator()


def all_set_keys(pkg):
    pkg.Configurator.set_command_line(["prog", "--a.b=1", "--c.d", "2", "--flag"])
    pkg.Configurator.add_stream("[a]\nb = 9\n[e]\nf = x\n")
    return pkg.Configurator.all_set_keys()


#: case -> what the reference test expects of it (an exception type name
#: for the cases that raise).
CASES = {
    parse_one_stream_raw_configurator: (-1, 42),
    parse_one_stream_pointer_function: (True, 69105, "Zork"),
    parse_two_streams_one_class: (69105, "Zork"),
    parse_streams_two_overlapping_classes: (69105, "Zork II", 69105, 0.467836),
    command_line_beats_streams: 7,
    earlier_stream_beats_later: 1,
    malformed_stream_is_skipped: 13,
    unknown_options_are_ignored: 5,
    parse_ini_sections_comments_and_bare_keys: [
        ("bare", "1"), ("sec.a", "hello world"), ("sec.b", "2"),
    ],
    bool_lexical_casts: {f"b.k{i}": v for i, v in enumerate((True, False) * 4)},
    invalid_bool_raises: "ValueError",
    enum_option: {"grid.geometry": 1},
    unmapped_enum_token_raises: "ValueError",
    command_line_parser_single_file: ["a.cfg"],
    command_line_parser_multiple_files_preserve_order: ["z.cfg", "a.cfg", "m.cfg"],
    command_line_parser_help: True,
    module_default_is_first_registered: 1,
    module_selection_and_fresh_instance: (2, True, 2),
    module_static_instance_is_cached: True,
    unknown_implementation_raises: "ModuleError",
    unknown_interface_raises: "ModuleError",
    configured_module_selects_from_config: 2,
    configured_module_unknown_impl_raises: "ModuleError",
    all_set_keys: {"a.b": "1", "c.d": "2", "e.f": "x"},
}


def outcome(case, pkg, capsys):
    """(value or error type and message, stdout, stderr) of one package."""
    try:
        got = case(pkg)
    except Exception as err:  # the cases that raise are compared by their error
        got = (type(err).__name__, str(err))
    finally:
        pkg.Configurator.clear()
    out = capsys.readouterr()
    return got, out.out, out.err


@pytest.mark.parametrize("case", list(CASES), ids=[c.__name__ for c in CASES])
def test_both_configurators_agree(case, fresh_registries, capsys):
    ref = outcome(case, JAX, capsys)
    got = outcome(case, PORT, capsys)
    assert got[0] == ref[0] and got[2] == ref[2]
    if case is command_line_parser_help:  # the port's usage adds its two switches
        assert set(ref[1].splitlines()) < set(got[1].splitlines())
        assert "--cpu" in got[1] and "--float64" in got[1]
    else:
        assert got[1] == ref[1]
    expected = CASES[case]
    if isinstance(expected, str) and expected.endswith("Error"):
        assert ref[0][0] == expected
    else:
        assert ref[0] == expected


def test_the_two_configurators_are_independent():
    """A stream added to one package's Configurator is not seen by the other's."""
    PORT.Configurator.add_stream("[config]\nvalue = 3\n")
    desc = lambda pkg: pkg.OptionsDescription().add("config.value", int, -1)
    assert PORT.Configurator.parse(desc(PORT))["config.value"] == 3
    assert JAX.Configurator.parse(desc(JAX))["config.value"] == -1
    assert PORT.Configurator is not JAX.Configurator


def test_the_port_switches_are_parsed_and_ignored_by_the_configurator():
    argv = ["nextsim", "--cpu", "--config-file", "a.cfg", "--float64", "--model.stop=3"]
    parser = PORT.CommandLineParser(argv)
    assert parser.cpu_requested and parser.float64_requested
    assert parser.get_config_file_names() == ["a.cfg"]
    assert not PORT.CommandLineParser(["nextsim"]).cpu_requested
    PORT.Configurator.set_command_line(argv)
    desc = PORT.OptionsDescription().add("model.stop", str, "0")
    assert PORT.Configurator.parse(desc) == {"model.stop": "3"}
