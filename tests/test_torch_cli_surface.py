"""The port's CLI has the JAX CLI's command tree and options, plus the
root ``--device``.

``SURFACE`` and ``OPTIONS`` are the JAX package's pins
(``tests/test_cli_surface.py``); every command and option there must be
in the port's help, and each command's help must list the JAX command's
options exactly (the JAX help's option names, parsed from both)."""

import re

import pytest
from click.testing import CliRunner

from tests.test_cli_surface import OPTIONS, SURFACE
from xspect2_tpu.main import cli as jax_cli
from xspect2_tpu_torch.main import cli

PATHS = sorted(set(SURFACE) | set(OPTIONS) | {(*path, sub) for path, subs in SURFACE.items() for sub in subs})


def _help(command, path):
    result = CliRunner().invoke(command, [*path, "--help"])
    assert result.exit_code == 0, result.output
    return result.output


def _option_names(text):
    options = text.split("Options:", 1)[1].split("Commands:", 1)[0]
    return sorted(set(re.findall(r"(?<![\w-])(--?[A-Za-z][\w-]*)", options)))


@pytest.mark.parametrize("path,subcommands", sorted(SURFACE.items()))
def test_command_tree(path, subcommands):
    output = _help(cli, path)
    for sub in subcommands:
        assert f"\n  {sub}" in output, f"missing subcommand {sub}"


@pytest.mark.parametrize("path,options", sorted(OPTIONS.items()))
def test_option_surface(path, options):
    output = _help(cli, path)
    for opt in options:
        assert opt in output, f"{' '.join(path)}: missing option {opt}"


@pytest.mark.parametrize("path", PATHS, ids=lambda p: " ".join(p) or "root")
def test_options_equal_the_jax_cli(path):
    """Each command's options are the JAX command's; the root adds
    ``--device`` and nothing else."""
    want = _option_names(_help(jax_cli, path))
    got = _option_names(_help(cli, path))
    assert got == sorted(want + (["--device"] if path == () else []))


def test_root_device_option_defaults_to_cuda():
    output = _help(cli, ())
    assert "--device" in output and "[default: cuda]" in output
    device = next(p for p in cli.params if p.name == "device")
    assert device.default == "cuda"


def _flag_calls(tree):
    """Every call in ``tree`` with ``is_flag=True`` among its keywords
    (``click.option(...)`` and the option tables' ``dict(...)``)."""
    import ast

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            if isinstance(kw.get("is_flag"), ast.Constant) and kw["is_flag"].value is True:
                yield node, kw


def test_flags_on_by_default_set_true_on_every_click_version():
    """A flag declared ``default=True`` without ``flag_value`` sets False
    when given under click < 8.2 (its flag value was ``not default``): under
    click 8.1.8 ``train directory --meta`` trained no genus model.  Each
    such flag names ``flag_value=True``."""
    import ast
    from pathlib import Path

    import xspect2_tpu_torch.main as port_main

    tree = ast.parse(Path(port_main.__file__).read_text(encoding="utf-8"))
    on_by_default = [kw for _, kw in _flag_calls(tree)
                     if isinstance(kw.get("default"), ast.Constant) and kw["default"].value is True]
    assert on_by_default, "the CLI has no flag that is on by default"
    for kw in on_by_default:
        assert isinstance(kw.get("flag_value"), ast.Constant) and kw["flag_value"].value is True


@pytest.mark.parametrize("flags", [["--meta"], []], ids=["meta", "default"])
def test_train_directory_meta_flag_trains_the_genus_model(tmp_path, monkeypatch, flags):
    import xspect2_tpu_torch.train as port_train

    seen = {}
    monkeypatch.setattr(port_train, "train_from_directory", lambda *a, **kw: seen.update(kw))
    result = CliRunner().invoke(
        cli, ["--device", "cpu", "models", "train", "directory", "-g", "G", "-i", str(tmp_path), *flags])
    assert result.exit_code == 0, result.output
    assert seen["meta"] is True
