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
