"""Drift guard for the command lines: every option of every JAX `mp`
script is taken by the port's script of the same name.

A command line written for the JAX package must parse in the port. For
each of the fifteen scripts (the JAX `mp`'s `get_scripts()`), each
option string of the JAX parser must name an option of the port's
parser that takes a value where the JAX one does (the same `nargs`) and
accepts every choice the JAX one accepts; and the two parsers take the
same positional arguments. A JAX option the port does not take belongs
in ALLOWED with its reason; the list is empty.
"""
import importlib

import pytest

from multiplanarunet_tpu.bin import mp as j_mp
from multiplanarunet_tpu_torch.bin import mp as t_mp
from tests.torch_projects import torch_threads  # noqa: F401

# (script, option string) -> why the port does not take it
ALLOWED = {}

SCRIPTS = j_mp.get_scripts()


def _parser(package, script):
    mod = importlib.import_module(f"{package}.bin.{script}")
    build = getattr(mod, "get_argparser", None) or mod.get_parser
    return build()


def cli_drift(jax_parser, port_parser, script):
    """The JAX options and positionals the port's parser does not take
    as the JAX parser does, as readable strings (empty when none)."""
    faults = []
    port = port_parser._option_string_actions
    for action in jax_parser._actions:
        if not action.option_strings:
            continue
        for opt in action.option_strings:
            if (script, opt) in ALLOWED:
                continue
            theirs = port.get(opt)
            if theirs is None:
                faults.append(f"{opt}: not taken")
                continue
            if theirs.nargs != action.nargs:
                faults.append(f"{opt}: nargs {theirs.nargs!r}, JAX "
                              f"{action.nargs!r}")
            if action.choices is not None and (
                    theirs.choices is None
                    or not set(action.choices) <= set(theirs.choices)):
                faults.append(f"{opt}: choices {theirs.choices!r}, JAX "
                              f"{action.choices!r}")
    positional = [(a.dest, a.nargs) for a in jax_parser._actions
                  if not a.option_strings]
    theirs = [(a.dest, a.nargs) for a in port_parser._actions
              if not a.option_strings]
    if positional != theirs:
        faults.append(f"positionals {theirs}, JAX {positional}")
    return faults


def test_both_packages_have_the_same_fifteen_scripts():
    assert len(SCRIPTS) == 15
    assert t_mp.get_scripts() == SCRIPTS


@pytest.mark.parametrize("script", SCRIPTS)
def test_every_jax_option_is_taken_by_the_port(script):
    faults = cli_drift(_parser("multiplanarunet_tpu", script),
                       _parser("multiplanarunet_tpu_torch", script), script)
    assert not faults, f"mp {script}: " + "; ".join(faults)


def test_allow_list_is_empty_and_the_guard_sees_a_missing_flag():
    """No JAX option is excused; and a port parser missing one JAX flag
    (here `mp predict`'s --no_fuse_views, the last one ported) is
    reported by name."""
    assert ALLOWED == {}
    jax_parser = _parser("multiplanarunet_tpu", "predict")
    port_parser = _parser("multiplanarunet_tpu_torch", "predict")
    del port_parser._option_string_actions["--no_fuse_views"]
    assert cli_drift(jax_parser, port_parser, "predict") == [
        "--no_fuse_views: not taken"]
