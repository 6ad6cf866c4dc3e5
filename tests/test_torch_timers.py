"""The attention timers kept as tools, on a machine with no card:
``launch/time_attention.py`` (both forward instances side by side) and
``launch/ab_attention.py`` (named variants of the forward's, its short
instance's, the backward's and ``flash_decode``'s CUDA source) import
without a card and exit 2 before building or timing anything; and every
named variant's edit still applies to the committed source, so that the
tool does not rot as the kernels change."""
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.launch import ab_attention

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAUNCH = ROOT / "src" / "repro_torch" / "launch"


@pytest.mark.parametrize("argv", [
    ["time_attention.py"],
    ["ab_attention.py"],
    ["ab_attention.py", "--backward", "d128_key_halves"],
    ["ab_attention.py", "--short", "short_3wg_d128"],
    ["ab_attention.py", "--decode"],
    ["ab_attention.py", "--decode", "tma_p_once"],
])
def test_timer_exits_2_without_a_card(argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(LAUNCH / argv[0]), *argv[1:]],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 2, (out.stdout, out.stderr)
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("backward,name", [
    *[(False, n) for n in ab_attention.VARIANTS],
    *[(True, n) for n in ab_attention.BWD_VARIANTS]])
def test_ab_variant_applies_to_the_committed_source(backward, name):
    source = (ab_attention.BWD_SOURCE if backward
              else ab_attention.SOURCE).read_text()
    edited = ab_attention.variant_source(name, backward)
    assert edited != source


@pytest.mark.parametrize("name", list(ab_attention.SHORT_VARIANTS))
def test_ab_short_variant_applies_to_the_committed_source(name):
    source = ab_attention.SOURCE.read_text()
    assert ab_attention.variant_source(name, short=True) != source


def test_ab_forces_the_instances_as_the_wrapper_names_them():
    """The constants the tool forces an instance with are the wrapper's."""
    from repro_torch.kernels import flash_attention as FA
    assert ab_attention.NEVER_LONG == FA.NEVER_LONG
    assert ab_attention.SHORT_KEYS == FA.SHORT_KEYS
    assert ab_attention.FORCE["wgmma"] == (0, FA.NEVER_SHORT)


@pytest.mark.parametrize("name", list(ab_attention.DECODE_VARIANTS))
def test_ab_decode_variant_applies_to_the_committed_source(name):
    source = ab_attention.DECODE_SOURCE.read_text()
    assert ab_attention.variant_source(name, decode=True) != source


def test_ab_decode_variants_name_an_instance_of_the_launch():
    """A decode variant runs the instance its name starts with, by the
    codes ``flash_decode_launch`` takes (the wrapper's ``_INSTANCES``)."""
    from repro_torch.kernels import flash_decode as FD
    for name in ab_attention.DECODE_VARIANTS:
        kind = name.split("_")[0]
        assert kind in FD._INSTANCES
        assert ab_attention.decode_instance(name) == FD._INSTANCES[kind]
