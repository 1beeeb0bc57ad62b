"""The port imports neither jax nor anything of the JAX package: checked
in a fresh interpreter (sys.modules after importing every module of the
port) and by reading its sources."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "meep_nl_tpu_torch")


def _port_modules():
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return mods


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'meep_nl_tpu' "
            "or m.startswith('meep_nl_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_IMPORT = re.compile(
    r"^\s*(import\s+(jax|meep_nl_tpu)\b(?!_torch)"
    r"|from\s+(jax|meep_nl_tpu)\b(?!_torch)[\w.]*\s+import)", re.M)


@pytest.mark.parametrize("path", sorted(
    [os.path.join(r, f) for r, _d, fs in os.walk(PKG) for f in fs
     if f.endswith((".py", ".cu"))]
    + [os.path.join(REPO, "chip_smoke.py")]),
    ids=lambda p: os.path.relpath(p, REPO))
def test_sources_do_not_import_jax(path):
    with open(path) as fh:
        src = fh.read()
    assert not _IMPORT.search(src), _IMPORT.search(src).group(0)
