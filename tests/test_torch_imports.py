"""The port imports nothing of jax or of dsp_tpu: the import statements of
every module under dsp_tpu_torch/ and of chip_smoke.py, read with ast (each
``import``, ``from ... import``, and ``__import__`` or
``importlib.import_module`` call whose name is a string or an f-string
with a leading literal), name neither jax (jaxlib) nor dsp_tpu. The port's
own dsp_tpu_torch is fine.
"""

import ast
from pathlib import Path

import pytest

import torch_parity  # noqa: F401  (one torch thread a test process)

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "dsp_tpu_torch").rglob("*.py")
               if "_build" not in p.parts) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dsp_tpu")


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def _call_name(node):
    """The module name a dynamic import call asks for, as far as it is
    literal, or None."""
    f = node.func
    called = f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None
    if called not in ("__import__", "import_module") or not node.args:
        return None
    a = node.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value
    if isinstance(a, ast.JoinedStr) and a.values and isinstance(a.values[0], ast.Constant):
        return a.values[0].value
    return None


def imported_names(source):
    """(line, module name) of every import in source."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append((node.lineno, node.module))
        elif isinstance(node, ast.Call):
            name = _call_name(node)
            if name is not None:
                out.append((node.lineno, name))
    return out


@pytest.mark.parametrize("path", FILES)
def test_no_jax_or_dsp_tpu_import(path):
    names = imported_names((REPO / path).read_text())
    bad = [(line, n) for line, n in names if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_the_reader_sees_every_form():
    src = ("import jax.numpy as jnp\nfrom dsp_tpu.codecs import base\nimport dsp_tpu_torch\n"
           "__import__(f'dsp_tpu.codecs.{x}')\nimportlib.import_module('jaxlib')\n"
           "from . import sibling\n__import__(f'dsp_tpu_torch.codecs.{x}')\n")
    assert [n for _, n in imported_names(src) if _forbidden(n)] == [
        "jax.numpy", "dsp_tpu.codecs", "dsp_tpu.codecs.", "jaxlib"]
