"""The port's workflow documentation (``darsia_tpu_torch/presets/workflows/doc/``).

It holds the JAX package's guides, one file for each, adapted to the port:
every ``darsia_tpu_torch.`` dotted name a guide gives imports (a module, or
a name of the longest module prefix that imports; a name ending in ``*``
matches at least one module), no guide names a module of the JAX package
or of JAX, and none speaks of a TPU or XLA.
"""

import importlib
import pkgutil
import re
from pathlib import Path

import pytest

import darsia_tpu
import darsia_tpu_torch

PORT_DOC = Path(darsia_tpu_torch.__file__).parent / "presets" / "workflows" / "doc"
JAX_DOC = Path(darsia_tpu.__file__).parent / "presets" / "workflows" / "doc"
DOTTED = re.compile(r"darsia_tpu_torch(?:\.[A-Za-z_][A-Za-z0-9_]*)+\*?")


def _guides() -> list:
    return sorted(p.name for p in PORT_DOC.glob("*.md"))


def resolves(dotted: str) -> bool:
    """Whether ``dotted`` names a module of the port or a name in one."""
    if dotted.endswith("*"):
        prefix = dotted[:-1]
        package, _, stem = prefix.rpartition(".")
        module = importlib.import_module(package)
        return any(info.name.startswith(stem) for info in pkgutil.iter_modules(module.__path__))
    parts = dotted.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            value = importlib.import_module(".".join(parts[:cut]))
        except ImportError:
            continue
        for name in parts[cut:]:
            if not hasattr(value, name):
                return False
            value = getattr(value, name)
        return True
    return False


def test_the_port_has_every_guide_of_the_jax_package():
    assert _guides() == sorted(p.name for p in JAX_DOC.glob("*.md"))
    assert len(_guides()) == 20


@pytest.mark.parametrize("guide", _guides())
def test_every_dotted_name_of_a_guide_imports(guide):
    text = (PORT_DOC / guide).read_text()
    names = sorted(set(DOTTED.findall(text)))
    missing = [name for name in names if not resolves(name)]
    assert not missing, missing


@pytest.mark.parametrize("guide", _guides())
def test_no_guide_names_the_jax_package_or_a_tpu(guide):
    text = (PORT_DOC / guide).read_text()
    assert not re.search(r"\bdarsia_tpu\.", text)
    assert not re.search(r"\b(TPU|XLA|v5e|v4|v6e)\b|\bjax[._]", text, re.IGNORECASE)


def test_the_resolver_refuses_unknown_names():
    assert resolves("darsia_tpu_torch.presets.workflows.rig.Rig")
    assert resolves("darsia_tpu_torch.presets.workflows.user_interface_*")
    assert not resolves("darsia_tpu_torch.presets.workflows.rig.NoSuchRig")
    assert not resolves("darsia_tpu_torch.no_such_module")
    assert not resolves("darsia_tpu_torch.presets.workflows.no_such_*")
