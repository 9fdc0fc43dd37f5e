"""The device-parity sweep's table (``tests/torch_device_cases.py``) is whole.

Every public class and function of ``darsia_tpu_torch`` is exercised by a
case or listed in ``EXEMPT``, never both; an exemption holds its category
((a) an abstract base or mixin whose named concrete subclass a case
exercises, (b) an enum, a dataclass or a type alias of a class from outside
the port, (c) needs tkinter and a display) and there are at most 60; a host
case names the JAX file that shows its counterpart is host code too; a case
that needs an optional library names one of those the card's machine may
lack.  A new public name without a case fails here.
"""

import dataclasses
import enum
import inspect
import re

import pytest
import torch
from torch_device_cases import CASES, EXEMPT, LAYERS, REPO, public_names

import darsia_tpu_torch as dt

torch.set_num_threads(1)

OPTIONAL = ("cv2", "matplotlib", "plotly", "pydicom", "meshio", "openpyxl")


def exercised() -> dict:
    out = {}
    for c in CASES.values():
        for name in c.names:
            out.setdefault(name, []).append(c.name)
    return out


def test_every_public_name_has_a_case_or_an_exemption():
    names = public_names()
    assert len(names) >= 356
    cases = exercised()
    missing = [n for n in names if n not in cases and n not in EXEMPT]
    assert not missing, f"public names without a case or an exemption: {missing}"
    both = [n for n in EXEMPT if n in cases]
    assert not both, f"exempt and exercised: {both}"
    unknown = [n for n in list(cases) + list(EXEMPT) if n not in names]
    assert not unknown, f"not public names of the port: {unknown}"


def test_at_most_60_exemptions():
    assert len(EXEMPT) <= 60


@pytest.mark.parametrize("name", sorted(EXEMPT))
def test_exemption_holds_its_category(name):
    category, reason = EXEMPT[name]
    value = getattr(dt, name)
    assert reason
    if category == "a":
        assert inspect.isclass(value)
        assert inspect.isabstract(value) or name.endswith("Mixin") or name.startswith(("Base", "Abstract"))
        cases = exercised()
        subclasses = [
            n for n in cases
            if n != name and inspect.isclass(getattr(dt, n)) and issubclass(getattr(dt, n), value)
        ]
        assert subclasses, f"{name}: no concrete subclass in a case"
    elif category == "b":
        assert (
            (inspect.isclass(value) and issubclass(value, enum.Enum))
            or dataclasses.is_dataclass(value)
            or not callable(value)
            or not getattr(value, "__module__", "").startswith("darsia_tpu_torch")
        ), f"{name} is no enum, dataclass or type alias"
    else:
        assert category == "c", category


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if c.where == "host"))
def test_host_case_cites_its_jax_counterpart(name):
    files = re.findall(r"(darsia_tpu/[\w/]+\.py)", CASES[name].cite)
    assert files and all((REPO / f).exists() for f in files), CASES[name].cite
    assert re.search(r"\.py:\d", CASES[name].cite), f"{name}: no JAX line cited"


def test_cases_name_their_layers_and_libraries():
    assert {c.layer for c in CASES.values()} == set(LAYERS)
    assert all(c.needs in ("",) + OPTIONAL for c in CASES.values())
    assert all(c.k1 == 0 or c.warp for c in CASES.values())
