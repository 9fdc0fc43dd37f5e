"""The port's TOML config layer against the JAX package, field by field.

The template ``config.toml`` (each package's own copy, with its data and
results folders pointed into a temporary directory) and the fixture of
``tests/unit/test_workflow_config.py`` are parsed by both packages; every
section object is compared attribute by attribute (recursively, classes by
name, enums by value), with the same warnings and the same errors,
including a multi-file merge, a ``MultiFluidFlowerConfig`` of two runs, and
the mode strings.  Both packages' templates are the same file but for the
comment lines.
"""

import enum
import warnings
from pathlib import Path

import numpy as np
import pytest

import darsia_tpu.presets.workflows.config as jc
import darsia_tpu.presets.workflows.mode_resolution as jm
import darsia_tpu_torch.presets.workflows.config as tc
import darsia_tpu_torch.presets.workflows.mode_resolution as tm

REPO = Path(__file__).resolve().parent.parent
TEMPLATES = {
    "jax": REPO / "darsia_tpu" / "presets" / "workflows" / "templates",
    "port": REPO / "darsia_tpu_torch" / "presets" / "workflows" / "templates",
}

BASE_TOML = """
[data]
folder = "{folder}"
baseline = "baseline.jpg"
results = "{results}"

[rig]
width = 2.8
height = 1.5
dim = 2

[roi.boxA]
corner_1 = [0.0, 0.0]
corner_2 = [1.0, 1.0]

[roi.boxB]
corner_1 = [1.0, 0.5]
corner_2 = [2.0, 1.5]
label = 3

[color.path.co2]
mode = "relative"
num_segments = 2

[format.jpg.thumb]
name = "stem_hh-mm"
resolution = [100, 200]

[analysis]
formats = ["thumb"]

[analysis.mass]
color = "co2"
roi = ["boxA"]
export = ["mass"]
"""


def _same(a, b, where: str = "config") -> None:
    """``b`` (the port's) equals ``a`` (the JAX package's) field by field."""
    if a is None or b is None:
        assert a is None and b is None, where
    elif isinstance(a, enum.Enum):
        assert isinstance(b, enum.Enum) and a.value == b.value, where
    elif isinstance(a, (str, int, float, bool, Path)):
        assert type(a) is type(b) and a == b, (where, a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for key in a:
            _same(a[key], b[key], f"{where}[{key!r}]")
    elif callable(a) and not hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, where
    else:
        assert type(a).__name__ == type(b).__name__, (where, type(a), type(b))
        fields_a = {k: v for k, v in vars(a).items() if not k.startswith("_")}
        fields_b = {k: v for k, v in vars(b).items() if not k.startswith("_")}
        assert list(fields_a) == list(fields_b), where
        for key in fields_a:
            _same(fields_a[key], fields_b[key], f"{where}.{key}")


def _parse(module, path, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        config = module.FluidFlowerConfig(path, **kwargs)
    return config, [str(w.message) for w in caught]


def _template_copy(tmp_path: Path, name: str) -> Path:
    text = (TEMPLATES[name] / "config.toml").read_text()
    text = text.replace('folder = "..."', f'folder = "{tmp_path / "images"}"')
    text = text.replace('results = "..."', f'results = "{tmp_path / "results"}"')
    text = text.replace('source = "..."', f'source = "{tmp_path / "video"}"')
    path = tmp_path / f"{name}.toml"
    path.write_text(text)
    return path


def test_templates_are_the_same_but_for_comments():
    def body(name):
        lines = (TEMPLATES[name] / "config.toml").read_text().splitlines()
        return [line for line in lines if not line.lstrip().startswith("#")]

    assert body("port") == body("jax")
    for csv in sorted(TEMPLATES["jax"].glob("*.csv")):
        assert (TEMPLATES["port"] / csv.name).read_text() == csv.read_text()


def test_template_config_against_jax(tmp_path):
    j, j_warn = _parse(jc, _template_copy(tmp_path, "jax"))
    t, t_warn = _parse(tc, _template_copy(tmp_path, "port"))
    assert [w.replace("port.toml", "jax.toml") for w in t_warn] == j_warn
    for section in vars(j):
        if section != "path":
            _same(getattr(j, section), getattr(t, section), section)
    assert t.color["co2"].num_segments == 2 and t.analysis.mass.export == ["mass", "rescaled_mass"]


@pytest.fixture
def config_file(tmp_path):
    folder = tmp_path / "images"
    folder.mkdir()
    (folder / "baseline.jpg").write_bytes(b"")
    toml = tmp_path / "config.toml"
    toml.write_text(BASE_TOML.format(folder=folder, results=tmp_path / "results"))
    return toml


def test_unit_fixture_against_jax(config_file):
    j, j_warn = _parse(jc, config_file)
    t, t_warn = _parse(tc, config_file)
    assert t_warn == j_warn and any("depth" in w for w in t_warn)
    for section in vars(j):
        _same(getattr(j, section), getattr(t, section), section)
    assert t.format_registry["thumb"].render_name("img_007", 26.75) == "img_007_02-45"
    for pkg_config in (j, t):
        with pytest.raises(ValueError, match="depth") as err:
            pkg_config.check("depth", "rig")
    assert "missing required sections: ['depth']" in str(err.value)
    t.check("data", "rig", "analysis")
    with pytest.raises(TypeError):
        t.roi_registry.resolve_rois(["boxB"])


def test_errors_against_jax(tmp_path, config_file):
    bad = tmp_path / "bad.toml"
    bad.write_text(config_file.read_text().replace('color = "co2"', 'color = "nope"'))
    messages = []
    for module in (jc, tc):
        with pytest.raises(ValueError, match="nope") as err:
            _parse(module, bad)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    absent = tmp_path / "absent.toml"
    absent.write_text(config_file.read_text().replace("images", "absent"))
    messages = []
    for module in (jc, tc):
        with pytest.raises(FileNotFoundError, match="absent") as err:
            module.FluidFlowerConfig(absent, require_data=True)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    missing = tmp_path / "nodata.toml"
    missing.write_text("[data]\nbaseline = 'x.jpg'\nresults = 'r'\n")
    j, j_warn = _parse(jc, missing)
    t, t_warn = _parse(tc, missing)
    assert t.data is None and j.data is None and t_warn == j_warn


def test_multi_file_merge_against_jax(tmp_path, config_file):
    override = tmp_path / "override.toml"
    override.write_text("[rig]\nwidth = 9.9\nheight = 1.5\ndim = 2\n")
    j, j_warn = _parse(jc, [config_file, override])
    t, t_warn = _parse(tc, [config_file, override])
    assert t.rig.width == 9.9 and t_warn == j_warn
    _same(j.rig, t.rig, "rig")
    _same(j.analysis, t.analysis, "analysis")


def test_multi_fluidflower_config_against_jax(tmp_path, config_file):
    (tmp_path / "results").mkdir()
    multi = tmp_path / "multi.toml"
    multi.write_text(
        f"""
[data]
results = "{tmp_path / 'results'}"

[run.a]
config = "{config_file.name}"

[run.b]
config = "{config_file.name}"

[wasserstein]
runs = ["a", "b"]
times = [1.0, 2.0]
relative_tol = 0.2

[events.early]
mode = "mass"
roi_name = "boxA"
relative_threshold = 0.1
"""
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jc.MultiFluidFlowerConfig(multi, require_results=True)
        t = tc.MultiFluidFlowerConfig(multi, require_results=True)
    for section in vars(j):
        if section != "path":
            _same(getattr(j, section), getattr(t, section), section)
    assert list(t.runs.config) == ["a", "b"] and t.wasserstein.runs == ["a", "b"]
    assert t.events.events["early"].relative_threshold == 0.1


@pytest.mark.parametrize(
    "mode", ["mass", "rescaled_mass", "saturation_g", "concentration_aq", "co2.red", "bogus", "co2."]
)
def test_mode_strings_against_jax(mode):
    def outcome(module):
        try:
            module.validate_mode_syntax(mode)
        except ValueError as err:
            return ("error", str(err))
        return ("ok", module.mode_requires_color_to_mass(mode), repr(module.parse_color_mode(mode)))

    assert outcome(tm) == outcome(jm)
