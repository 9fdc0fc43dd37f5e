"""The port's command-line front ends against the JAX package's.

The three parsers (setup, analysis, comparison) take the same flags, with
the same destinations, defaults and arity; the imaging protocol set up from
file times (the "mtime" mode, and the "exif" mode on npz photographs, which
carry no EXIF) is the JAX package's CSV, byte for byte, with its templates;
the set-up CLI writes it through ``main(argv)``.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from darsia_tpu.presets.workflows import (
    user_interface_analysis as jax_analysis,
    user_interface_comparison as jax_comparison,
    user_interface_setup as jax_setup_cli,
)
from darsia_tpu.presets.workflows.setup import setup_imaging_protocol as jax_protocol
from darsia_tpu_torch.presets.workflows import (
    user_interface_analysis,
    user_interface_comparison,
    user_interface_setup,
)
from darsia_tpu_torch.presets.workflows.setup import (
    preview_protocol_setup_conflicts,
    setup_imaging_protocol,
)

torch.set_num_threads(1)

PARSERS = [
    ("analysis", jax_analysis.build_parser_for_analysis, user_interface_analysis.build_parser_for_analysis),
    ("setup", jax_setup_cli.build_parser_for_setup, user_interface_setup.build_parser_for_setup),
    (
        "comparison",
        jax_comparison.build_parser_for_comparison,
        user_interface_comparison.build_parser_for_comparison,
    ),
]


def _flags(parser) -> list:
    return [
        (tuple(a.option_strings), a.dest, a.default, a.nargs, a.required, type(a).__name__, a.help)
        for a in parser._actions
    ]


@pytest.mark.parametrize("name,jax_build,port_build", PARSERS, ids=[p[0] for p in PARSERS])
def test_parsers_take_the_jax_flags(name, jax_build, port_build):
    assert _flags(port_build()) == _flags(jax_build())
    assert port_build().description == jax_build().description


@pytest.mark.parametrize(
    "argv",
    [
        ["--config", "a.toml", "--mass", "--volume", "--cropping", "--all"],
        ["--config", "a.toml", "b.toml", "--segmentation", "--info"],
    ],
)
def test_analysis_arguments_parse_alike(argv):
    assert vars(user_interface_analysis.build_parser_for_analysis().parse_args(argv)) == vars(
        jax_analysis.build_parser_for_analysis().parse_args(argv)
    )


def _workspace(root: Path, mtimes: list) -> Path:
    """Three npz photographs with fixed modification times and a config whose
    protocols lie under ``root``."""
    images = root / "images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for k, stamp in enumerate(mtimes):
        path = images / f"img_{k:03d}.npz"
        np.savez(path, array=rng.random((4, 5, 3)).astype(np.float32))
        os.utime(path, (stamp, stamp))
    config = root / "config.toml"
    config.write_text(
        f"""
[data]
folder = "{images}"
baseline = "img_000.npz"
results = "{root / 'results'}"

[protocol]
imaging = "{root / 'protocols' / 'imaging.csv'}"
injection = "{root / 'protocols' / 'injection.csv'}"
pressure_temperature = "{root / 'protocols' / 'pt.csv'}"
imaging_mode = "MODE"
"""
    )
    return config


@pytest.mark.parametrize("mode", ["mtime", "exif"])
def test_imaging_protocol_is_the_jax_csv(tmp_path, mode):
    mtimes = [1_700_000_000, 1_700_003_600.5, 1_700_007_200]
    written = {}
    for name, fn in (("jax", jax_protocol), ("port", setup_imaging_protocol)):
        config = _workspace(tmp_path / name, mtimes)
        config.write_text(config.read_text().replace("MODE", mode))
        path = fn(config)
        written[name] = {p.name: p.read_bytes() for p in path.parent.iterdir()}
    assert sorted(written["port"]) == ["imaging.csv", "injection.csv", "pt.csv"]
    assert written["port"] == written["jax"]
    lines = written["port"]["imaging.csv"].decode().splitlines()
    assert lines[0] == "image_id,datetime,path" and len(lines) == 4


def test_protocol_overwrite_rules(tmp_path):
    config = _workspace(tmp_path, [1_700_000_000, 1_700_000_060])
    config.write_text(config.read_text().replace("MODE", "mtime"))
    assert preview_protocol_setup_conflicts(config) == []
    setup_imaging_protocol(config)
    assert len(preview_protocol_setup_conflicts(config)) == 3
    with pytest.raises(FileExistsError):
        setup_imaging_protocol(config)
    setup_imaging_protocol(config, overwrite=True)


def test_setup_cli_writes_the_protocol(tmp_path):
    mtimes = [1_700_000_000, 1_700_000_900]
    written = {}
    for name, module in (("jax", jax_setup_cli), ("port", user_interface_setup)):
        config = _workspace(tmp_path / name, mtimes)
        config.write_text(config.read_text().replace("MODE", "exif"))
        args = ["--config", str(config), "--protocols", "--overwrite"]
        if name == "jax":
            module.run_setup(module.Rig, module.build_parser_for_setup().parse_args(args))
        else:
            module.main(args, device="cpu")
        written[name] = (tmp_path / name / "protocols" / "imaging.csv").read_bytes()
    assert written["port"] == written["jax"]
