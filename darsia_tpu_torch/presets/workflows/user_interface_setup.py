"""Command-line front end of the set-up workflows.

Counterpart of :mod:`darsia_tpu.presets.workflows.user_interface_setup` (the
same parser and flags).  Run as::

    python -m darsia_tpu_torch.presets.workflows.user_interface_setup \
        --config config.toml --protocols --depth --labeling --rig

The rig is set up on the CUDA card; ``main(argv, device="cpu")`` sets it up
on the CPU.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from .rig import Rig
from .setup import (
    segment_colored_image,
    setup_depth_map,
    setup_facies,
    setup_imaging_protocol,
    setup_rig,
)
from .setup.setup_rig import delete_rig

logger = logging.getLogger(__name__)

__all__ = ["build_parser_for_setup", "run_setup", "preset_setup", "main"]


def build_parser_for_setup() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="FluidFlower setup run.")
    parser.add_argument(
        "--config", type=str, nargs="+", required=True, help="Path(s) to TOML config file(s)."
    )
    parser.add_argument("--all", action="store_true", help="All setup steps.")
    parser.add_argument("--depth", action="store_true", help="Depth map setup.")
    parser.add_argument("--labeling", action="store_true", help="Segment colored sketch.")
    parser.add_argument("--facies", action="store_true", help="Facies setup.")
    parser.add_argument("--protocols", action="store_true", help="Imaging protocol from EXIF.")
    parser.add_argument("--rig", action="store_true", help="Rig setup.")
    parser.add_argument("--delete-rig", action="store_true", help="Delete the saved rig.")
    parser.add_argument("--overwrite", action="store_true", help="Overwrite protocol files.")
    parser.add_argument("--show", action="store_true", help="Show plots.")
    return parser


def run_setup(rig_cls=Rig, args=None, device=None) -> None:
    """Run the selected set-up steps; the device steps on ``device`` (None:
    the CUDA card)."""
    config_paths = [Path(p) for p in args.config]
    path = config_paths if len(config_paths) > 1 else config_paths[0]
    if args.delete_rig:
        delete_rig(path)
        return
    if args.all or args.protocols:
        setup_imaging_protocol(path, overwrite=args.overwrite)
    if args.all or args.depth:
        setup_depth_map(path, show=args.show, device=device)
    if args.all or args.labeling:
        segment_colored_image(path, show=args.show, device=device)
    if args.all or args.facies:
        setup_facies(path=path, show=args.show, device=device)
    if args.all or args.rig:
        setup_rig(rig_cls, path, show=args.show, device=device)


def main(argv=None, device=None) -> None:
    parser = build_parser_for_setup()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_setup(Rig, args, device=device)


def preset_setup(rig_cls, **kwargs):
    """Parse ``sys.argv`` and run the set-up front end for a user-supplied
    Rig subclass."""
    parser = build_parser_for_setup()
    args = parser.parse_args()
    run_setup(rig_cls, args, **kwargs)


if __name__ == "__main__":
    main()
