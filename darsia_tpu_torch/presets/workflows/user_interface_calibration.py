"""Command-line front end of the calibration workflows.

Counterpart of :mod:`darsia_tpu.presets.workflows.user_interface_calibration`
(the same parser and flags).  Run as::

    python -m darsia_tpu_torch.presets.workflows.user_interface_calibration \
        --config config.toml --color --mass

The calibration runs on the CUDA card; ``main(argv, device="cpu")`` runs it
on the CPU.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from .calibration import (
    calibration_color_paths,
    calibration_color_to_mass_analysis,
    delete_calibration,
)
from .rig import Rig

logger = logging.getLogger(__name__)

__all__ = ["build_parser_for_calibration", "run_calibration", "preset_calibration", "main"]


def build_parser_for_calibration() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="FluidFlower calibration run.")
    parser.add_argument(
        "--config", type=str, nargs="+", required=True, help="Path(s) to TOML config file(s)."
    )
    parser.add_argument("--color", action="store_true", help="Calibrate color paths.")
    parser.add_argument("--mass", action="store_true", help="Calibrate color-to-mass chain.")
    parser.add_argument("--delete", action="store_true", help="Delete calibration artifacts.")
    parser.add_argument("--dry-run", action="store_true", help="With --delete: only list.")
    parser.add_argument("--show", action="store_true", help="Show plots.")
    return parser


def run_calibration(rig_cls=Rig, args=None, device=None) -> None:
    """Run the selected steps on ``device`` (None: the CUDA card)."""
    config_paths = [Path(p) for p in args.config]
    path = config_paths if len(config_paths) > 1 else config_paths[0]
    if args.delete:
        for file in delete_calibration(path, dry_run=args.dry_run):
            print(file)
        return
    if args.color:
        calibration_color_paths(path, cls=rig_cls, show=args.show, device=device)
    if args.mass:
        calibration_color_to_mass_analysis(path, cls=rig_cls, device=device)


def main(argv=None, device=None) -> None:
    parser = build_parser_for_calibration()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_calibration(Rig, args, device=device)


def preset_calibration(rig_cls, **kwargs):
    """Parse ``sys.argv`` and run the calibration front end for a
    user-supplied Rig subclass."""
    parser = build_parser_for_calibration()
    args = parser.parse_args()
    run_calibration(rig_cls, args, **kwargs)


if __name__ == "__main__":
    main()
