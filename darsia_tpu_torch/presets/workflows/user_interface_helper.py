"""Command-line front end of the helper workflows.

Counterpart of :mod:`darsia_tpu.presets.workflows.user_interface_helper`
(the same parser and flags).  Run as::

    python -m darsia_tpu_torch.presets.workflows.user_interface_helper \
        --config config.toml --results --color

The helpers run on the CUDA card; ``main(argv, device="cpu")`` runs them on
the CPU.  ``--roi-viewer`` needs matplotlib and OpenCV.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from .helper import helper_color, helper_results, helper_roi_viewer
from .rig import Rig

logger = logging.getLogger(__name__)

__all__ = ["build_parser_for_helper", "run_helper", "preset_helper", "main"]


def build_parser_for_helper() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="FluidFlower helper run.")
    parser.add_argument(
        "--config", type=str, nargs="+", required=True, help="Path(s) to TOML config file(s)."
    )
    parser.add_argument(
        "--results", action="store_true", help="Re-export saved analysis fields per [helper.results]."
    )
    parser.add_argument(
        "--roi-viewer", action="store_true", help="Render all registered ROIs over the baseline."
    )
    parser.add_argument(
        "--color", action="store_true", help="Color statistics + histograms of the corrected baseline."
    )
    parser.add_argument("--show", action="store_true", help="Show plots.")
    return parser


def run_helper(rig_cls=Rig, args=None, device=None) -> None:
    """Run the selected helpers on ``device`` (None: the CUDA card)."""
    config_paths = [Path(p) for p in args.config]
    path = config_paths if len(config_paths) > 1 else config_paths[0]
    if args.results:
        helper_results(path, cls=rig_cls, show=args.show, device=device)
    if args.roi_viewer:
        helper_roi_viewer(path, cls=rig_cls, device=device)
    if args.color:
        helper_color(path, cls=rig_cls, device=device)


def main(argv=None, device=None) -> None:
    parser = build_parser_for_helper()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_helper(Rig, args, device=device)


def preset_helper(rig_cls, **kwargs):
    """Parse ``sys.argv`` and run the helper front end for a user-supplied
    Rig subclass."""
    parser = build_parser_for_helper()
    args = parser.parse_args()
    run_helper(rig_cls, args, **kwargs)


if __name__ == "__main__":
    main()
