"""Command-line front end of the analysis workflows.

Counterpart of :mod:`darsia_tpu.presets.workflows.user_interface_analysis`
(the same parser and flags).  Run as::

    python -m darsia_tpu_torch.presets.workflows.user_interface_analysis \
        --config config.toml --mass --volume --cropping --all

The analysis runs on the CUDA card; ``main(argv, device="cpu")`` runs it on
the CPU.  ``--segmentation`` and ``--thresholding`` only draw figures, with
matplotlib: where it does not import they raise, naming it, before anything
is loaded.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Callable, Optional

from .analysis import (
    analysis_cropping_from_context,
    analysis_fingers_from_context,
    analysis_mass_from_context,
    analysis_segmentation_from_context,
    analysis_thresholding_from_context,
    analysis_volume_from_context,
    prepare_analysis_context,
)
from .analysis.analysis_segmentation import require_matplotlib
from .rig import Rig

logger = logging.getLogger(__name__)

__all__ = ["build_parser_for_analysis", "run_analysis", "preset_analysis", "main"]

_STEP_HELP = {
    "cropping": "Cropping analysis: export corrected images.",
    "segmentation": "Segmentation analysis: contour overlays per config.",
    "fingers": "Finger analysis: contour tips + lengths per ROI.",
    "mass": "Mass analysis: color-to-mass hot loop with CSV/field export.",
    "volume": "Volume analysis: gas volume per ROI over time.",
    "thresholding": "Thresholding analysis: layered overlays with legend.",
}

_DISPATCH = {
    "cropping": analysis_cropping_from_context,
    "mass": analysis_mass_from_context,
    "volume": analysis_volume_from_context,
    "segmentation": analysis_segmentation_from_context,
    "fingers": analysis_fingers_from_context,
    "thresholding": analysis_thresholding_from_context,
}

#: Steps whose only product is a matplotlib figure.
_DRAWING = ("segmentation", "thresholding")


def build_parser_for_analysis() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="FluidFlower analysis run.")
    parser.add_argument(
        "--config",
        type=str,
        nargs="+",
        required=True,
        help="Path(s) to TOML config file(s); multiple files deep-merge.",
    )
    for step, help_text in _STEP_HELP.items():
        parser.add_argument(f"--{step}", action="store_true", help=help_text)
    parser.add_argument("--all", action="store_true", help="Analyze the entire dataset.")
    parser.add_argument("--show", action="store_true", help="Show plots after each step.")
    parser.add_argument(
        "--info", action="store_true", help="Describe activated flags and exit."
    )
    return parser


def print_help_for_flags(args, parser) -> bool:
    if not args.info:
        return False
    for step, help_text in _STEP_HELP.items():
        if getattr(args, step):
            print(help_text)
    print("To run the analysis, remove the '--info' flag.")
    return True


def run_analysis(
    rig_cls=Rig,
    args=None,
    stream_callback: Optional[Callable] = None,
    progress_callback: Optional[Callable] = None,
    device=None,
) -> None:
    """Run the selected steps on one analysis context on ``device`` (None:
    the CUDA card)."""
    config_paths = [Path(p) for p in args.config]
    path = config_paths if len(config_paths) > 1 else config_paths[0]
    steps = [s for s in _STEP_HELP if getattr(args, s)]
    if not steps:
        raise SystemExit("No analysis step selected; pass e.g. --mass.")
    for step in _DRAWING:
        if step in steps:
            require_matplotlib(step)
    needs_mass = bool({"mass", "volume", "segmentation", "fingers", "thresholding"} & set(steps))
    ctx = prepare_analysis_context(
        cls=rig_cls, path=path, all=args.all, require_color_to_mass=needs_mass, device=device
    )
    for step in steps:
        logger.info("Running %s analysis...", step)
        _DISPATCH[step](
            ctx,
            show=args.show,
            stream_callback=stream_callback,
            progress_callback=progress_callback,
        )


def main(argv=None, device=None) -> None:
    parser = build_parser_for_analysis()
    args = parser.parse_args(argv)
    if print_help_for_flags(args, parser):
        return
    logging.basicConfig(level=logging.INFO)
    run_analysis(Rig, args, device=device)


def preset_analysis(rig_cls, **kwargs):
    """Parse ``sys.argv`` and run the analysis front end for a user-supplied
    Rig subclass."""
    parser = build_parser_for_analysis()
    args = parser.parse_args()
    run_analysis(rig_cls, args, **kwargs)


if __name__ == "__main__":
    main()
