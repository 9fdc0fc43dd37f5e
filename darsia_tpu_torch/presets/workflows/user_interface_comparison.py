"""Command-line front end of the cross-run comparison workflows.

Counterpart of :mod:`darsia_tpu.presets.workflows.user_interface_comparison`
(the same parser and flags).  Run as::

    python -m darsia_tpu_torch.presets.workflows.user_interface_comparison \
        --config multi.toml --wasserstein-compute --wasserstein-assemble

The distances are solved on the CUDA card; ``main(argv, device="cpu")``
solves them on the CPU.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from .comparison import comparison_events, comparison_wasserstein
from .rig import Rig

logger = logging.getLogger(__name__)

__all__ = ["build_parser_for_comparison", "run_comparison", "preset_comparison", "main"]


def build_parser_for_comparison() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="FluidFlower comparison run.")
    parser.add_argument("--config", type=str, required=True, help="Multi-run TOML config.")
    parser.add_argument("--events", action="store_true", help="Cross-run event comparison.")
    parser.add_argument(
        "--wasserstein-compute",
        action="store_true",
        help="Compute pairwise Wasserstein distances.",
    )
    parser.add_argument(
        "--wasserstein-assemble",
        action="store_true",
        help="Assemble computed distances into one CSV.",
    )
    parser.add_argument(
        "--skip-existing",
        action="store_true",
        help="Skip already-computed distance files.",
    )
    return parser


def run_comparison(rig_cls=Rig, args=None, device=None) -> None:
    """Run the selected comparison steps; the solves on ``device`` (None:
    the CUDA card)."""
    path = Path(args.config)
    if args.events:
        comparison_events(path)
    if args.wasserstein_compute:
        comparison_wasserstein(
            rig_cls, path, compute=True, skip_existing=args.skip_existing, device=device
        )
    if args.wasserstein_assemble:
        comparison_wasserstein(rig_cls, path, assemble=True)


def main(argv=None, device=None) -> None:
    parser = build_parser_for_comparison()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_comparison(Rig, args, device=device)


def preset_comparison(rig_cls, **kwargs):
    """Parse ``sys.argv`` and run the comparison front end for a
    user-supplied Rig subclass."""
    parser = build_parser_for_comparison()
    args = parser.parse_args()
    run_comparison(rig_cls, args, **kwargs)


if __name__ == "__main__":
    main()
