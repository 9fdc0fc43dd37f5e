"""Command-line front end of the workflow utilities (data transfer,
calibration bundles, media).

Counterpart of :mod:`darsia_tpu.presets.workflows.user_interface_utils`
(the same parser and flags).  Run as::

    python -m darsia_tpu_torch.presets.workflows.user_interface_utils \
        --config config.toml --export-calibration

The utilities copy files and encode on the host: ``main(argv, device=None)``
takes the ``device`` of the other front ends and hands it to nothing.
``--media`` reads the photographs and writes the video with OpenCV,
imported when called.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from .utils import build_media, download_data, export_calibration_bundle, import_calibration_bundle

logger = logging.getLogger(__name__)

__all__ = ["build_parser_for_utils", "preset_utils", "main"]


def build_parser_for_utils() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="FluidFlower utilities run.")
    parser.add_argument(
        "--config", type=str, nargs="+", required=True, help="Path(s) to TOML config file(s)."
    )
    parser.add_argument(
        "--download-data", action="store_true", help="Copy/download the data described by [download]."
    )
    parser.add_argument(
        "--dry-run", action="store_true", help="With --download-data: only print the plan."
    )
    parser.add_argument(
        "--export-calibration",
        action="store_true",
        help="Export calibration artifacts to a portable bundle folder.",
    )
    parser.add_argument(
        "--import-calibration",
        action="store_true",
        help="Import a calibration bundle into this run's results.",
    )
    parser.add_argument(
        "--overwrite", action="store_true", help="Allow the import to overwrite existing calibration."
    )
    parser.add_argument(
        "--media", action="store_true", help="Build the video/GIF outputs described by [video]."
    )
    return parser


def preset_utils(args) -> None:
    config_paths = [Path(p) for p in args.config]
    path = config_paths if len(config_paths) > 1 else config_paths[0]
    if args.download_data:
        print(download_data(path, dry_run=args.dry_run).describe())
    if args.export_calibration:
        print(export_calibration_bundle(path))
    if args.import_calibration:
        print(import_calibration_bundle(path, overwrite=args.overwrite))
    if args.media:
        for fmt, out in build_media(path).items():
            print(fmt, out)


def main(argv=None, device=None) -> None:
    parser = build_parser_for_utils()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    preset_utils(args)


if __name__ == "__main__":
    main()
