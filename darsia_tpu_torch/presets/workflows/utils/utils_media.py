"""Video and GIF outputs from a run's photographs.

Counterpart of :mod:`darsia_tpu.presets.workflows.utils.utils_media`.  The
frames are decoded, resized, captioned and encoded with OpenCV, imported
when :func:`build_media` runs; where OpenCV does not import it raises
``ImportError`` naming it.  An npz photograph is read by the port's
``imread`` on the CPU.  A video writer that does not open (a codec missing
from the OpenCV build) raises ``RuntimeError`` naming the codec, and no
empty file is left behind.
"""

from __future__ import annotations

import importlib
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from ....experiment.experiment import ProtocolledExperiment
from ....utils.optional import optional_module
from ....image.image import as_numpy
from ..config.fluidflower_config import FluidFlowerConfig

logger = logging.getLogger(__name__)

__all__ = ["build_media"]


def _scan_source_images(source) -> list:
    folder = Path(source.folder)
    iterator = folder.rglob("*") if source.recursive else folder.iterdir()
    return sorted(f for f in iterator if f.suffix.lower() in source.extensions and f.is_file())


def _sort_frames(config, files: list) -> list:
    if config.video.source.sorting == "protocol" and config.protocol is not None:
        try:
            experiment = ProtocolledExperiment.init_from_config(config)
            return sorted(files, key=lambda f: experiment.get_datetime(f))
        except Exception as e:
            logger.warning("Protocol sorting failed (%s); name order used.", e)
    return sorted(files)


def _elapsed_hours(config, file) -> Optional[float]:
    if config.protocol is None:
        return None
    try:
        experiment = ProtocolledExperiment.init_from_config(config)
        date = experiment.get_datetime(file)
        return (date - experiment.experiment_start).total_seconds() / 3600.0
    except Exception:
        return None


def _read_frame(cv2, file, resolution, overlay, elapsed) -> np.ndarray:
    frame = cv2.imread(str(file))
    if frame is None:
        from ....image.imread import imread

        arr = as_numpy(imread(file, device="cpu").img)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * 255 if arr.max() <= 1.5 else arr, 0, 255).astype(np.uint8)
        frame = cv2.cvtColor(arr, cv2.COLOR_RGB2BGR)
    if resolution is not None:
        frame = cv2.resize(frame, (resolution[1], resolution[0]))
    if overlay is not None:
        lines = []
        if overlay.show_elapsed_time and elapsed is not None:
            lines.append(overlay.elapsed_time_format.format(elapsed))
        if overlay.show_note and overlay.note:
            lines.append(overlay.note)
        x, y = overlay.position
        for i, line in enumerate(lines):
            cv2.putText(
                frame,
                line,
                (int(x), int(y) + i * (18 + overlay.line_spacing)),
                cv2.FONT_HERSHEY_SIMPLEX,
                overlay.font_scale,
                tuple(int(c) for c in overlay.text_color[::-1]),
                overlay.thickness,
            )
    return frame


def build_media(path) -> dict:
    """Build the configured video outputs (mp4/gif/avi); returns their
    paths by format.  Needs OpenCV."""
    cv2 = optional_module("cv2", "build_media (decoding, captioning and encoding the frames)")
    config = FluidFlowerConfig(path, require_data=False, require_results=False)
    config.check("video")
    video = config.video
    files = _sort_frames(config, _scan_source_images(video.source))
    if not files:
        raise FileNotFoundError(f"No frames found in {video.source.folder}.")
    if video.folder is None:
        raise ValueError(
            "[video].folder is not set and no [data].results folder is "
            "available to derive the default output location."
        )
    out_folder = Path(video.folder)
    out_folder.mkdir(parents=True, exist_ok=True)
    stem = video.output.filename or "video"
    written = {}
    frames = [
        _read_frame(cv2, f, video.output.resolution, video.overlay, _elapsed_hours(config, f))
        for f in files
    ]
    height, width = frames[0].shape[:2]
    for fmt, codec in (("mp4", video.output.codec), ("avi", "MJPG")):
        if fmt not in video.output.formats:
            continue
        out_path = out_folder / f"{stem}.{fmt}"
        writer = cv2.VideoWriter(
            str(out_path), cv2.VideoWriter_fourcc(*codec), video.output.fps, (width, height)
        )
        if not writer.isOpened():
            writer.release()
            out_path.unlink(missing_ok=True)
            raise RuntimeError(
                f"OpenCV {cv2.__version__} cannot open a {fmt} writer with codec {codec!r}; "
                "choose another [video.output] codec or format"
            )
        for frame in frames:
            writer.write(frame)
        writer.release()
        written[fmt] = out_path
        logger.info("Wrote %s (%d frames).", out_path, len(frames))
    if "gif" in video.output.formats:
        out_path = out_folder / f"{stem}.gif"
        try:
            pil_image = importlib.import_module("PIL.Image")
        except ImportError:
            logger.warning("PIL unavailable; GIF output skipped.")
        else:
            pil_frames = [pil_image.fromarray(cv2.cvtColor(f, cv2.COLOR_BGR2RGB)) for f in frames]
            pil_frames[0].save(
                out_path,
                save_all=True,
                append_images=pil_frames[1:],
                duration=int(1000 / video.output.fps),
                loop=0,
            )
            written["gif"] = out_path
            logger.info("Wrote %s.", out_path)
    return written
