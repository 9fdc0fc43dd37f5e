"""Image export following named format presets.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.image_export_formats`.
A field is resampled on its device (``ops/resize.py``), copied to the host
once, and written as the JAX package writes it: ``npz`` through
``Image.save`` (compressed), ``npy`` with ``np.save``, ``csv`` with
``np.savetxt``.  ``jpg`` and ``png`` need OpenCV (RGB with a quality or
compression) or matplotlib (colour-mapped maps), imported when called; where
the library does not import (matplotlib on the card's machine) they raise
``ImportError`` naming it.
Without ``[analysis] formats`` the default is npz and jpg, as in the JAX
package, so a run on the card sets ``formats``.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ....image.image import as_numpy
from ....utils.optional import optional_module
from ..config.format_registry import FormatRegistry, ImageExportFormat

__all__ = ["ImageExportFormats"]


def _seconds_from_image(image) -> int:
    time = getattr(image, "time", None)
    if time is None:
        return 0
    return int(round(float(time)))


class ImageExportFormats:
    """Apply a set of format presets when exporting scalar images."""

    def __init__(self, formats: list) -> None:
        self.formats = formats

    @classmethod
    def from_analysis_config(
        cls, analysis_config, format_registry: Optional[FormatRegistry]
    ) -> "ImageExportFormats":
        # Without explicit [analysis].formats, export raw npz + jpg preview.
        keys = getattr(analysis_config, "formats", None) or ["npz", "jpg"]
        formats = []
        for key in keys:
            if format_registry is not None and key in format_registry:
                formats.append(format_registry[key])
            else:
                formats.append(ImageExportFormat(type=key.lower(), identifier=key.lower()))
        return cls(formats)

    def _resample(self, arr: torch.Tensor, spec: ImageExportFormat) -> torch.Tensor:
        if spec.resolution is None:
            return arr
        from ....ops.resize import resize_array

        rows, cols = spec.resolution
        if spec.keep_ratio:
            scale = min(rows / arr.shape[0], cols / arr.shape[1])
            rows = max(int(arr.shape[0] * scale), 1)
            cols = max(int(arr.shape[1] * scale), 1)
        return resize_array(arr, (rows, cols))

    def export_image(
        self,
        image,
        folder: Path,
        stem: str,
        *,
        supported_types=None,
        subfolder=None,
        jpg_quality: int = 50,
        png_compression: int = 6,
        scalar_write_kwargs=None,
    ) -> list:
        """Export restricted to ``supported_types``, nested under
        ``subfolder``, with the default jpg quality / png compression filled
        into specs that do not pin their own."""
        formats = self.formats
        if supported_types is not None:
            formats = [s for s in formats if s.type in supported_types]

        def _with_defaults(spec):
            if spec.type == "jpg" and spec.quality is None:
                return dataclasses.replace(spec, quality=int(jpg_quality))
            if spec.type == "png" and spec.compression is None:
                return dataclasses.replace(spec, compression=int(png_compression))
            return spec

        formats = [_with_defaults(s) for s in formats]
        target = Path(folder)
        kwargs = scalar_write_kwargs or {}
        if subfolder is None:
            return ImageExportFormats(formats).export(image, target, stem, **kwargs)
        # <folder>/<format>/<subfolder>: export() writes <folder>/<format>,
        # so each artefact is moved per spec.
        written = []
        for spec in formats:
            for path in ImageExportFormats([spec]).export(image, target, stem, **kwargs):
                dest = path.parent / Path(subfolder) / path.name
                dest.parent.mkdir(parents=True, exist_ok=True)
                path.rename(dest)
                written.append(dest)
        return written

    def export(self, image, folder: Path, stem: str, **write_kwargs) -> list:
        """Write the image in every configured format; returns the paths."""
        written = []
        raw = image.img if hasattr(image, "img") else image
        # A field stays on its device for the resample; a bare array on the host.
        data = raw if isinstance(raw, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(raw))
        seconds = _seconds_from_image(image)
        for spec in self.formats:
            out_dir = Path(folder) / spec.folder_name
            out_dir.mkdir(parents=True, exist_ok=True)
            name = spec.render_name(stem, time_hours=seconds / 3600.0)
            arr = as_numpy(self._resample(data, spec))
            if spec.dtype is not None:
                arr = arr.astype(np.dtype(spec.dtype))
            if spec.type in ("jpg", "png"):
                path = out_dir / f"{name}.{spec.type}"
                self._write_raster(arr, path, spec)
            elif spec.type == "npy":
                path = out_dir / f"{name}.npy"
                np.save(path, arr)
            elif spec.type == "npz":
                path = out_dir / f"{name}.npz"
                if hasattr(image, "save"):
                    resized = copy.copy(image)
                    resized.img = torch.from_numpy(arr)
                    resized.save(path)
                else:
                    np.savez(path, data=arr)
            elif spec.type == "csv":
                path = out_dir / f"{name}.csv"
                np.savetxt(
                    path,
                    np.atleast_2d(arr.reshape(arr.shape[0], -1)),
                    delimiter=spec.delimiter,
                    header=spec.header or "",
                    fmt=spec.float_format.replace("{:", "%").replace("}", "")
                    if "{" in spec.float_format
                    else spec.float_format,
                )
            else:
                continue
            written.append(path)
        return written

    @staticmethod
    def _write_raster(arr: np.ndarray, path: Path, spec: ImageExportFormat):
        # RGB data with an explicit quality/compression goes through cv2
        # (matplotlib's imsave has no such knobs); colour-mapped scalar maps
        # stay on matplotlib.
        if arr.ndim == 3 and (spec.quality is not None or spec.compression is not None):
            cv2 = optional_module("cv2", f"writing {spec.type} files")

            data = np.clip(np.asarray(arr, dtype=float), 0, 1)
            bgr = cv2.cvtColor((data * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
            params = []
            if spec.type == "jpg" and spec.quality is not None:
                params = [cv2.IMWRITE_JPEG_QUALITY, int(spec.quality)]
            elif spec.type == "png" and spec.compression is not None:
                params = [cv2.IMWRITE_PNG_COMPRESSION, int(spec.compression)]
            cv2.imwrite(str(path), bgr, params)
            return

        matplotlib = optional_module("matplotlib", f"writing {spec.type} files")
        matplotlib.use("Agg")
        plt = importlib.import_module("matplotlib.pyplot")

        if arr.ndim == 2:
            plt.imsave(path, arr, cmap=spec.cmap or "viridis", dpi=spec.dpi or 100)
        else:
            plt.imsave(path, np.clip(arr, 0, 1), dpi=spec.dpi or 100)
