"""[video] section (parity: reference
``presets/workflows/config/video.py:37-196``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .toml_utils import convert_none, get_section

__all__ = [
    "VideoSourceConfig",
    "VideoOutputConfig",
    "VideoOverlayConfig",
    "VideoConfig",
]


@dataclass
class VideoSourceConfig:
    folder: Optional[Path] = None
    pattern: Optional[str] = None
    extensions: list = field(
        default_factory=lambda: [".jpg", ".jpeg", ".png"]
    )
    recursive: bool = False
    sorting: str = "protocol"

    def load(self, sec: dict) -> "VideoSourceConfig":
        src = sec["source"]
        if isinstance(src, str):
            self.folder = Path(src)
        elif isinstance(src, dict):
            self.folder = Path(src["folder"]) if "folder" in src else None
            self.pattern = src.get("pattern")
            if "extensions" in src:
                self.extensions = [str(e).lower() for e in src["extensions"]]
            self.recursive = bool(src.get("recursive", False))
            self.sorting = str(src.get("sorting", "protocol"))
        else:
            raise ValueError("[video].source must be a path or a table.")
        return self


@dataclass
class VideoOutputConfig:
    formats: list = field(default_factory=lambda: ["mp4"])
    fps: float = 6.0
    resolution: Optional[tuple] = None
    filename: Optional[str] = None
    codec: str = "mp4v"
    quality: int = 95

    def load(self, sec: dict) -> "VideoOutputConfig":
        self.formats = [str(f).lower() for f in sec.get("formats", ["mp4"])]
        invalid = sorted(set(self.formats) - {"mp4", "gif", "avi"})
        if invalid:
            raise ValueError(f"Unsupported video formats: {invalid}.")
        self.fps = float(sec.get("fps", 6.0))
        resolution = convert_none(sec.get("resolution"))
        if resolution is not None:
            self.resolution = (int(resolution[0]), int(resolution[1]))
        self.filename = convert_none(sec.get("filename"))
        self.codec = str(sec.get("codec", "mp4v"))
        self.quality = int(sec.get("quality", 95))
        return self


@dataclass
class VideoOverlayConfig:
    show_elapsed_time: bool = True
    elapsed_time_format: str = "Elapsed: {:.2f} h"
    show_note: bool = True
    note: str = ""
    font_scale: float = 0.7
    text_color: tuple = (255, 255, 255)
    thickness: int = 2
    line_spacing: int = 8
    position: tuple = (20, 20)
    box_enabled: bool = True
    box_color: tuple = (0, 0, 0)
    box_alpha: float = 0.4

    def load(self, sec: dict) -> "VideoOverlayConfig":
        for key in (
            "show_elapsed_time",
            "elapsed_time_format",
            "show_note",
            "note",
            "font_scale",
            "thickness",
            "line_spacing",
            "box_enabled",
            "box_alpha",
        ):
            if key in sec:
                setattr(self, key, sec[key])
        for key in ("text_color", "position", "box_color"):
            if key in sec:
                setattr(self, key, tuple(sec[key]))
        return self


@dataclass
class VideoConfig:
    source: Optional[VideoSourceConfig] = None
    output: VideoOutputConfig = field(default_factory=VideoOutputConfig)
    overlay: VideoOverlayConfig = field(default_factory=VideoOverlayConfig)
    folder: Optional[Path] = None

    def load(self, path, results=None) -> "VideoConfig":
        sec = get_section(path, "video")
        self.source = VideoSourceConfig().load(sec)
        self.output = VideoOutputConfig().load(sec.get("output", {}))
        self.overlay = VideoOverlayConfig().load(sec.get("overlay", {}))
        folder = sec.get("folder")
        self.folder = (
            Path(folder)
            if folder
            else (Path(results) / "video" if results else None)
        )
        return self

    def error(self):
        """Section-hint raiser (reference config parity)."""
        raise ValueError(
            "Use [video] in the config file to load video utility config."
        )


