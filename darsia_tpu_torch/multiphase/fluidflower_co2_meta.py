"""Legacy meta-data loader for FluidFlower CO2 runs.

Counterpart of :mod:`darsia_tpu.multiphase.fluidflower_co2_meta` (a TOML or
JSON meta file describing the data, input and common folders; superseded by
``FluidFlowerConfig`` but kept for compatibility).  Plain Python, copied.
"""

from __future__ import annotations

import tomllib
from pathlib import Path

__all__ = ["FluidFlowerCO2Meta"]


class FluidFlowerCO2Meta:
    """Meta data for FluidFlower CO2 analysis (legacy TOML format)."""

    def __init__(self, meta: Path) -> None:
        meta_data = self.load_meta(meta)

        data_folder = Path(meta_data["data"]["folder"])
        image_format = meta_data["data"].get("format", "JPG")
        self.data = list(sorted(data_folder.glob(f"*.{image_format}")))
        assert self.data, "No images found in the data folder."

        baseline = meta_data["data"].get("baseline")
        self.baseline = data_folder / baseline if baseline else None

        if "pad" not in meta_data["data"]:
            raise ValueError("Pad for image names must be specified.")
        self.pad = int(meta_data["data"]["pad"])

        input_section = meta_data.get("input", {})
        self.input_folder = (
            Path(input_section["folder"]) if "folder" in input_section else None
        )
        self.segmentation = (
            self.input_folder / input_section["segmentation"]
            if self.input_folder and "segmentation" in input_section
            else None
        )

        common = meta_data.get("common", {})
        self.common_folder = Path(common["folder"]) if "folder" in common else None
        self.labels = (
            self.common_folder / common["labels"]
            if self.common_folder and "labels" in common
            else None
        )
        self.depth_measurements = (
            self.common_folder / "depth" / "depth_measurements.csv"
            if self.common_folder
            else None
        )
        self.results = (
            Path(meta_data["results"]["folder"])
            if "results" in meta_data
            else None
        )
        self.results_folder = self.results
        results_section = meta_data.get("results", {})
        self.fluidflower_folder = (
            self.results / results_section["fluidflower"]
            if self.results is not None and "fluidflower" in results_section
            else None
        )

    # -- derived result/calibration paths --

    @property
    def log_folder(self) -> Path:
        """Path to the log folder."""
        return Path.cwd() / "log"

    @property
    def co2_analysis_data(self) -> Path:
        """Path to the CO2 analysis calibration data."""
        return self.fluidflower_folder / "co2_analysis.csv"

    @property
    def co2_g_analysis_data(self) -> Path:
        """Path to the CO2 gas analysis calibration data."""
        return self.fluidflower_folder / "co2_g_analysis.csv"

    @property
    def pw_transformation_g_data(self) -> Path:
        """Pressure-weighted transformation data for the gas phase."""
        return self.fluidflower_folder / "pw_transformation_g.csv"

    @property
    def pw_transformation_aq_data(self) -> Path:
        """Pressure-weighted transformation data for the aqueous phase."""
        return self.fluidflower_folder / "pw_transformation_aq.csv"

    def update(self, key: str, path: Path) -> None:
        """Redirect a managed folder path."""
        if key == "fluidflower":
            self.fluidflower_folder = Path(path)
        elif key == "labels":
            self.labels = Path(path)
        else:
            raise ValueError(f"Key {key} not recognized.")

    @staticmethod
    def load_meta(meta: Path) -> dict:
        meta = Path(meta)
        if meta.suffix == ".json":
            import json

            return json.loads(meta.read_text())
        return tomllib.loads(meta.read_text())
