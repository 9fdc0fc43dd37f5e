"""CO2 mass analysis: pressure- and temperature-dependent density and
solubility.

Counterpart of :mod:`darsia_tpu.multiphase.mass_analysis` (the same
equations of state).  The hydrostatic pressure, density and solubility maps
are built in float64 numpy on the host, as there, when the state is set;
each is cast to float32 and copied to a device once (kept until the maps
change), so a mass evaluation copies nothing from the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..image.image import Image, as_numpy
from ..utils.optional import optional_module

EPSILON = 1e-12

__all__ = [
    "EPSILON",
    "AdvancedCO2MassAnalysis",
    "CO2MassAnalysis",
    "MassAnalysisResults",
    "SimpleMassAnalysisResults",
    "ThresholdAnalysisResults",
    "co2_gas_density",
    "co2_solubility",
    "full_like",
    "water_density",
]

_M_CO2 = 0.04401  # kg/mol
_R = 8.314462  # J/(mol K)
_B_CO2 = -128.7e-6  # m^3/mol: second virial coefficient near 20-23 C


def co2_gas_density(pressure_bar, temperature_celsius):
    """Gaseous CO2 density [kg/m^3] by the truncated virial EOS
    ``rho = p M / (Z R T)``, ``Z = 1 + B p / (R T)``."""
    p = np.asarray(pressure_bar, dtype=float) * 1e5
    T = np.asarray(temperature_celsius, dtype=float) + 273.15
    Z = 1.0 + _B_CO2 * p / (_R * T)
    return p * _M_CO2 / (Z * _R * T)


def co2_solubility(pressure_bar, temperature_celsius):
    """CO2 solubility in water [kg/m^3] (Henry's law, linear in T):
    1.70 kg/m^3/bar at 20 C, 1.45 at 23 C."""
    p = np.asarray(pressure_bar, dtype=float)
    T = np.asarray(temperature_celsius, dtype=float)
    return p * (1.70 - (0.25 / 3.0) * (T - 20.0))


def water_density(temperature_celsius):
    """Water density [kg/m^3], linear between 20 C (998.21) and 23 C (997.54)."""
    T = np.asarray(temperature_celsius, dtype=float)
    return 998.21 + (997.54 - 998.21) * (T - 20.0) / 3.0


def full_like(img: Image, data) -> Image:
    """Image with the metadata of ``img`` and the given data, on the image's
    device (a tensor is not copied)."""
    out = img.copy()
    out.img = data
    return out


@dataclass
class MassAnalysisResults:
    """Container of mass-analysis result maps."""

    name: Optional[str] = None
    date: object = None
    time: object = None
    mass: Optional[Image] = None
    mass_g: Optional[Image] = None
    mass_aq: Optional[Image] = None
    saturation_g: Optional[Image] = None
    concentration_aq: Optional[Image] = None
    color_signal: Optional[Image] = None

    def subregion(self, roi) -> "MassAnalysisResults":
        def sub(img):
            return None if img is None else img.subregion(roi)

        return type(self)(
            name=self.name,
            date=self.date,
            time=self.time,
            mass=sub(self.mass),
            mass_g=sub(self.mass_g),
            mass_aq=sub(self.mass_aq),
            saturation_g=sub(self.saturation_g),
            concentration_aq=sub(self.concentration_aq),
            color_signal=sub(self.color_signal),
        )

    # The flash's outputs are the normalized [0, 1] signals themselves.

    @property
    def concentration_co2_aq(self) -> Optional[Image]:
        return self.concentration_aq

    @property
    def normalized_signal_aq(self) -> Optional[Image]:
        return self.concentration_aq

    @property
    def normalized_signal_g(self) -> Optional[Image]:
        return self.saturation_g

    @property
    def saturation_aq(self) -> Optional[Image]:
        if self.saturation_g is None:
            return None
        return full_like(self.saturation_g, 1.0 - self.saturation_g.img)


SimpleMassAnalysisResults = MassAnalysisResults


@dataclass
class ThresholdAnalysisResults:
    """Container of thresholded phase maps."""

    name: Optional[str] = None
    date: object = None
    time: object = None
    mask_g: Optional[Image] = None
    mask_aq: Optional[Image] = None

    def subregion(self, roi) -> "ThresholdAnalysisResults":
        def sub(img):
            return None if img is None else img.subregion(roi)

        return type(self)(
            name=self.name,
            date=self.date,
            time=self.time,
            mask_g=sub(self.mask_g),
            mask_aq=sub(self.mask_aq),
        )


class CO2MassAnalysis:
    """Mass maps of CO2 from phase maps under hydrostatic conditions."""

    def __init__(
        self,
        baseline: Image,
        atmospheric_pressure: float = 1.010,
        atmospheric_temperature: float = 23.0,
        atmospheric_pressure_gradient: float = 0.0,
        atmospheric_temperature_gradient: float = 0.0,
    ) -> None:
        self.baseline = baseline
        self.atmospheric_pressure = atmospheric_pressure
        self.atmospheric_temperature = atmospheric_temperature
        self.atmospheric_pressure_gradient = atmospheric_pressure_gradient
        self.atmospheric_temperature_gradient = atmospheric_temperature_gradient
        self._on_device: dict = {}
        self.setup_density_gaseous_co2()

    def update_state(
        self,
        atmospheric_pressure=None,
        atmospheric_temperature=None,
        atmospheric_pressure_gradient=None,
        atmospheric_temperature_gradient=None,
    ) -> None:
        """Update the thermodynamic state and rebuild the maps."""
        if atmospheric_pressure is not None:
            self.atmospheric_pressure = atmospheric_pressure
        if atmospheric_temperature is not None:
            self.atmospheric_temperature = atmospheric_temperature
        if atmospheric_pressure_gradient is not None:
            self.atmospheric_pressure_gradient = atmospheric_pressure_gradient
        if atmospheric_temperature_gradient is not None:
            self.atmospheric_temperature_gradient = atmospheric_temperature_gradient
        self.setup_density_gaseous_co2()

    @property
    def height_map(self) -> np.ndarray:
        """Depth below the domain top [m] per voxel row."""
        return np.linspace(0, self.baseline.dimensions[0], self.baseline.num_voxels[0])[
            :, None
        ] * np.ones((1, self.baseline.num_voxels[1]))

    def atmospheric_temperature_map(self) -> np.ndarray:
        return self.atmospheric_temperature + self.atmospheric_temperature_gradient * self.height_map

    def top_atmospheric_pressure(self) -> float:
        return self.atmospheric_pressure + (
            self.atmospheric_pressure_gradient * self.baseline.dimensions[0]
        )

    def setup_density_gaseous_co2(self) -> None:
        """Build the hydrostatic pressure, density and solubility maps
        (float64, host)."""
        g = 9.81
        pa2bar = 1e-5
        temperature_map = self.atmospheric_temperature_map()
        rho_w = water_density(temperature_map)
        hydrostatic_pressure = (
            self.top_atmospheric_pressure() + rho_w * g * self.height_map * pa2bar
        )
        self.hydrostatic_pressure = hydrostatic_pressure
        self.density_gaseous_co2 = co2_gas_density(hydrostatic_pressure, temperature_map)
        self.solubility_co2 = co2_solubility(hydrostatic_pressure, temperature_map)
        self._on_device = {}

    def maps_on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(density, solubility) as float32 tensors on ``device``, copied
        there once per device (again after the maps are rebuilt or
        replaced)."""
        device = torch.device(device)
        key = (self.density_gaseous_co2, self.solubility_co2)
        held = self._on_device.get(device)
        if held is None or held[0][0] is not key[0] or held[0][1] is not key[1]:
            maps = tuple(
                torch.from_numpy(np.asarray(m, dtype=np.float32)).to(device)
                for m in (self.density_gaseous_co2, self.solubility_co2)
            )
            held = self._on_device[device] = (key, maps)
        return held[1]

    def setup_20_degrees_celsius(self) -> None:
        """Isothermal 20 C lookup rows from the equations of state."""
        pressures = np.array([0.90 + 0.01 * i for i in range(61)])
        self.water_density_20 = float(water_density(20.0))
        self.data_NIST_20 = (
            pressures.tolist(),
            [float(co2_gas_density(p, 20.0)) for p in pressures],
        )

    def setup_23_degrees_celsius(self) -> None:
        """Isothermal 23 C lookup rows from the equations of state."""
        pressures = np.array([0.90 + 0.01 * i for i in range(61)])
        self.water_density_23 = float(water_density(23.0))
        self.data_NIST_23 = (
            pressures.tolist(),
            [float(co2_gas_density(p, 23.0)) for p in pressures],
        )

    def log(self, path: Path) -> None:
        """The density and solubility maps as PNGs in the folder ``path``."""
        plt = optional_module("matplotlib.pyplot", "CO2MassAnalysis.log")

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        for name, data in [
            ("density_gaseous_co2", self.density_gaseous_co2),
            ("solubility_co2", self.solubility_co2),
        ]:
            plt.figure(name)
            plt.imshow(as_numpy(data))
            plt.colorbar()
            plt.savefig(path / f"{name}.png")
            plt.close()

    def __call__(self, chi_g: Image, chi_aq: Image) -> Tuple[Image, Image, Image]:
        """Mass maps (total, gaseous, aqueous) [kg/m^3 bulk]."""
        density, solubility = self.maps_on(chi_g.img.device)
        mass_g_arr = chi_g.img.to(torch.float32) * density
        mass_aq_arr = chi_aq.img.to(torch.float32) * solubility
        return (
            full_like(chi_g, mass_g_arr + mass_aq_arr),
            full_like(chi_g, mass_g_arr),
            full_like(chi_aq, mass_aq_arr),
        )

    def mass_analysis(self, c_aq: Image, s_g: Image) -> MassAnalysisResults:
        """Mass decomposition from saturation and aqueous concentration."""
        density, solubility = self.maps_on(c_aq.img.device)
        sg = s_g.img.to(torch.float32)
        caq = c_aq.img.to(torch.float32)
        mass_g_arr = density * sg
        mass_aq_arr = solubility * caq * (1 - sg).clamp(min=0.0)
        return MassAnalysisResults(
            name=c_aq.name,
            date=c_aq.date,
            time=c_aq.time,
            mass=full_like(c_aq, mass_g_arr + mass_aq_arr),
            mass_g=full_like(c_aq, mass_g_arr),
            mass_aq=full_like(c_aq, mass_aq_arr),
            saturation_g=s_g,
            concentration_aq=c_aq,
        )

    def inverse_mass_analysis(self, mass: Image) -> MassAnalysisResults:
        """Phase maps from a total-mass map (inverse of ``mass_analysis``)."""
        density, solubility = self.maps_on(mass.img.device)
        m = mass.img.to(torch.float32)
        c_aq_arr = torch.where(solubility.abs() > EPSILON, m / solubility, 0.0).clamp(0.0, 1.0)
        numerator = (m - solubility).clamp(min=0.0)
        denominator = density - solubility
        s_g_arr = torch.where(
            denominator.abs() > EPSILON, numerator / denominator, 0.0
        ).clamp(0.0, 1.0)
        mass_g_arr = density * s_g_arr
        mass_aq_arr = solubility * c_aq_arr * (1 - s_g_arr).clamp(min=0.0)
        return MassAnalysisResults(
            name=mass.name,
            date=mass.date,
            time=mass.time,
            mass=full_like(mass, mass_g_arr + mass_aq_arr),
            mass_g=full_like(mass, mass_g_arr),
            mass_aq=full_like(mass, mass_aq_arr),
            saturation_g=full_like(mass, s_g_arr),
            concentration_aq=full_like(mass, c_aq_arr),
        )


class AdvancedCO2MassAnalysis:
    """End-to-end mass analysis chaining concentration analyses and a flash."""

    def __init__(
        self,
        concentration_analysis_g,
        concentration_analysis_aq,
        restoration,
        flash,
        mass_analysis: CO2MassAnalysis,
    ) -> None:
        self.concentration_analysis_g = concentration_analysis_g
        self.concentration_analysis_aq = concentration_analysis_aq
        self.restoration = restoration
        self.flash = flash
        self.mass_analysis_obj = mass_analysis

    def __call__(self, img: Image) -> Tuple[Image, Image, Image]:
        c_g = self.concentration_analysis_g(img)
        c_aq = self.concentration_analysis_aq(img)
        if self.restoration is not None:
            c_g = self.restoration(c_g)
            c_aq = self.restoration(c_aq)
        chi_g, chi_aq, _, _ = self.flash(c_g, c_aq)
        return self.mass_analysis_obj(chi_g, chi_aq)

    def mass(self, img: Image) -> Image:
        return self.__call__(img)[0]

    def ndofs(self) -> int:
        return getattr(self.concentration_analysis_g.model, "num_parameters", 0) + getattr(
            self.concentration_analysis_aq.model, "num_parameters", 0
        )

    def update_parameters(self, params: np.ndarray) -> None:
        n_g = getattr(self.concentration_analysis_g.model, "num_parameters", 0)
        self.concentration_analysis_g.model.update_model_parameters(params[:n_g])
        self.concentration_analysis_aq.model.update_model_parameters(params[n_g:])
