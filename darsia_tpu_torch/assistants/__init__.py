"""Assistants: point, box, rectangle, subregion, rotation, crop and label
selection, headless with programmatic inputs and interactive through
matplotlib where it imports."""

from .base_assistant import BaseAssistant, interactive_available
from .crop_assistant import CropAssistant
from .labels_assistant import (
    LabelsAssistant,
    LabelsAssistantMenu,
    LabelsMaskSelectionAssistant,
    LabelsMergeAssistant,
    LabelsPickAssistant,
    LabelsSegmentAssistant,
    MonochromaticAssistant,
)
from .selection_assistants import (
    BoxSelectionAssistant,
    PointSelectionAssistant,
    RectangleSelectionAssistant,
    RotationCorrectionAssistant,
    SubregionAssistant,
)

__all__ = [
    "BaseAssistant",
    "BoxSelectionAssistant",
    "CropAssistant",
    "LabelsAssistant",
    "LabelsAssistantMenu",
    "LabelsMaskSelectionAssistant",
    "LabelsMergeAssistant",
    "LabelsPickAssistant",
    "LabelsSegmentAssistant",
    "MonochromaticAssistant",
    "PointSelectionAssistant",
    "RectangleSelectionAssistant",
    "RotationCorrectionAssistant",
    "SubregionAssistant",
    "interactive_available",
]
