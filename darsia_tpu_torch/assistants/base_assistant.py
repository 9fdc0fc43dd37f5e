"""Base assistant: a matplotlib event loop, and a headless programmatic mode.

Counterpart of :mod:`darsia_tpu.assistants.base_assistant`.  Every concrete
assistant also takes its selection as an argument (``points=...`` etc.), so
workflows run headless and nothing is drawn.  The interactive path (clicks,
``d`` to undo, ``escape`` to reset, ``enter`` to finish, ``q`` to quit, a
background overlay) imports matplotlib when it runs, through
:func:`darsia_tpu_torch.utils.optional.optional_module`: where matplotlib
does not import (the card's machine), it raises ``ImportError`` naming it.
The figure shows a host copy of the image, made once.

The event loop runs without a display: build the assistant with
``strict=False``, call it (the figure is built, ``plt.show`` is skipped),
then send synthetic ``MouseEvent``/``KeyEvent`` objects through
``fig.canvas.callbacks.process``.
"""

from __future__ import annotations

import os
from abc import ABC
from typing import Any

import numpy as np

from ..image.image import as_numpy
from ..utils.optional import optional_module

__all__ = ["BaseAssistant", "interactive_available"]


def _pyplot():
    return optional_module("matplotlib.pyplot", "the interactive assistants")


def interactive_available() -> bool:
    """True when an interactive matplotlib backend can open a window."""
    matplotlib = optional_module("matplotlib", "the interactive assistants")
    backend = matplotlib.get_backend().lower()
    if "agg" in backend or "pdf" in backend or "svg" in backend:
        return False
    return bool(os.environ.get("DISPLAY", "")) or "nbagg" in backend


def _host(image) -> np.ndarray:
    return as_numpy(image.img if hasattr(image, "img") else image)


class BaseAssistant(ABC):
    """Matplotlib-event-driven assistant skeleton."""

    def __init__(self, img, **kwargs) -> None:
        self.img = img
        self.fig = kwargs.get("fig")
        self.ax = kwargs.get("ax")
        self.background = kwargs.get("background")
        self.block = kwargs.get("block", True)
        #: With strict=True (the default) a blocking call without a display
        #: raises instead of returning an empty selection; tests pass
        #: strict=False to drive the figure with synthetic events.
        self.strict = kwargs.get("strict", True)
        self.verbosity = kwargs.get("verbosity", False)
        self.kwargs = kwargs

    @property
    def name(self) -> str:
        return type(self).__name__

    def _print_instructions(self) -> None:
        pass

    def _print_event(self, event) -> None:
        if self.verbosity:
            print(f"{self.name} - event: {event}")

    def _setup_event_handler(self) -> None:
        assert self.fig is not None
        self.fig.canvas.mpl_connect("key_press_event", self._on_key_press)

    def _reset(self) -> None:
        """Clear the selection (``escape``); subclasses extend."""

    def _finalize(self) -> None:
        """Accept the selection (``enter``): closes the figure."""
        _pyplot().close(self.fig)

    def _on_key_press(self, event) -> None:
        """``escape`` resets, ``enter`` finalizes, ``q`` quits."""
        self._print_event(event)
        if event.key == "escape":
            self._reset()
            if self.fig is not None:
                self.fig.canvas.draw_idle()
        elif event.key == "enter":
            self._finalize()
        elif event.key == "q":
            _pyplot().close(self.fig)

    def __call__(self) -> Any:
        """Open the interactive figure and block until it is closed.

        Without a display: with ``strict=True`` and ``block=True`` this
        raises (a blocking selection could never finish); otherwise the
        figure is built for synthetic events.
        """
        interactive = interactive_available()
        if not interactive and self.strict and self.block:
            raise RuntimeError(
                f"{self.name} requires an interactive matplotlib backend; "
                "pass programmatic inputs instead when headless."
            )
        self._print_instructions()
        self._plot_2d()
        if interactive:  # pragma: no cover - needs a display
            _pyplot().show(block=self.block)

    def _plot_2d(self) -> None:
        plt = _pyplot()
        if self.fig is None or self.ax is None:
            self.fig, self.ax = plt.subplots()
            self.fig.suptitle(self.name)

        def show(data: np.ndarray, alpha=1.0) -> None:
            self.ax.imshow(np.clip(data, 0, 1) if data.ndim == 3 else data, alpha=alpha)

        # A boolean background dims the image outside it; a dense one is
        # blended under it.
        if self.background is None:
            show(_host(self.img))
        else:
            bg = _host(self.background)
            if bg.dtype == bool:
                show(_host(self.img), alpha=np.clip(bg.astype(float), 0.5, 1.0))
            else:
                show(bg, alpha=0.6)
                show(_host(self.img), alpha=0.4)
        self._setup_event_handler()
