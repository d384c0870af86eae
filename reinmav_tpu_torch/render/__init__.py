"""Renderers of the PyTorch port: offline plots and frames
(:mod:`.plot`), a self-contained HTML animation (:mod:`.html_view`) and a
live browser view served while a loop steps (:mod:`.live_view`).  The
counterparts of :mod:`reinmav_tpu.render`: NumPy and the standard library,
matplotlib and PIL imported when a plot or a GIF is made; a tensor becomes
NumPy where it enters."""

from .html_view import save_html
from .live_view import LiveViewer
from .plot import plot_trajectory, render_frame, save_gif

__all__ = ["plot_trajectory", "render_frame", "save_gif", "save_html",
           "LiveViewer"]
