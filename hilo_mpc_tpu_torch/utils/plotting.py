"""Plotting backend dispatch and backends.

PyTorch port of ``hilo_mpc_tpu/utils/plotting.py`` (the same code: it reads
the host numpy of a ``TimeSeries``). matplotlib is the default rendering
backend; 'latex' writes a pgfplots document (``to_pgfplots``); 'bokeh' is
the interactive-HTML backend of utils/plotting_bokeh.py, whose package
import is gated with a clear error when bokeh is absent. matplotlib and
bokeh are imported inside the functions that draw, so importing the package
needs neither.
"""
from __future__ import annotations

from typing import Optional

_BACKEND = "matplotlib"


def set_plot_backend(backend: Optional[str]):
    global _BACKEND
    if backend is None:
        _BACKEND = None
        return
    backend = backend.lower()
    if backend == "bokeh":
        try:
            import bokeh  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "plot backend 'bokeh' requires the bokeh package, which is not "
                "installed; use 'matplotlib' (rendering) or 'latex' (pgfplots "
                "export)") from e
    if backend not in ("matplotlib", "latex", "bokeh"):
        raise ValueError(f"unknown plot backend {backend!r} "
                         "(matplotlib | latex | bokeh)")
    _BACKEND = backend


def get_plot_backend() -> Optional[str]:
    return _BACKEND


def _collect_panels(series, kinds, names):
    panels = []
    for kind in (kinds or [k for k in series.kinds if series.names(k)]):
        for nm in series.names(kind):
            if names is not None and nm not in names:
                continue
            panels.append((kind, nm))
    if not panels:
        raise ValueError("nothing to plot")
    return panels


def plot_series(series, kinds=None, names=None, show: bool = False, save_as=None,
                title: Optional[str] = None):
    """Plot a TimeSeries: one subplot per variable, step plots for inputs.

    With the 'latex' backend (or a ``save_as`` ending in .tex) this writes a
    standalone pgfplots document instead of rendering.
    """
    if _BACKEND == "latex" or (save_as and str(save_as).endswith(".tex")):
        if not save_as:
            raise ValueError("latex backend needs save_as='<file>.tex'")
        to_pgfplots(series, save_as, kinds=kinds, names=names, title=title)
        return None

    if _BACKEND == "bokeh" or (save_as and str(save_as).endswith(".html")):
        from .plotting_bokeh import plot_series_bokeh

        return plot_series_bokeh(series, kinds=kinds, names=names, show=show,
                                 save_as=save_as, title=title)

    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    t = series["t"]
    panels = _collect_panels(series, kinds, names)
    fig, axes = plt.subplots(len(panels), 1, sharex=True,
                             figsize=(8, 1.8 * len(panels)), squeeze=False)
    for ax, (kind, nm) in zip(axes[:, 0], panels):
        vals = series[nm].ravel()
        n = min(len(t), len(vals))
        if kind == "u":
            ax.step(t[:n], vals[:n], where="post", label=nm)
        else:
            ax.plot(t[:n], vals[:n], label=nm)
        ax.set_ylabel(nm)
        ax.grid(alpha=0.3)
    axes[-1, 0].set_xlabel(f"time [{series.time_unit}]")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if save_as:
        fig.savefig(save_as, dpi=120)
    if show:
        plt.show()
    return fig


def _tex_escape(s: str) -> str:
    for ch in "#$%&_{}":
        s = s.replace(ch, "\\" + ch)
    return s


def to_pgfplots(series, path, kinds=None, names=None, title: Optional[str] = None,
                standalone: bool = True) -> str:
    """Export a TimeSeries as a pgfplots LaTeX document (one axis per variable,
    `const plot` for inputs). Returns the generated LaTeX source.

    The reference reserves a latex plot plugin (plugins/latex/plot.py) but ships
    it empty; this is a working equivalent. ``standalone=False`` emits only the
    tikzpicture for \\input{} into an existing document.
    """
    import numpy as np

    t = np.asarray(series["t"])
    panels = _collect_panels(series, kinds, names)
    blocks = []
    for kind, nm in panels:
        vals = np.asarray(series[nm]).ravel()
        n = min(len(t), len(vals))
        coords = " ".join(
            f"({t[i]:.10g},{vals[i]:.10g})" for i in range(n)
            if np.isfinite(vals[i]))
        opts = "const plot, thick" if kind == "u" else "thick"
        blocks.append(
            "\\begin{axis}[width=\\linewidth, height=4cm,\n"
            f"    ylabel={{{_tex_escape(nm)}}},"
            f" xlabel={{time [{_tex_escape(series.time_unit)}]}},\n"
            "    grid=both, grid style={black!10}]\n"
            f"\\addplot+[{opts}, mark=none] coordinates {{ {coords} }};\n"
            "\\end{axis}"
        )
    pictures = "\n\n".join(
        "\\begin{tikzpicture}\n" + b + "\n\\end{tikzpicture}" for b in blocks)
    if standalone:
        head = ("\\documentclass{standalone}\n\\usepackage{pgfplots}\n"
                "\\pgfplotsset{compat=1.17}\n\\begin{document}\n"
                "\\begin{minipage}{10cm}\n")
        if title:
            head += f"\\textbf{{{_tex_escape(title)}}}\\par\\medskip\n"
        tex = head + pictures + "\n\\end{minipage}\n\\end{document}\n"
    else:
        tex = pictures + "\n"
    with open(path, "w") as f:
        f.write(tex)
    return tex
