"""The port's plot library (counterpart of ``hhmm_tpu.viz``).
Matplotlib equivalents of the reference's ``common/R/plots.R`` (9
functions) and ``tayal2009/R/state-plots.R`` (6 plot functions;
``topstate_summary`` lives in :mod:`hhmm_tpu_torch.apps.tayal.analytics`).

Every function takes NumPy arrays or tensors on any device (a tensor is
brought to the host with ``.detach().cpu().numpy()``), draws on a freshly
created (or caller-supplied) figure and returns the
:class:`matplotlib.figure.Figure`.

This package needs matplotlib: on a host without it, importing it raises
``ModuleNotFoundError`` naming matplotlib. ``import hhmm_tpu_torch``
never imports it.
"""

from hhmm_tpu_torch.viz.plots import (
    plot_intervals,
    plot_seqintervals,
    plot_inputoutput,
    plot_inputprob,
    plot_stateprobability,
    plot_statepath,
    plot_outputfit,
    plot_inputoutputprob,
    plot_seqforecast,
)
from hhmm_tpu_torch.viz.state_plots import (
    plot_features,
    plot_topstate_hist,
    plot_topstate_seq,
    plot_topstate_seqv,
    plot_topstate_features,
    plot_topstate_trading,
)

__all__ = [
    "plot_intervals",
    "plot_seqintervals",
    "plot_inputoutput",
    "plot_inputprob",
    "plot_stateprobability",
    "plot_statepath",
    "plot_outputfit",
    "plot_inputoutputprob",
    "plot_seqforecast",
    "plot_features",
    "plot_topstate_hist",
    "plot_topstate_seq",
    "plot_topstate_seqv",
    "plot_topstate_features",
    "plot_topstate_trading",
]
