"""Tayal (2009) application (counterpart of ``hhmm_tpu/apps/tayal``):
zig-zag feature extraction, top-state mapping/labeling, trading rules,
analytics, and the batched walk-forward harness on the card.

Not ported yet: ``online_flip_detector`` (it needs the serving plane's
``RegimeDetector``, ``ROADMAP.md`` A10) and ``run_window`` (NUTS, A5).
"""

from hhmm_tpu_torch.apps.tayal.features import (
    ZigZag,
    extract_features,
    to_model_inputs,
    expand_to_ticks,
    expand_to_ticks_xts,
)
from hhmm_tpu_torch.apps.tayal.trading import Trades, topstate_trading, buyandhold, equity_curve
from hhmm_tpu_torch.apps.tayal.analytics import (
    TopRuns,
    map_to_topstate,
    topstate_probs,
    topstate_runs,
    relabel_by_return,
    topstate_summary,
)
from hhmm_tpu_torch.apps.tayal.pipeline import (
    LabeledWindow,
    TayalWindowResult,
    classify_hard,
    decode_states,
    label_and_trade,
)
from hhmm_tpu_torch.apps.tayal.simulate import simulate_ticks
from hhmm_tpu_torch.apps.tayal.wf import WFTask, WFResult, build_tasks, wf_trade

__all__ = [
    "ZigZag",
    "extract_features",
    "to_model_inputs",
    "expand_to_ticks",
    "expand_to_ticks_xts",
    "Trades",
    "topstate_trading",
    "buyandhold",
    "equity_curve",
    "TopRuns",
    "map_to_topstate",
    "topstate_probs",
    "topstate_runs",
    "relabel_by_return",
    "topstate_summary",
    "LabeledWindow",
    "TayalWindowResult",
    "classify_hard",
    "decode_states",
    "label_and_trade",
    "simulate_ticks",
    "WFTask",
    "WFResult",
    "build_tasks",
    "wf_trade",
]
