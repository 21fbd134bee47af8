"""Tayal (2009) application (counterpart of ``hhmm_tpu/apps/tayal``):
zig-zag feature extraction, top-state mapping/labeling, trading rules,
analytics (with the served ``online_flip_detector``), the batched
walk-forward harness on the card, and the emission-replication
protocol's diagnostics.
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
    online_flip_detector,
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
    run_window,
)
from hhmm_tpu_torch.apps.tayal.replication import (
    chain_marginal_ll,
    degenerate_mode_probe,
    ml_weighted_pool,
    per_draw_relabel_stats,
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
    "online_flip_detector",
    "topstate_probs",
    "topstate_runs",
    "relabel_by_return",
    "topstate_summary",
    "LabeledWindow",
    "TayalWindowResult",
    "classify_hard",
    "decode_states",
    "label_and_trade",
    "run_window",
    "chain_marginal_ll",
    "degenerate_mode_probe",
    "ml_weighted_pool",
    "per_draw_relabel_stats",
    "simulate_ticks",
    "WFTask",
    "WFResult",
    "build_tasks",
    "wf_trade",
]
