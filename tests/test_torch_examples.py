"""The port's example drivers (`examples_torch/`): every driver compiles,
and each runs ``--cpu --quick`` at its smallest size (budgets of a few
transitions at tree depth 2, short series), in this process through
``runpy`` with its own argv, printing the lines the JAX drivers print
(`tests/test_examples.py` reads ``hmm_main.py``'s "filtered accuracy"
and "divergence rate"). The simulated data are the default; the readers
of `apps/data_io.py` feed ``hassan_main.py --csv`` and ``tayal_main.py
--ticks-dir``. Without ``--cpu`` a driver runs on the card and raises on
a host without one.

``hassan_replication.py`` runs its frozen benchmarks (a warm-start
pilot of at least 50 draws on 150 days each), about 20 s on the CPU, so
its run is marked ``slow``; its compile check stays.
"""

import os
import py_compile
import runpy
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")
DRIVERS = ("hmm_main.py", "iohmm_main.py", "hassan_main.py", "hassan_replication.py",
           "hhmm_main.py", "jangmin_main.py", "tayal_main.py", "tayal_strategy.py")
TINY = ["--cpu", "--quick", "--warmup", "4", "--samples", "4", "--max-treedepth", "2"]


def _run(driver, args, capsys):
    """Run ``examples_torch/<driver>`` as ``__main__`` with ``args``;
    returns its stdout."""
    argv = sys.argv
    sys.argv = [os.path.join(EXAMPLES, driver), *args]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = argv
    return capsys.readouterr().out


def test_every_driver_compiles():
    scripts = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    assert set(DRIVERS) | {"_common.py", "replication_figures.py"} == set(scripts)
    for f in scripts:
        py_compile.compile(os.path.join(EXAMPLES, f), doraise=True)


@pytest.mark.parametrize("driver,args,expect", [
    ("hmm_main.py", ["--T", "40"], ["divergence rate", "filtered accuracy"]),
    ("hmm_main.py", ["--variant", "multinom", "--T", "40"], ["filtered accuracy"]),
    ("hmm_main.py", ["--variant", "semisup", "--T", "40"], ["filtered accuracy"]),
    ("iohmm_main.py", ["--T", "40"], ["divergence rate", "filtered accuracy"]),
    ("hassan_main.py", ["--T", "24", "--train-frac", "0.9"], ["out-of-sample errors", "mape"]),
    ("hhmm_main.py", ["--T", "40"], ["tree compiled: K=4", "top-state recovery"]),
    ("jangmin_main.py", ["--T", "30"], ["unsupervised regime decode accuracy"]),
    ("tayal_main.py", ["--legs-per-day", "40"], ["out-of-sample trading (lag=1)"]),
    ("tayal_strategy.py", ["--legs-per-day", "40", "--symbols", "1", "--days", "6"],
     ["1 (symbol, window) tasks", "mean"]),
])
def test_driver_runs_on_the_cpu(capsys, driver, args, expect):
    out = _run(driver, TINY + args, capsys)
    for line in expect:
        assert line in out, out[-2000:]


@pytest.mark.slow
def test_hassan_replication_runs_and_writes_only_where_asked(capsys, tmp_path):
    out = _run("hassan_replication.py", TINY + ["--steps", "2"], capsys)
    assert "SYN-A" in out and "SYN-B" in out and "wrote" not in out
    path = tmp_path / "rep.json"
    out = _run("hassan_replication.py", TINY + ["--steps", "2", "--out", str(path)], capsys)
    assert path.exists() and "wrote" in out


def test_hassan_main_reads_an_ohlc_csv(capsys, tmp_path):
    """``--csv``: the port's ``load_ohlc_csv`` feeds the forecaster."""
    rng = np.random.default_rng(0)
    close = 20 * np.exp(np.cumsum(rng.normal(0, 0.01, 24)))
    rows = ["Date,Open,High,Low,Close"] + [
        f"2005-01-{i + 1:02d},{c * 0.99:.4f},{c * 1.01:.4f},{c * 0.98:.4f},{c:.4f}"
        for i, c in enumerate(close)]
    csv = tmp_path / "ohlc.csv"
    csv.write_text("\n".join(rows) + "\n")
    out = _run("hassan_main.py", TINY + ["--csv", str(csv), "--train-frac", "0.9"], capsys)
    assert "24 days, training on first 21" in out and "out-of-sample errors" in out


def test_tayal_main_reads_tick_days(capsys, tmp_path):
    """``--ticks-dir``: per-day CSVs through the port's
    ``load_tick_days``, ordered by the date in their names."""
    from hhmm_tpu_torch.apps.tayal import simulate_ticks

    rng = np.random.default_rng(1)
    for d in range(3):
        price, size, tsec, _ = simulate_ticks(rng, n_legs=40)
        lines = ["time,price,size"] + [f"{t:.3f},{p:.4f},{s:.0f}" for t, p, s in zip(tsec, price, size)]
        (tmp_path / f"SYM.2007.05.0{d + 1}.csv").write_text("\n".join(lines) + "\n")
    out = _run("tayal_main.py", TINY + ["--ticks-dir", str(tmp_path), "--train-days", "2"], capsys)
    assert out.startswith("3 days") and "out-of-sample trading" in out


def test_drivers_default_to_the_card(monkeypatch, capsys):
    """Without ``--cpu`` a driver runs on CUDA, and on a host without a
    card it raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run("hmm_main.py", ["--quick", "--T", "40"], capsys)
