"""Financial applications layer (counterpart of ``hhmm_tpu/apps``): the
Tayal (2009) walk-forward trading replication, the Hassan (2005)
walk-forward forecaster, the Jangmin (2004) market-regime fit
(``apps/jangmin.py``), and the data readers (``apps/data_io.py``: OHLC
and tick CSVs; ``apps/rdata.py``: the reference's xts ``.RData`` tick
days), NumPy and the standard library only, copied from the JAX
package."""
