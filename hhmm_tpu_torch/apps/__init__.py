"""Financial applications layer (counterpart of ``hhmm_tpu/apps``): the
Tayal (2009) walk-forward trading replication, the Hassan (2005)
walk-forward forecaster and the Jangmin (2004) market-regime fit
(``apps/jangmin.py``)."""
