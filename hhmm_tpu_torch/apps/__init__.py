"""Financial applications layer (counterpart of ``hhmm_tpu/apps``): the
Tayal (2009) walk-forward trading replication and the Hassan (2005)
walk-forward forecaster."""
