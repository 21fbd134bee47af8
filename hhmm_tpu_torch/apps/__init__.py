"""Financial applications layer (counterpart of ``hhmm_tpu/apps``): the
Tayal (2009) walk-forward trading replication."""
