"""Named feature codes (`tayal2009/R/constants.R:1-19`; a copy of
``hhmm_tpu/apps/tayal/constants.py``)."""

DIRECTION_UP = 1
DIRECTION_LT = 0
DIRECTION_DN = -1

EXTREMA_MIN = -1
EXTREMA_MAX = 1

TREND_UP = 1
TREND_LT = 0
TREND_DN = -1

VOLUME_UP = 1
VOLUME_LT = 0
VOLUME_DN = -1

STATE_BULL = 1
STATE_LOCAL = 0
STATE_BEAR = -1
