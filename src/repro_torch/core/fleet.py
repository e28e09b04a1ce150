"""Fleet sizing constants (paper §4, Eq. 4), trimmed to what the serving
engine reads."""
from __future__ import annotations

# Effective prefill MFU (chunked prefill piggybacks on memory-bound decode
# iterations, so the achievable fraction of peak is high).  Calibrated
# jointly with the long-pool HOL inflation against Table 3; every prefill
# charge of an engine is drawn at it unless the engine is given another.
PREFILL_MFU = 0.8
