"""Test sizes of the mixes added after ``small.py``: every test file here
sizes a cell's mix from ``small.SMALL``, so each entry is added before any
of them runs."""

import small

# the pitch cell's mix (kinds/corpus_pitch.py), its traffic's shape kept
small.SMALL.setdefault("corpus-pitch", {
    "batch": 4, "min_batch": 4, "pool_batches": 2, "seconds_min": 0.5, "seconds_max": 2.0,
    "check_batches": 2, "trace_seconds": 0.5})
