"""Operation and byte counts, one file per kernel or model, and the
card's published peaks (``peaks.py``)."""
