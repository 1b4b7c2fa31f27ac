"""Scoring layer (``models/acquire.py`` ``choose_next``, ``models/batched.py``
``choose_next_batch``): mean host milliseconds of a traced step's
``choose_next`` call, closed after a synchronize."""


def read(tv):
    return tv.span_mean_ms("choose") if tv else None
