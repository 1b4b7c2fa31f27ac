"""Fit layer (``models/fit.py`` ``fit_params_fused``): mean host milliseconds
of a traced round's ``fit_hypers`` / ``BQFleet.fit`` call, closed after a
synchronize."""


def read(tv):
    return tv.span_mean_ms("fit") if tv else None
