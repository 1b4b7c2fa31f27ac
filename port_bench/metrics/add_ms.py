"""GP refit layer (``models/bq.py`` ``_fit_gps``, ``models/gp.py``,
``ops/linalg.py``): mean host milliseconds of a traced step's
``add_observation`` call, closed after a synchronize."""


def read(tv):
    return tv.span_mean_ms("add") if tv else None
