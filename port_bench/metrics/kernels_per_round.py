"""Facade (``models/api.py`` ``BQ``, ``models/batched.py`` ``BQFleet``):
device operations (kernels, copies, fills) the profiler records per traced
hyper round (fit and marginalization), the restore included."""


def read(tv):
    if not tv or not tv.units:
        return None
    n = tv.n_kernels()
    return n / tv.units if n else None
