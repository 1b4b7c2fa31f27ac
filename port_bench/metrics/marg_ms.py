"""Marginalize layer (``models/marginalize.py``, ``models/batched.py``
``marginalize_batch``): mean host milliseconds of a traced round's
marginalization, the moments read back to the host."""


def read(tv):
    return tv.span_mean_ms("marg") if tv else None
