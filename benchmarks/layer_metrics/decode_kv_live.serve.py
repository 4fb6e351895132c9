"""Live share of the KV that decode reads (%): over the engine's decode
steps in the traced window (``engine:step`` spans, ``bk/steps.py``), the
positions the steps attend (each busy slot's cached tokens and its new
one, ``kv_live``) over the positions the page-table gather reads (every
slot's whole table, ``kv_read``), both counted by the engine from its host
mirrors."""

from bk import steps


def read(run):
    st = steps.decode_steps(run)
    read_ = sum(a["kv_read"] for a in st)
    return sum(a["kv_live"] for a in st) / read_ * 100 if read_ else None
