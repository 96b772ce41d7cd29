"""Blocking runtime calls (stream, device and event synchronizes, and
blocking copies) inside the program's calls, per field; the harness's
own synchronize after each call lies outside them."""


def read(rec):
    t = rec.trace
    if t is None or not t.device or not t.n_fields:
        return None
    return t.host_syncs() / t.n_fields
