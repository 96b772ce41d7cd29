"""Device kernels, copies and memsets per field, of any origin."""


def read(rec):
    t = rec.trace
    if t is None or not t.device or not t.n_fields:
        return None
    return len(t.device) / t.n_fields
