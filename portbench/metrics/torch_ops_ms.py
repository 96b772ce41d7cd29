"""Device milliseconds per field of every operation that is not one of
the program's own kernels: PyTorch's and its libraries' kernels, copies
and memsets.  A kernel is the program's own when its launch ran outside
every PyTorch operator (`Trace.own_kernel`), so a kernel the program
adds later counts as its own without a list of names."""


def read(rec):
    t = rec.trace
    if t is None or not t.device or not t.n_fields:
        return None
    return t.device_us(own=False) / t.n_fields / 1e3
