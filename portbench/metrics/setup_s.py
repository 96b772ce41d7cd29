"""Process start to the first timed call: imports, the CUDA context, the
kernel library (built on a checkout's first run), the fields made on the
card, the containers of a decompress cell, and the warm-up."""


def read(rec):
    return rec.setup_s
