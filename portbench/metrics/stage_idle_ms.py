"""Device idle milliseconds per field while the compressor's stages ran
their own host code: the innermost program span open over the idle time
is a `stage.*` span (the error bound's read, the predictor, the encoder,
the decode metadata and table cache, the decoder, the reconstruction;
the torch operators they call), not a kernel's dispatch inside it
(`portbench.spans`)."""
from portbench import spans


def read(rec):
    return spans.idle_ms_per_field(rec, "stage")
