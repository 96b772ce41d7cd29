"""Device idle milliseconds per field while the codec layer's own host
code ran: the innermost program span open over the idle time is a
`codec.*` span (a staged codec's encode, the registry's decode with its
lookup, checksum, version check and container unpack), not a stage or a
kernel's dispatch inside it (`portbench.spans`)."""
from portbench import spans


def read(rec):
    return spans.idle_ms_per_field(rec, "codec")
