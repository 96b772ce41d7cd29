"""Device idle milliseconds per field while a kernel's dispatching
wrapper ran: the innermost program span open over the idle time is a
`dispatch.<kernel>` span (the policy's resolution, the wrapper's checks,
its scratch and output allocations, the launch; or the plain version's
torch operators) (`portbench.spans`)."""
from portbench import spans


def read(rec):
    return spans.idle_ms_per_field(rec, "dispatch")
