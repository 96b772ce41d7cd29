"""Raw bytes over stored bytes, summed over the cell's snapshots.  Stored
bytes are those of the storage form a user writes, counted by the
reference's arithmetic from each snapshot's container."""


def read(rec):
    if not rec.snapshot_stored or None in rec.snapshot_stored:
        return None
    return sum(rec.snapshot_raw) / sum(rec.snapshot_stored)
