"""Runtime sanitizers: build / transfer / host-sync guards."""
from .guards import (CompileLog, GuardError, HostSyncError,  # noqa: F401
                     RecompileError, SyncLog, TransferError, TransferLog,
                     host_sync_guard, no_implicit_transfers, no_recompiles,
                     note_build)

__all__ = ["CompileLog", "GuardError", "HostSyncError", "RecompileError",
           "SyncLog", "TransferError", "TransferLog", "host_sync_guard",
           "no_implicit_transfers", "no_recompiles", "note_build"]
