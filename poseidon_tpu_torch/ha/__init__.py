"""Crash safety, high availability and failure handling around the
daemon loop (the port of ``poseidon_tpu/ha/``).

- ``checkpoint.py``: atomic warm-state checkpoints (the solve seed as
  numpy, padding floors, the bridge's pod/machine state, knowledge
  rings, builder columns, watch position) written by a background
  thread, and the warm restore (``restore_bridge``). The manifest and
  npz layout are the reference's, so either package restores the
  other's checkpoints.
- ``journal.py``: the write-ahead actuation journal and its idempotent
  replay, so a kill anywhere in actuation ends in exactly-once binds.
- ``standby.py``: lease-based leader election and the warm standby
  that follows the leader's checkpoints and takes over warm.
- ``outbox.py``: the apiserver-outage degradation ladder: an
  actuation outbox parks unreachable bind/evict POSTs with jittered
  backoff and a dead-letter bound, and an outage detector declares the
  ``degraded=outage`` state that rounds keep solving through.
"""

from poseidon_tpu_torch.ha.checkpoint import (
    CheckpointManager,
    CheckpointSnapshot,
    load_latest,
    restore_bridge,
)
from poseidon_tpu_torch.ha.journal import ActuationJournal, replay_journal
from poseidon_tpu_torch.ha.outbox import (
    ActuationOutbox,
    OutageDetector,
    OutboxEntry,
)
from poseidon_tpu_torch.ha.standby import LeaderElector

__all__ = [
    "ActuationJournal",
    "ActuationOutbox",
    "CheckpointManager",
    "CheckpointSnapshot",
    "LeaderElector",
    "OutageDetector",
    "OutboxEntry",
    "load_latest",
    "replay_journal",
    "restore_bridge",
]
