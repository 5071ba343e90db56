"""Failure handling around the daemon loop.

``outbox.py`` is the apiserver-outage degradation ladder: an actuation
outbox parks unreachable bind/evict POSTs with jittered backoff and a
dead-letter bound, and an outage detector declares the
``degraded=outage`` state that rounds keep solving through. The
checkpoint, journal and standby modules of the reference are not
ported yet (ROADMAP.md, Queue 1 item 7).
"""

from poseidon_tpu_torch.ha.outbox import (
    ActuationOutbox,
    OutageDetector,
    OutboxEntry,
)

__all__ = ["ActuationOutbox", "OutageDetector", "OutboxEntry"]
