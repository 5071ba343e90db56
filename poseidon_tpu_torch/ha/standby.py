"""Leader election + the warm standby loop (``cli --standby``).

HA model: N scheduler processes share one checkpoint directory and one
k8s Lease-style lock on the apiserver (the fake apiserver implements
the coordination arbitration: grant when free, expired, or renewing
holder; 409 otherwise). Exactly one holds the lease and schedules; the
others are **warm followers** — they poll the lease AND keep the
latest checkpoint parsed in memory, so when the leader dies (stops
renewing) the winner of the next acquire restores bridge + solver +
watch position from the followed checkpoint and serves its first
round warm: no cold LIST, no cold solve, no migration storm
(tests/test_torch_ha.py proves the takeover round is warm and
migration-free).

The leader renews the lease every tick from inside ``run_loop``; a
failed renewal (partition, a faster standby after an apiserver-side
expiry) steps down loudly — exit code 1, the supervisor restarts the
process as a follower. Split-brain is excluded by the apiserver being
the single arbiter, exactly like kube-scheduler's own HA.
"""

from __future__ import annotations

import logging
import os
import socket
import time

from poseidon_tpu_torch.apiclient.client import ApiError, K8sApiClient
from poseidon_tpu_torch.ha.checkpoint import CheckpointSnapshot, load_latest

log = logging.getLogger(__name__)

DEFAULT_LEASE_NAME = "poseidon-scheduler"
DEFAULT_LEASE_NAMESPACE = "kube-system"


class LeaderElector:
    """One participant's view of the Lease lock."""

    def __init__(
        self,
        client: K8sApiClient,
        *,
        name: str = DEFAULT_LEASE_NAME,
        namespace: str = DEFAULT_LEASE_NAMESPACE,
        identity: str = "",
        duration_s: float = 15.0,
    ):
        self.client = client
        self.name = name
        self.namespace = namespace
        self.identity = identity or (
            f"{socket.gethostname()}-{os.getpid()}"
        )
        self.duration_s = duration_s
        self.held = False

    def try_acquire(self) -> bool:
        """One acquisition attempt; True = this process now leads.
        The server grants when the lease is free, expired, or already
        ours (an acquire doubles as a renew)."""
        try:
            self.held = self.client.acquire_lease(
                self.name, self.identity, self.duration_s,
                namespace=self.namespace,
            )
        except ApiError as e:
            log.warning("lease acquire failed: %s", e)
            self.held = False
        return self.held

    def renew(self) -> bool:
        """Heartbeat; False = leadership LOST (step down, don't
        schedule another round)."""
        ok = self.try_acquire()
        if not ok:
            log.error(
                "lease renewal failed for %s; stepping down",
                self.identity,
            )
        return ok

    def release(self) -> None:
        """Hand the lease back (clean shutdown: the standby takes over
        after one poll instead of a full expiry window)."""
        if not self.held:
            return
        try:
            self.client.release_lease(
                self.name, self.identity, namespace=self.namespace
            )
        except ApiError as e:
            log.warning("lease release failed: %s", e)
        self.held = False


def follow_checkpoints(
    checkpoint_dir: str,
    current: CheckpointSnapshot | None,
    last_mtime: float,
) -> tuple[CheckpointSnapshot | None, float]:
    """One follower poll: reload the newest checkpoint iff a newer
    manifest appeared (mtime probe first, so the idle-follow loop costs
    a directory listing, not a full parse)."""
    newest = 0.0
    try:
        for name in os.listdir(checkpoint_dir):
            if name.startswith("ckpt-") and name.endswith(".json"):
                p = os.path.join(checkpoint_dir, name)
                try:
                    newest = max(newest, os.path.getmtime(p))
                except OSError:
                    pass
    except OSError:
        return current, last_mtime
    if newest <= last_mtime:
        return current, last_mtime
    snap = load_latest(checkpoint_dir)
    if snap is not None:
        log.info(
            "standby: following checkpoint round %d", snap.round_num
        )
        return snap, newest
    return current, last_mtime


def run_standby(args) -> int:
    """The ``--standby`` loop: follow checkpoints until the lease is
    ours, then run the normal loop warm."""
    from poseidon_tpu_torch.cli import run_loop  # deferred: cli imports us lazily

    client = K8sApiClient(
        args.k8s_apiserver_host,
        args.k8s_apiserver_port,
        args.k8s_api_version,
        timeout_s=10.0,
    )
    elector = LeaderElector(
        client, duration_s=args.standby_lease_s
    )
    poll_s = max(args.standby_lease_s / 3.0, 0.05)
    follower: CheckpointSnapshot | None = None
    last_mtime = 0.0
    while True:
        if elector.try_acquire():
            # refresh AFTER winning: a gracefully-exiting leader
            # writes its final checkpoint and releases the lease in
            # the same breath, so the followed snapshot (last poll,
            # lease/3 ago) is nearly always one handover behind —
            # taking over on it would discard exactly the warm state
            # the final checkpoint exists to pass on
            if args.checkpoint_dir:
                fresh = load_latest(args.checkpoint_dir)
                if fresh is not None:
                    follower = fresh
            log.info(
                "standby %s acquired the lease; taking over (%s)",
                elector.identity,
                "warm from followed checkpoint" if follower is not None
                else "no checkpoint followed yet",
            )
            try:
                return run_loop(
                    args, lease=elector, preloaded=follower
                )
            finally:
                elector.release()
        if args.checkpoint_dir:
            follower, last_mtime = follow_checkpoints(
                args.checkpoint_dir, follower, last_mtime
            )
        time.sleep(poll_s)
