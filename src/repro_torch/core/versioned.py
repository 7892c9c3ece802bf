"""Generic versioned-artifact store: publish / snapshot / subscribe.

The port's copy of the reference's ``core/versioned.py`` (pure
Python).  Two serving-plane artifacts hot-swap under load — policy
snapshots (``repro_torch.policies.PolicyStore``) and index epochs
(``repro_torch.index.live.IndexEpochStore``).  Both need the same
primitive: a producer publishes immutable snapshots with monotonically
increasing version ids; consumers pin a snapshot and periodically
refresh, with a *staleness bound* — a consumer more than
``staleness_bound`` versions behind the head must refuse to serve
(:class:`StaleVersionError`) rather than silently answer with an
ancient artifact.

This module is that shared core.  Thread-safe: ``publish`` may be
called from a producer thread while consumers ``snapshot``/``validate``
concurrently.  Snapshots are immutable objects fully built before the
head pointer moves, so a reader can never observe a torn snapshot.
Subscriber delivery is per-subscriber serialized and version-monotone —
a callback registered mid-publish observes either the old or the new
version first, never both out of order and never the same version
twice.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

__all__ = ["StaleVersionError", "Subscriber", "VersionedStore"]


class StaleVersionError(RuntimeError):
    """A consumer's pinned snapshot is older than the staleness bound.

    Base class shared by `StalePolicyError` (policy snapshots) and
    `StaleIndexEpochError` (index epochs) so serving loops can catch
    every hot-swap race with one clause."""


class Subscriber:
    """One registered callback with per-subscriber delivery state.

    ``deliver`` serializes invocations of the callback (two concurrent
    publishers never run it at once) and enforces version monotonicity:
    a snapshot at or below the last delivered version is dropped.  This
    closes the subscribe-under-concurrent-publish race where the
    initial replay of the current snapshot could land *after* a newer
    publish already notified the callback, delivering versions out of
    order."""

    __slots__ = ("callback", "_lock", "_last_version")

    def __init__(self, callback: Callable[[Any], None]):
        self.callback = callback
        self._lock = threading.Lock()
        self._last_version = 0

    def deliver(self, snap: Any) -> None:
        with self._lock:
            if snap.version <= self._last_version:
                return
            self._last_version = snap.version
            self.callback(snap)


class VersionedStore:
    """Version machinery shared by every hot-swappable serving artifact.

    Subclasses provide a domain ``publish`` that calls
    :meth:`_publish_snapshot` with a build function; snapshots must be
    immutable objects exposing an integer ``version`` attribute.
    ``stale_error`` names the exception ``validate`` raises (always a
    :class:`StaleVersionError` subclass) and ``artifact`` the noun used
    in messages."""

    stale_error = StaleVersionError
    artifact = "snapshot"

    def __init__(self, staleness_bound: int = 1):
        if staleness_bound < 0:
            raise ValueError("staleness_bound must be >= 0")
        self.staleness_bound = staleness_bound
        self._lock = threading.Lock()
        self._snapshot: Optional[Any] = None
        self._subscribers: List[Subscriber] = []

    # ------------------------------------------------------------ publish
    def _publish_snapshot(self, build: Callable[[Optional[Any], int], Any],
                          version: Optional[int] = None) -> int:
        """Install ``build(previous_snapshot, next_version)`` as the new
        head and notify subscribers (outside the lock); returns the new
        version.  The build function runs under the store lock, so it
        must be cheap — assemble heavy payloads before publishing.

        ``version`` pins an explicit head version instead of the default
        head+1, so that a consumer's store can mirror a producer's
        numbering exactly (a late joiner jumps straight to the head
        version it is sent; gaps are legal, regressions are not)."""
        with self._lock:
            head = self._snapshot.version if self._snapshot else 0
            if version is None:
                version = head + 1
            elif version <= head:
                raise ValueError(
                    f"explicit version {version} must exceed head {head}")
            snap = build(self._snapshot, version)
            assert snap.version == version, "build must stamp the version"
            self._snapshot = snap
            subscribers = list(self._subscribers)
        for sub in subscribers:
            sub.deliver(snap)
        return version

    # ----------------------------------------------------------- consume
    @property
    def version(self) -> int:
        """Head version (0 before the first publish)."""
        snap = self._snapshot
        return snap.version if snap else 0

    def snapshot(self) -> Any:
        snap = self._snapshot
        if snap is None:
            raise LookupError(
                f"{type(self).__name__} has no published {self.artifact} yet")
        return snap

    def subscribe(self, callback: Callable[[Any], None]) -> Callable[[], None]:
        """Register ``callback(snapshot)`` for future publishes (and
        immediately for the current snapshot, if any).  Returns an
        unsubscribe function.

        Safe under concurrent ``publish``: the callback observes a
        strictly increasing version sequence whose first element is the
        snapshot current at registration *or any later one* — never an
        older version after a newer, never a duplicate."""
        sub = Subscriber(callback)
        with self._lock:
            self._subscribers.append(sub)
            snap = self._snapshot
        if snap is not None:
            # Replay outside the store lock; Subscriber.deliver drops
            # it if a concurrent publish already delivered a newer one.
            sub.deliver(snap)

        def unsubscribe() -> None:
            with self._lock:
                if sub in self._subscribers:
                    self._subscribers.remove(sub)
        return unsubscribe

    def staleness(self, version: int) -> int:
        """Versions between a pinned snapshot and the head."""
        return self.version - version

    def validate(self, version: int) -> int:
        """Enforce the staleness bound on a pinned snapshot version.
        Returns the staleness; raises :attr:`stale_error` beyond the
        bound."""
        staleness = self.staleness(version)
        if staleness > self.staleness_bound:
            raise self.stale_error(
                f"{self.artifact} v{version} is {staleness} versions behind "
                f"head v{self.version} "
                f"(staleness_bound={self.staleness_bound}); "
                "refresh before serving")
        return staleness
