"""Chunk-dispatch supervision: retry transient failures, demote a
broken fused backend to the plain PyTorch path.

The tick loop's chunk dispatch is the engine's single point of total
failure: an exception out of the chunk call (a kernel that fails to
launch, an injected fault) would unwind ``poll()`` and end the episode
with S requests resident.  The supervisor wraps that call:

- **Transient failures** are retried with capped exponential backoff
  (``engine.faults.chunk_retries`` counts them).  Retries are safe
  because the engine's attempt raises before it writes the chunk's
  static buffers (an injected fault raises ahead of the graph replay or
  the eager chunk), so the attempt closure can simply be invoked again.
- **Persistent failures on the fused backend** demote the engine to the
  ``torch`` chunk (the plain PyTorch path), permanently, with one loud
  ``RuntimeWarning`` and an ``engine.faults.backend_demoted`` count, so
  a kernel bug degrades throughput instead of availability.  The
  caller-supplied ``demote()`` callback switches the engine over (it
  drops the CUDA graph and runs the plain chunk eagerly on the same
  buffers), then the dispatch is attempted once more on the fallback.
- **Persistent failures on the plain backend** have no fallback:
  :class:`ChunkDispatchError` propagates with the retry history
  attached, and ``drain(timeout_s=...)`` surfaces the stall snapshot.

``retry_on`` names the exceptions the supervisor handles; any other
propagates from the first attempt as it was raised, with no retry and no
demotion.  The default is every ``Exception``, as in the reference.  On
the card the serving engine narrows it to ``InjectedChunkError``: a
kernel that fails to build or launch, or a graph replay that fails,
raises at once, and the plain chunk never runs in the kernel's place.

The port's copy of ``repro.faults.supervisor``; the fallback backend is
named ``torch`` where the reference's is ``jnp``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, List, Optional, Tuple, Type

__all__ = ["RetryPolicy", "ChunkDispatchError", "ChunkSupervisor"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule for transient chunk-dispatch failures."""

    max_retries: int = 2
    backoff_s: float = 0.005
    backoff_cap_s: float = 0.1
    demote_fused: bool = True

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff must be >= 0")

    def delay_s(self, attempt: int) -> float:
        """Capped exponential backoff before retry ``attempt`` (1-based)."""
        return min(self.backoff_s * (2.0 ** (attempt - 1)),
                   self.backoff_cap_s)


class ChunkDispatchError(RuntimeError):
    """Chunk dispatch failed after exhausting retries and any fallback.

    ``errors`` holds every underlying exception in attempt order.
    """

    def __init__(self, message: str, errors: List[BaseException]):
        super().__init__(message)
        self.errors = list(errors)


class ChunkSupervisor:
    """Runs a chunk-dispatch attempt under the retry/demotion policy.

    ``on_retry``/``on_demote`` are metric hooks (called with the attempt
    count / once on demotion); ``demote`` swaps the engine's chunk to
    the plain torch path and returns the *fallback* attempt callable, or
    ``None`` when no fallback exists (already on the reference path).
    ``retry_on`` is the tuple of exception types that are retried and
    may demote; others propagate at once.  ``sleep`` is injectable for
    tests.
    """

    def __init__(
        self,
        policy: Optional[RetryPolicy] = None,
        *,
        on_retry: Optional[Callable[[int], None]] = None,
        on_demote: Optional[Callable[[], None]] = None,
        retry_on: Tuple[Type[BaseException], ...] = (Exception,),
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.policy = policy or RetryPolicy()
        self.retry_on = tuple(retry_on)
        self._on_retry = on_retry
        self._on_demote = on_demote
        self._sleep = sleep

    def call(
        self,
        attempt: Callable[[], object],
        *,
        backend: str,
        demote: Optional[Callable[[], Callable[[], object]]] = None,
    ) -> object:
        """Invoke ``attempt`` with retries; on exhaustion, demote fused
        dispatch via ``demote()`` and try the fallback once (plus its
        own retry budget).  Raises :class:`ChunkDispatchError` when no
        path succeeds."""
        errors: List[BaseException] = []
        for i in range(self.policy.max_retries + 1):
            try:
                return attempt()
            except self.retry_on as exc:
                errors.append(exc)
                if i < self.policy.max_retries:
                    if self._on_retry is not None:
                        self._on_retry(1)
                    self._sleep(self.policy.delay_s(i + 1))

        can_demote = (
            self.policy.demote_fused
            and backend == "fused"
            and demote is not None
        )
        if not can_demote:
            raise ChunkDispatchError(
                f"chunk dispatch failed after "
                f"{self.policy.max_retries + 1} attempts on "
                f"backend={backend!r}: {errors[-1]!r}",
                errors,
            )

        warnings.warn(
            "SNNStreamEngine: fused chunk dispatch failed "
            f"{len(errors)} times ({errors[-1]!r}); permanently "
            "demoting backend fused -> torch for this engine",
            RuntimeWarning,
            stacklevel=2,
        )
        if self._on_demote is not None:
            self._on_demote()
        fallback = demote()
        for i in range(self.policy.max_retries + 1):
            try:
                return fallback()
            except self.retry_on as exc:
                errors.append(exc)
                if i < self.policy.max_retries:
                    if self._on_retry is not None:
                        self._on_retry(1)
                    self._sleep(self.policy.delay_s(i + 1))
        raise ChunkDispatchError(
            "chunk dispatch failed on fused and on the torch fallback "
            f"({len(errors)} attempts): {errors[-1]!r}",
            errors,
        )
