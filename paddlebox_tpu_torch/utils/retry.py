"""Unified retry/backoff for the transient-failure sites of the port
(reference: paddlebox_tpu/utils/retry.py).  Every such site routes through
one helper, so the backoff shape, the deadline and the per-site accounting
are uniform:

    retry_call(parser.parse_file, path, site="data.read")

Per-site counters land in ``utils.monitor.stats``:

    retry.<site>.calls      invocations of retry_call
    retry.<site>.attempts   individual attempts (>= calls)
    retry.<site>.retries    attempts after the first
    retry.<site>.exhausted  calls that failed every attempt

Backoff is jittered exponential: ``base * multiplier**(n-1)`` capped at
``max_delay_s``, scaled by ``1 + jitter * u`` with ``u`` drawn from a
deterministic per-(site, attempt) stream — runs are reproducible, but
distinct sites never sleep in lockstep.  A ``deadline_s`` bounds the whole
call (attempts + sleeps): once exceeded, the last exception re-raises
without further attempts.

What is retryable: exceptions for which ``register_retryable`` was called
(utils.fs registers FsError, utils.faults registers FaultInjected) plus
OS-level transience (OSError, subprocess errors).  Logic errors — ValueError
from a malformed input line, KeyError from a schema mismatch — never retry.

Defaults come from the flag shim (PADDLEBOX_TORCH_RETRY_MAX_ATTEMPTS,
PADDLEBOX_TORCH_RETRY_BASE_DELAY_S, PADDLEBOX_TORCH_RETRY_MAX_DELAY_S), so
tests and chaos runs can tighten them without threading a policy through
every call site.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import subprocess
import time
import zlib
from typing import Callable, Optional

from paddlebox_tpu_torch.utils.monitor import stats

logger = logging.getLogger(__name__)

# exception types considered transient by default; extended via
# register_retryable so leaf modules never import each other's errors
_RETRYABLE: tuple = (OSError, TimeoutError, subprocess.SubprocessError)


def register_retryable(exc_type: type) -> None:
    """Mark an exception type as transient for the default predicate."""
    global _RETRYABLE
    if exc_type not in _RETRYABLE:
        _RETRYABLE = _RETRYABLE + (exc_type,)


def default_retryable(exc: BaseException) -> bool:
    return isinstance(exc, _RETRYABLE)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Shape of one retry loop: attempts, backoff curve, deadline."""

    max_attempts: int = 3
    base_delay_s: float = 1.0
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.1  # fraction of the delay added from the jitter stream
    deadline_s: Optional[float] = None

    @staticmethod
    def from_flags() -> "RetryPolicy":
        from paddlebox_tpu_torch.config import flags

        return RetryPolicy(
            max_attempts=flags.retry_max_attempts,
            base_delay_s=flags.retry_base_delay_s,
            max_delay_s=flags.retry_max_delay_s,
        )

    def delay(self, attempt: int, site: str) -> float:
        """Sleep before attempt ``attempt`` (1-based; attempt 0 never sleeps)."""
        d = min(
            self.base_delay_s * self.multiplier ** (attempt - 1),
            self.max_delay_s,
        )
        if self.jitter:
            u = random.Random(
                (zlib.crc32(site.encode()) << 8) ^ attempt
            ).random()
            d *= 1.0 + self.jitter * u
        return d


def retry_call(
    fn: Callable,
    *args,
    site: str,
    policy: Optional[RetryPolicy] = None,
    retryable: Optional[Callable[[BaseException], bool]] = None,
    sleep: Callable[[float], None] = time.sleep,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying transient failures.

    ``site`` names the call site for stats and fault-plan matching; keep it
    stable ("fs.upload", "data.read") — chaos tests assert on these names.
    """
    policy = policy or RetryPolicy.from_flags()
    retryable = retryable or default_retryable
    stats.add(f"retry.{site}.calls")
    start = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(max(policy.max_attempts, 1)):
        if attempt:
            d = policy.delay(attempt, site)
            if (
                policy.deadline_s is not None
                and time.monotonic() - start + d > policy.deadline_s
            ):
                break
            stats.add(f"retry.{site}.retries")
            sleep(d)
        stats.add(f"retry.{site}.attempts")
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            last = e
            if not retryable(e):
                raise
            logger.warning(
                "retry site %s attempt %d/%d failed: %r",
                site, attempt + 1, policy.max_attempts, e,
            )
    stats.add(f"retry.{site}.exhausted")
    raise last  # set: the first attempt never waits on the deadline
