"""The self-healing policy of ``fit_batched`` (counterpart of the
healing half of ``hhmm_tpu/robust/retry.py``): a bounded number of
re-dispatches of the series whose chains were quarantined, with
deterministic re-jittered seeds and an escalating remedy ladder.

- **Escalation ladder** (:func:`escalate`), per healing attempt:

  1. fresh inits and a re-jittered seed (same config),
  2. \\+ halved ``init_step_size`` and raised ``target_accept``,
  3. \\+ reduced ``max_treedepth`` (NUTS) / halved ``max_leapfrogs``
     (ChEES).

  Gibbs has no step-size knobs; every attempt is fresh inits and seed.
- **Deterministic re-jitter** (:func:`rejitter`): a retry seed is a pure
  function of (chunk seed, attempt), so a crashed and resumed sweep
  replays the same healing and the digest cache stays coherent.

Not carried over: the JAX package's device-level retry of a dispatch
(``UNAVAILABLE:`` statuses of a TPU tunnel, with ``backoff`` between
attempts) and ``ensure_backend``'s fallback to the CPU. A CUDA launch or
runtime error is sticky to its context, so retrying the dispatch cannot
heal it, and the port never hides the device behind a CPU route: a
CUDA error raises. :class:`RetryPolicy` keeps ``device_retries`` and
``backoff`` so a policy written for the JAX ladder reads the same here.

- **Bounded I/O retry** (:class:`BackoffPolicy`, :func:`retry_call`):
  jittered exponential backoff for transient storage faults — the serve
  pager's snapshot loads get a bounded second chance before degrading
  to a shed tick. The jitter is a pure function of (seed, salt,
  attempt), so a replay sleeps the same.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

__all__ = ["RetryPolicy", "BackoffPolicy", "retry_call", "derive_seed", "escalate", "rejitter"]

# salt folded in before the attempt, so a retry seed never equals an
# ordinary derive_seed(seed, i) series derivation
_SALT = 0x5EED


@dataclass(frozen=True)
class RetryPolicy:
    """Bounds and knobs for the self-healing dispatch in ``fit_batched``.

    ``max_heal_attempts``: re-dispatches of a chunk with quarantined
    series (attempt 0 is the original dispatch). ``device_retries`` and
    ``backoff_base_s`` / :meth:`backoff` are the JAX policy's device
    retry fields, kept for parity; the port dispatches once (see the
    module docstring)."""

    max_heal_attempts: int = 3
    device_retries: int = 4
    backoff_base_s: float = 15.0
    step_size_factor: float = 0.5
    target_accept_raise: float = 0.05
    target_accept_cap: float = 0.95
    treedepth_step: int = 2
    treedepth_floor: int = 4
    leapfrog_floor: int = 8

    def backoff(self, attempt: int) -> float:
        """The JAX policy's backoff before device retry ``attempt``
        (0-based): linear multiples of the base."""
        return self.backoff_base_s * (attempt + 1)


def derive_seed(*parts: Any) -> int:
    """A 60-bit generator seed from a tuple of ints (a digest, so nearby
    tuples give unrelated streams): the first 15 hex digits of a SHA-256
    over each part's JSON text, the bytes ``batch.cache.digest_key``
    hashes for ints. It lives here, below ``batch/``, so that
    :func:`rejitter` needs no import from the layer that calls it;
    ``batch.fit`` re-exports it."""
    h = hashlib.sha256()
    for p in parts:
        h.update(json.dumps(int(p)).encode())
    return int(h.hexdigest()[:15], 16)


def rejitter(seed: int, attempt: int) -> int:
    """Deterministic retry seed of ``seed`` for healing ``attempt``:
    ``derive_seed(seed, salt, attempt)`` (the JAX ``rejitter`` folds the
    same salt and the attempt into a key)."""
    return derive_seed(seed, _SALT, attempt)


def escalate(config: Any, attempt: int, policy: RetryPolicy = RetryPolicy()) -> Any:
    """Remedy ladder for healing attempt ``attempt`` (1-based).

    Works on any frozen config dataclass by the knobs it owns
    (``init_step_size`` / ``target_accept`` for both HMC samplers,
    ``max_treedepth`` for NUTS, ``max_leapfrogs`` for ChEES); a config
    with none of them (Gibbs) comes back unchanged."""
    if attempt <= 1:
        return config
    kw: Dict[str, Any] = {}
    if hasattr(config, "init_step_size"):
        kw["init_step_size"] = config.init_step_size * (policy.step_size_factor ** (attempt - 1))
    if hasattr(config, "target_accept"):
        kw["target_accept"] = min(
            policy.target_accept_cap,
            config.target_accept + policy.target_accept_raise * (attempt - 1),
        )
    if attempt >= 3:
        if hasattr(config, "max_treedepth"):
            kw["max_treedepth"] = max(policy.treedepth_floor, config.max_treedepth - policy.treedepth_step)
        if hasattr(config, "max_leapfrogs"):
            kw["max_leapfrogs"] = max(policy.leapfrog_floor, config.max_leapfrogs // 2)
    return dataclasses.replace(config, **kw) if kw else config


@dataclass(frozen=True)
class BackoffPolicy:
    """Bounded retry-with-backoff for transient I/O faults (the pager's
    snapshot loads). ``attempts`` counts all calls (attempt 0 is the
    original); delays grow as ``base_s * factor**attempt`` clamped at
    ``max_s``, less a deterministic jitter of up to ``jitter`` of each
    delay (a pure function of ``(seed, salt, attempt)``)."""

    attempts: int = 3
    base_s: float = 0.005
    factor: float = 2.0
    max_s: float = 0.25
    jitter: float = 0.5
    seed: int = 0x5EED

    def __post_init__(self):
        if int(self.attempts) < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if self.base_s < 0 or self.max_s < 0:
            raise ValueError("base_s and max_s must be >= 0")
        if self.factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {self.factor}")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay(self, attempt: int, salt: int = 0) -> float:
        """Seconds to sleep after failed attempt ``attempt`` (0-based)."""
        raw = min(float(self.max_s), float(self.base_s) * self.factor ** attempt)
        if self.jitter <= 0.0 or raw <= 0.0:
            return raw
        mixed = (
            int(self.seed) * 0x9E3779B97F4A7C15
            + int(salt) * 0xC2B2AE3D27D4EB4F
            + int(attempt)
        ) & 0xFFFFFFFFFFFFFFFF
        u = random.Random(mixed).random()
        return raw * (1.0 - self.jitter * u)


def retry_call(
    fn: Callable[[], Any],
    policy: BackoffPolicy = BackoffPolicy(),
    *,
    failed: Optional[Callable[[Any], bool]] = None,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, Optional[Exception]], None]] = None,
    salt: int = 0,
) -> Any:
    """Call ``fn`` up to ``policy.attempts`` times with backoff between
    attempts; return the first result ``failed`` does not flag (default:
    ``result is None``, the registry's miss), else the last result. An
    exception is retried while attempts remain and re-raised from the
    last. ``on_retry(attempt, exc)`` fires before each sleep; ``sleep``
    is injectable for tests."""
    if failed is None:
        failed = lambda r: r is None  # noqa: E731 — the registry miss convention
    last: Any = None
    for attempt in range(int(policy.attempts)):
        err: Optional[Exception] = None
        try:
            last = fn()
        except Exception as e:
            if attempt + 1 >= policy.attempts:
                raise
            err, last = e, None
        if err is None and not failed(last):
            return last
        if attempt + 1 >= policy.attempts:
            break
        if on_retry is not None:
            on_retry(attempt, err)
        d = policy.delay(attempt, salt)
        if d > 0:
            sleep(d)
    return last
