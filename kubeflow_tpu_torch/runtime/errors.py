"""API error taxonomy mirroring Kubernetes StatusReasons.

The port's copy of ``kubeflow_tpu/runtime/errors.py``: it keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations


class ApiError(Exception):
    """Base error for apiserver interactions."""

    code = 500
    reason = "InternalError"

    def __init__(self, message: str = ""):
        super().__init__(message or self.reason)
        self.message = message or self.reason


class NotFound(ApiError):
    code = 404
    reason = "NotFound"


class AlreadyExists(ApiError):
    code = 409
    reason = "AlreadyExists"


class Conflict(ApiError):
    """resourceVersion conflict — caller should re-read and retry."""

    code = 409
    reason = "Conflict"


class Invalid(ApiError):
    code = 422
    reason = "Invalid"


class Forbidden(ApiError):
    code = 403
    reason = "Forbidden"


class Unauthorized(ApiError):
    code = 401
    reason = "Unauthorized"


class TooManyRequests(ApiError):
    """429 — apiserver priority & fairness rejected the request. The
    client honors Retry-After with bounded retries before raising."""

    code = 429
    reason = "TooManyRequests"


class ServerTimeout(ApiError):
    """No response within the client deadline (hung apiserver / dead
    conntrack entry). Retriable: the workqueue re-queues with backoff,
    which is exactly what a pinned-forever reconcile worker could not do."""

    code = 504
    reason = "ServerTimeout"


def error_for_code(code: int, message: str = "", reason: str | None = None) -> ApiError:
    if code == 409:
        # Both AlreadyExists and Conflict are 409s; the apiserver's Status
        # body carries the distinguishing ``reason`` field — prefer it when
        # the caller parsed one (free-text matching misclassifies a Conflict
        # whose message happens to contain "already exists", or a non-English
        # AlreadyExists body). Default to Conflict — the stale-resourceVersion
        # case — as the safer retry behavior.
        if reason == "AlreadyExists":
            return AlreadyExists(message)
        if reason == "Conflict":
            return Conflict(message)
        if "AlreadyExists" in message or "already exists" in message:
            return AlreadyExists(message)
        return Conflict(message)
    for cls in (NotFound, Invalid, Forbidden, Unauthorized, TooManyRequests,
                ServerTimeout):
        if cls.code == code:
            return cls(message)
    err = ApiError(message)
    err.code = code
    return err
