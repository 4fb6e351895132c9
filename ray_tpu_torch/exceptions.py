"""Public exception types (role-equivalent of python/ray/exceptions.py)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at ray_tpu_torch.get() with the remote
    traceback attached (reference: python/ray/exceptions.py RayTaskError)."""

    def __init__(self, cause: BaseException, remote_traceback: str = ""):
        super().__init__(
            f"task raised {type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{remote_traceback}"
        )
        self.cause = cause
        self.remote_traceback = remote_traceback

    def __reduce__(self):
        # Default Exception reduce would re-init with the formatted message
        # string as `cause`, double-wrapping on unpickle.
        return (type(self), (self.cause, self.remote_traceback))


class TaskCancelledError(RayTpuError):
    pass


class WorkerCrashedError(RayTpuError):
    pass


class ActorDiedError(RayTpuError):
    def __init__(self, actor_id_hex: str, cause: str = ""):
        super().__init__(f"actor {actor_id_hex[:12]} died: {cause}")
        self.actor_id_hex = actor_id_hex
        self.cause = cause

    def __reduce__(self):
        # Default Exception reduce would re-init with the formatted message
        # as actor_id_hex, garbling both attributes after crossing the wire.
        return (type(self), (self.actor_id_hex, self.cause))


class ObjectLostError(RayTpuError):
    pass


class ObjectReconstructionFailedError(ObjectLostError):
    """Lineage reconstruction was attempted for a lost object but failed
    (no lineage, retries exhausted, depth limit, or the re-executed task
    failed) — a subtype of ObjectLostError so callers handling loss
    generically keep working (reference: object_recovery_manager.h:90)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class DeadlineExceededError(RayTpuError, TimeoutError):
    """A call's per-call deadline budget (core/deadline.py) ran out before
    any route — peer or head — produced a result.  Distinct from
    GetTimeoutError: the CALL is abandoned (and its result sealed with
    this error), not just one blocking get() giving up."""


from .core.rpc import ConnectionLost as _ConnectionLost


class HeadRestartedError(RayTpuError, _ConnectionLost):
    """A non-idempotent control-plane call was interrupted by a lost head
    connection — the head may have crashed/restarted mid-call, so the
    framework cannot know whether the operation landed.  Carries the method
    (and an optional detail) so the caller can decide to resubmit
    (reference: GCS FT — non-retryable RPCs surface to the caller on a GCS
    failover instead of being silently replayed).  Subclasses
    ``core.rpc.ConnectionLost`` so existing connection-error handling keeps
    working; catch this type specifically to implement resubmission.
    """

    def __init__(self, method: str, detail: str = ""):
        msg = (
            f"head connection lost during non-idempotent call {method!r}; "
            "the head may have restarted — idempotent state was preserved "
            "by the durable snapshot, but this operation must be "
            "resubmitted by the caller"
        )
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.method = method
        self.detail = detail

    def __reduce__(self):
        # Default Exception reduce would re-init with the formatted message
        # as `method`, garbling both attributes after crossing the wire.
        return (type(self), (self.method, self.detail))


class RuntimeEnvSetupError(RayTpuError):
    pass
