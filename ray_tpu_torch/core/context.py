"""Process-global runtime context (driver or worker).

Analog of the reference's global worker singleton
(reference: python/ray/_private/worker.py global_worker).
"""

from __future__ import annotations

from typing import Optional


class RuntimeContext:
    def __init__(self):
        self.client = None  # core.client.Client
        self.mode: Optional[str] = None  # "driver" | "worker" | None
        self.job_id = None
        self.node_id = None
        self.worker_id = None
        self.session: Optional[str] = None
        self.current_task_id = None
        self.current_actor_id = None
        self.head_process = None  # in-driver head thread, if we started one
        self.namespace: str = "default"
        self.dashboard = None  # dashboard.Dashboard, if started via init()

    @property
    def initialized(self) -> bool:
        return self.client is not None

    def reset(self):
        self.__init__()


ctx = RuntimeContext()


def get_runtime_context() -> RuntimeContext:
    return ctx
