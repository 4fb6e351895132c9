"""Job submission: run driver commands on the cluster.

Role-equivalent to the reference's job submission stack
(reference: dashboard/modules/job/job_manager.py:58 — JobManager spawns a
detached JobSupervisor actor per job which runs the entrypoint command;
python/ray/job_submission/ SDK + `ray job` CLI): here the supervisor actor
runs the subprocess, streams captured output and status into the cluster KV,
and the client polls them.

The port's own copy of ``ray_tpu/job_submission.py``: the entrypoint gets
the head's address in the port's variable, ``RT_TORCH_ADDRESS``
(``core/config.ADDRESS_ENV``), where the JAX supervisor sets
``RT_ADDRESS``.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.config import ADDRESS_ENV

PENDING, RUNNING, SUCCEEDED, FAILED, STOPPED = (
    "PENDING", "RUNNING", "SUCCEEDED", "FAILED", "STOPPED",
)


@ray_tpu_torch.remote(max_concurrency=4)
class JobSupervisor:
    """Runs one job's entrypoint command (reference: job_manager.py:31
    JobSupervisor actor)."""

    def __init__(self, job_id: str, entrypoint: str, env_vars: Dict[str, str]):
        import subprocess
        import threading

        from ray_tpu_torch.core.context import ctx

        self.job_id = job_id
        self.client = ctx.client
        self._kv(f"status", RUNNING)
        env = dict(os.environ)
        env.update(env_vars or {})
        env[ADDRESS_ENV] = os.environ["RT_HEAD_ADDR"]
        self.proc = subprocess.Popen(
            entrypoint, shell=True, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        self._stopped = False
        threading.Thread(target=self._pump, daemon=True).start()

    def _kv(self, key: str, value: str):
        self.client.kv_put(f"job:{self.job_id}:{key}", value.encode())

    def _pump(self):
        lines: List[str] = []
        for line in self.proc.stdout:
            lines.append(line)
            if len(lines) % 20 == 0:
                self._kv("logs", "".join(lines))
        self.proc.wait()
        self._kv("logs", "".join(lines))
        if self._stopped:
            self._kv("status", STOPPED)
        else:
            self._kv("status",
                     SUCCEEDED if self.proc.returncode == 0 else FAILED)
        self._kv("returncode", str(self.proc.returncode))

    def stop(self) -> bool:
        self._stopped = True
        try:
            self.proc.terminate()
        except ProcessLookupError:
            pass
        return True

    def ping(self) -> str:
        return "ok"


class JobSubmissionClient:
    """(reference: python/ray/job_submission/sdk.py JobSubmissionClient)"""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            if address:
                os.environ[ADDRESS_ENV] = address
            ray_tpu_torch.init(ignore_reinit_error=True)
        from ray_tpu_torch.core.context import ctx

        self._client = ctx.client

    def submit_job(self, *, entrypoint: str,
                   env_vars: Optional[Dict[str, str]] = None,
                   job_id: Optional[str] = None) -> str:
        job_id = job_id or f"job_{uuid.uuid4().hex[:8]}"
        self._client.kv_put(f"job:{job_id}:entrypoint", entrypoint.encode())
        self._client.kv_put(f"job:{job_id}:status", PENDING.encode())
        JobSupervisor.options(
            name=f"JOB_SUPERVISOR:{job_id}", num_cpus=1
        ).remote(job_id, entrypoint, env_vars or {})
        return job_id

    def get_job_status(self, job_id: str) -> str:
        raw = self._client.kv_get(f"job:{job_id}:status")
        return raw.decode() if raw else PENDING

    def get_job_logs(self, job_id: str) -> str:
        raw = self._client.kv_get(f"job:{job_id}:logs")
        return raw.decode() if raw else ""

    def list_jobs(self) -> List[dict]:
        out = []
        for key in self._client.kv_keys("job:"):
            if key.endswith(":status"):
                job_id = key.split(":")[1]
                out.append({
                    "job_id": job_id,
                    "status": self.get_job_status(job_id),
                })
        return out

    def stop_job(self, job_id: str) -> bool:
        try:
            sup = ray_tpu_torch.get_actor(f"JOB_SUPERVISOR:{job_id}")
            return ray_tpu_torch.get(sup.stop.remote(), timeout=30)
        except Exception:
            return False

    def wait_until_finished(self, job_id: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            time.sleep(0.2)
        raise TimeoutError(f"job {job_id} still {status} after {timeout}s")
