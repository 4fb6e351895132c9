"""Standalone head daemon: the control plane in its OWN process.

Role-equivalent to the reference's `ray start --head` GCS server process
(reference: src/ray/gcs/gcs_server/gcs_server_main.cc): drivers attach over
RT_TORCH_ADDRESS instead of hosting the head in-process, so the head can crash —
and be restarted — independently of every workload.  Three things make a
restart survivable (the whole point of running the head this way):

- **fixed port** (``RT_HEAD_PORT``): headless nodes, workers, and drivers
  redial the address they already have;
- **stable session** (``RT_HEAD_SESSION``): the store namespace survives,
  so pre-crash shm segments stay addressable after resync;
- **stable local node id** (``RT_NODE_ID``): object locations recorded
  before the crash keep resolving to "the head's node" after it.

Pair with ``head_state_path`` (``RT_HEAD_STATE_PATH``) for the durable
tables and the restart becomes a bounded pause instead of an outage — see
``cluster_utils.ExternalHead`` for the supervised spawn/kill/restart
wrapper the chaos harness uses.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import uuid

from .config import Config, address_file, set_config
from .head import Head
from .ids import NodeID
from .rpc import ServerThread


def main() -> int:
    cfg = Config().apply_env_overrides()
    set_config(cfg)
    session = os.environ.get("RT_HEAD_SESSION") or uuid.uuid4().hex[:12]
    host = os.environ.get("RT_NODE_HOST", "127.0.0.1")
    port = int(os.environ.get("RT_HEAD_PORT", "0"))

    head = Head(cfg, session, host=host)
    head.server.port = port  # 0 = ephemeral; fixed for restartable heads
    server_thread = ServerThread(head.server)
    port = server_thread.start()
    head.port = port

    resources = json.loads(os.environ.get("RT_NODE_RESOURCES", "{}"))
    if "CPU" not in resources:
        resources["CPU"] = float(os.cpu_count() or 2)
    resources.setdefault("memory", float(2**33))
    num_workers = int(
        os.environ.get("RT_NODE_NUM_WORKERS", str(int(resources["CPU"])))
    )
    node_id = (
        NodeID(bytes.fromhex(os.environ["RT_NODE_ID"]))
        if os.environ.get("RT_NODE_ID") else None
    )

    async def _boot():
        head.add_local_node(resources, num_workers, node_id=node_id)
        await head.restore_state()
        await head.start_periodic()

    server_thread.run_coro(_boot()).result(timeout=60)

    addr = f"{host}:{port}"
    try:
        path = address_file()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(addr)
    except OSError:
        pass
    # The supervisor (ExternalHead) waits for this line.
    print(f"RAY_TPU_HEAD_READY {addr} session={session}", flush=True)

    stop = threading.Event()

    def _on_term(*_):
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    while not stop.is_set():
        time.sleep(0.2)
    try:
        server_thread.run_coro(head.stop()).result(timeout=10)
    except Exception:
        pass
    server_thread.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
