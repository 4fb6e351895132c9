"""Wire-schema versioning + message validation for the control plane.

Role-equivalent to the reference's protobuf schemas (reference:
src/ray/protobuf/*.proto — 22 files give every RPC a typed, versioned wire
format).  This framework ships msgpack dicts for flexibility; this module
supplies the two protections protobuf would have given:

- **Protocol version handshake**: every `register` carries
  ``PROTOCOL_VERSION``; the head rejects mismatched peers with a clear
  error instead of failing later on a missing/renamed field (the analog of
  a protobuf breaking-change guard).  Bump the version whenever a message's
  required fields change incompatibly.
- **Required-field validation**: the head validates the control-plane's
  mutating messages at the boundary and answers malformed ones with a
  field-level error, instead of a KeyError deep in a handler.

Only *requests into the head* are validated — responses and pushes are
produced by the head itself.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

PROTOCOL_VERSION = 1

_BYTES = (bytes, bytearray)
_NUM = (int, float)

#: method -> ((field, allowed types | None for any), ...)
REQUIRED: Dict[str, Tuple[Tuple[str, Any], ...]] = {
    # `register` doubles as the field-state RESYNC message (head restart
    # survival): with ``reconnect: true`` the body carries the process's
    # existing identity (worker_id/node_id/peer_addr) plus a ``resync``
    # map — workers: {actor_id, creation_spec (with actor_meta), running
    # _tasks}; nodes: {worker_pids, headless_s}.  The head adopts the
    # reported state or answers {"refused": reason}; object manifests
    # replay separately through put_object_batch entries (optionally
    # flagged ``resync: true`` to skip the adopt push-back).
    "register": (("kind", str),),
    "submit_task": (
        ("task_id", _BYTES),
        ("func_key", (str, type(None))),
        ("return_ids", list),
    ),
    "create_actor": (("actor_id", _BYTES), ("creation_task", dict)),
    "submit_actor_task": (("task_id", _BYTES), ("actor_id", _BYTES)),
    "task_done": (("task_id", _BYTES),),
    "put_object": (("object_id", _BYTES),),
    "put_object_batch": (("objects", list),),
    "proxy_put": (("object_id", _BYTES), ("total", _NUM), ("offset", _NUM),
                  ("data", _BYTES)),
    "object_free_ack": (("token", _NUM),),
    "get_objects": (("object_ids", list),),
    "next_stream_item": (("task_id", _BYTES), ("index", _NUM)),
    "pull_object": (("object_id", _BYTES),),
    "wait_objects": (("object_ids", list),),
    "object_sizes": (("object_ids", list),),
    "free_objects": (("object_ids", list),),
    "add_object_ref": (("object_ids", list),),
    "reconstruct_object": (("object_id", _BYTES),),
    "create_placement_group": (("pg_id", _BYTES), ("bundles", list)),
    "remove_placement_group": (("pg_id", _BYTES),),
    "kill_actor": (("actor_id", _BYTES),),
    "cancel_task": (("task_id", _BYTES),),
    "get_actor_by_name": (("name", str),),
    "kv_put": (("key", str), ("value", _BYTES)),
    "kv_get": (("key", str),),
    "kv_del": (("key", str),),
    "publish": (("topic", str),),
    "subscribe": (("topic", str),),
    "list_state": (("kind", str),),
    "batch": (("entries", list),),
    "stream_item": (("task_id", _BYTES), ("index", _NUM)),
    "task_blocked": (("task_id", _BYTES),),
    "task_unblocked": (("task_id", _BYTES),),
    "node_health_ack": (("node_id", _BYTES),),
    "node_stats": (("node_id", _BYTES),),
    "node_drain": (("node_id", _BYTES),),
    # Batched span plane: finished tracing spans ship in one body (each
    # entry needs trace_id/span_id/name; the handler skips malformed
    # entries instead of failing the batch).
    "span_batch": (("spans", list),),
    "metrics_report": (("pid", _NUM), ("rows", list)),
    "pg_ready": (("pg_id", _BYTES),),
    "read_log": (("path", str),),
    # Methods whose bodies carry no required fields still get a row: the
    # floor "body is a map" check applies, and rtlint RT003 treats a row
    # as the declaration that the method's wire shape is owned here.
    "worker_ready": (),
    "shutdown_cluster": (),
    "restore_object": (("object_id", _BYTES),),
    "get_log": (("proc_id", str),),
    "stack_dump": (("worker_id", str),),
    "stack_dump_reply": (("token", _NUM), ("dump", str)),
    # Flight recorder: batched engine step records (each entry needs
    # engine/step; the handler skips malformed entries like span_batch).
    "engine_step_batch": (("steps", list),),
    # Gang round flight recorder: batched per-rank training round records
    # (each entry needs gang/rank/round; malformed entries are skipped).
    "gang_round_batch": (("rounds", list),),
    # Device-memory accounting snapshot (util/devmem.py), shipped on the
    # worker's metrics cadence.
    "devmem_report": (("pid", _NUM), ("devmem", dict)),
    # On-demand profiler capture (stack_dump-shaped token round trip:
    # CLI -> head -> worker push -> profile_reply resolves the waiter).
    "profile": (("worker_id", str), ("seconds", _NUM)),
    "profile_reply": (("token", _NUM),),
    # -- dataplane: peer-to-peer calls + node-local task leases ---------------
    # resolve_actor is a pure read (idempotent) but keeps a row so the
    # address-resolution wire shape is owned here like every other method.
    "resolve_actor": (("actor_id", _BYTES),),
    "lease_request": (("resources", dict), ("count", _NUM)),
    "lease_return": (("lease_ids", list),),
    "lease_renew": (("lease_ids", list),),
    # Batched completion report for directly-executed tasks (telemetry +
    # task history; object registration rides the submitter's put batch).
    "direct_done": (("task_id", _BYTES),),
    # Worker-plane peer RPCs.  Their servers live in worker processes,
    # outside the head's _validated wrapper — the handlers validate these
    # rows in-handler, mirroring pull_object/read_log.
    "peer_submit": (("spec", dict), ("worker_id", _BYTES)),
    "peer_next_stream_item": (("task_id", _BYTES), ("index", _NUM),
                              ("worker_id", _BYTES)),
    "peer_cancel": (("task_id", _BYTES),),
}


class SchemaError(Exception):
    """Malformed control-plane message (missing/mistyped required field)."""


def validate(method: str, body: Any) -> None:
    """Raise SchemaError when ``body`` is missing required fields for
    ``method``.  Unknown methods and extra fields pass — the schema guards
    the floor, it does not freeze the ceiling (matching proto3's
    unknown-field tolerance)."""
    spec = REQUIRED.get(method)
    if spec is None:
        return
    if not isinstance(body, dict):
        raise SchemaError(
            f"{method}: body must be a map, got {type(body).__name__}"
        )
    for field, types in spec:
        if field not in body:
            raise SchemaError(f"{method}: missing required field {field!r}")
        if types is not None and not isinstance(body[field], types):
            tn = getattr(types, "__name__", None) or "/".join(
                t.__name__ for t in types
            )
            raise SchemaError(
                f"{method}: field {field!r} must be {tn}, got "
                f"{type(body[field]).__name__}"
            )


def check_protocol(peer_version: Any) -> None:
    """Reject peers speaking a different protocol revision."""
    if peer_version is None:
        # Pre-handshake tooling (old CLI builds): tolerate, the field
        # floor still validates individual messages.
        return
    if peer_version != PROTOCOL_VERSION:
        raise SchemaError(
            f"protocol version mismatch: peer speaks {peer_version}, this "
            f"head speaks {PROTOCOL_VERSION}; upgrade the older side"
        )
