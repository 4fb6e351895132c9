"""RT001/RT002: the event-loop safety rules.

The head is ONE asyncio loop owning all control-plane state ("handlers
never block" — core/head.py's contract).  A single synchronous
``time.sleep``/socket read/RPC round-trip inside an ``async def`` stalls
every connected client; a ``threading`` lock held across an ``await``
can deadlock against the executor threads that legitimately take it.
"""

from __future__ import annotations

import ast
from typing import List

from .astutil import (call_name, contains_await, dotted_name, is_awaited,
                      iter_functions, parent_map, walk_own_body)
from .rtlint import Finding, Project

#: exact dotted calls that block the calling thread.
BLOCKING_CALLS = {
    "time.sleep",
    "os.system",
    "os.waitpid",
    "os.replace",
    "socket.create_connection",
    "shutil.rmtree",
    "glob.glob",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.getoutput",
}
#: method names that block regardless of receiver (sockets, pipes, procs).
BLOCKING_METHODS = {
    "recv", "recv_into", "recvfrom", "sendall", "accept", "communicate",
}
#: file-read methods — flagged only when NOT awaited (``await reader.read``
#: on an asyncio stream is the non-blocking form).
FILE_METHODS = {"read", "readline", "readlines"}
#: receivers whose synchronous ``.call(...)`` is a blocking RPC round-trip
#: (RpcClient.call parks the calling thread on a concurrent future).
SYNC_RPC_RECEIVERS = {"rpc", "head", "client", "cl"}


def _async_calls(module):
    parents = parent_map(module.tree)
    for fn in iter_functions(module.tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        for node in walk_own_body(fn):
            if isinstance(node, ast.Call):
                yield fn, node, parents


def check_rt001(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for module in project.modules:
        for fn, call, parents in _async_calls(module):
            if is_awaited(call, parents):
                continue
            name = call_name(call)
            if name is None:
                continue
            last = name.rsplit(".", 1)[-1]
            msg = None
            if name in BLOCKING_CALLS or name.startswith("subprocess."):
                msg = f"blocking {name}()"
            elif name == "open":
                msg = "blocking open() (file I/O)"
            elif "." in name and last in BLOCKING_METHODS:
                msg = f"blocking .{last}() on {name.rsplit('.', 1)[0]}"
            elif "." in name and last in FILE_METHODS \
                    and isinstance(call.func.value, ast.Name):
                msg = f"blocking .{last}() on {name.rsplit('.', 1)[0]}"
            elif last == "call" and "." in name:
                receiver = name.rsplit(".", 1)[0].rsplit(".", 1)[-1]
                if receiver in SYNC_RPC_RECEIVERS:
                    msg = f"synchronous RPC {name}()"
            if msg:
                out.append(Finding(
                    "RT001", module.rel, call.lineno,
                    f"{msg} inside async def {fn.name} stalls the event "
                    "loop — move it to run_in_executor or an async API",
                ))
    return out


def _lockish(expr: ast.AST) -> bool:
    name = dotted_name(expr)
    if name is None:
        return False
    last = name.rsplit(".", 1)[-1].lower()
    return "lock" in last or "mutex" in last


def check_rt002(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for module in project.modules:
        for fn in iter_functions(module.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in walk_own_body(fn):
                if not isinstance(node, ast.With):
                    continue
                held = [
                    dotted_name(item.context_expr)
                    for item in node.items
                    if _lockish(item.context_expr)
                ]
                if held and contains_await(node):
                    out.append(Finding(
                        "RT002", module.rel, node.lineno,
                        f"lock {held[0]} held across an await in async def "
                        f"{fn.name} — the loop parks while every thread "
                        "contending the lock deadlocks behind it; shrink "
                        "the critical section to exclude the await",
                    ))
    return out
