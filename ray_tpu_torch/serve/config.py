"""Declarative Serve config: deploy applications from a dict or a JSON
file (port of ``ray_tpu/serve/config.py``; the JAX module also reads YAML
files through PyYAML, which the port does not import: JSON is YAML too, so
a JSON file serves both).

Role-equivalent to the reference's Serve schema + `serve deploy`
(reference: serve/schema.py ServeDeploySchema, scripts `serve deploy` /
`serve status` — the K8s-friendly declarative path where a config file,
not a driver script, is the source of truth).

Config shape::

    applications:
      - name: summarizer                 # serve.run name override
        import_path: my_pkg.app:app      # module:attr -> Application
                                         #   (or Deployment, auto-bound)
        args: {model: "t5-small"}        # bind(**args) when attr is a
                                         #   Deployment
        deployments:                     # per-deployment option overrides
          - name: Summarizer
            num_replicas: 3
            max_concurrent_queries: 16

Apply with :func:`deploy` (exported as ``serve.deploy_config``).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

from .api import Application, Deployment, run


def _load_import_path(path: str):
    mod_name, _, attr = path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path {path!r} must be '<module>:<attribute>'"
        )
    mod = importlib.import_module(mod_name)
    obj = mod
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _apply_overrides(app: Application,
                     overrides: List[Dict[str, Any]]) -> Application:
    """Rebuild the bound graph with per-deployment option overrides applied
    by deployment name (reference: deployments section of the schema
    overrides the code's defaults).  Rebuilding memoizes by node identity
    so serve.run's diamond dedup still sees one shared child as one node;
    override names that match no deployment raise (a YAML typo must not
    silently deploy defaults)."""
    by_name = {o["name"]: {k: v for k, v in o.items() if k != "name"}
               for o in overrides}
    consumed: set = set()
    memo: Dict[int, Application] = {}

    def rebuild(a: Application) -> Application:
        if id(a) in memo:
            return memo[id(a)]
        dep = a.deployment
        opts = by_name.get(dep.name)
        if opts is not None:
            consumed.add(dep.name)
            dep = dep.options(**opts)
        args = tuple(rebuild(x) if isinstance(x, Application) else x
                     for x in a.init_args)
        kwargs = {k: rebuild(v) if isinstance(v, Application) else v
                  for k, v in a.init_kwargs.items()}
        out = Application(dep, args, kwargs)
        memo[id(a)] = out
        return out

    rebuilt = rebuild(app)
    unknown = set(by_name) - consumed
    if unknown:
        raise ValueError(
            f"deployment overrides match nothing in the app graph: "
            f"{sorted(unknown)}"
        )
    return rebuilt


def deploy(config: Dict[str, Any] | str, *, wait_ready: bool = True) -> list:
    """Deploy every application in a config dict or JSON file path.
    Returns the ingress handles in config order."""
    if isinstance(config, str):
        import json

        with open(config) as f:
            config = json.load(f)
    handles = []
    for app_cfg in config.get("applications", []):
        target = _load_import_path(app_cfg["import_path"])
        if isinstance(target, Deployment):
            target = target.bind(**(app_cfg.get("args") or {}))
        if not isinstance(target, Application):
            raise TypeError(
                f"import_path {app_cfg['import_path']!r} resolved to "
                f"{type(target).__name__}; expected a bound Application or "
                "a Deployment"
            )
        target = _apply_overrides(target, app_cfg.get("deployments") or [])
        handles.append(run(
            target, name=app_cfg.get("name"), wait_ready=wait_ready,
        ))
    return handles
