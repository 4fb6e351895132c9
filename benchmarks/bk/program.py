"""The system under test: the port's model classes that the cell's family
names (``families/<family>.py``: ``PROGRAM``, ``port_keys``), built at
the configuration file's sizes and filled with the benchmark's seed-made
weights.  The only module of the harness that imports the program's model
entry points.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from reference.weights import DTYPES, global_weights, layer_weights


def _classes(family):
    """The port's (config class, model class) that the family names."""
    module, config_cls, model_cls = family.PROGRAM
    mod = importlib.import_module(module)
    return getattr(mod, config_cls), getattr(mod, model_cls)


def port_config(family, config: Dict) -> Any:
    """The family's config class, from the configuration's ``port`` keys,
    in the served dtype."""
    return _classes(family)[0](**family.port_keys(config["port"]),
                               dtype=DTYPES[config["dtype"]])


@torch.no_grad()
def build_model(family, config: Dict, seed: int, device):
    """The program's model module on ``device`` with the seed's weights
    (each group drawn once, copied into the parameters of that name)."""
    model = _classes(family)[1](port_config(family, config), device)
    params = dict(model.named_parameters())
    filled = set()
    for name, t in global_weights(family, config, seed, device).items():
        params[name].copy_(t)
        filled.add(name)
    for i in range(family.n_layers(config["port"])):
        for name, t in layer_weights(family, config, seed, i,
                                     device).items():
            params[f"layers.{i}.{name}"].copy_(t)
            filled.add(f"layers.{i}.{name}")
    if filled != set(params):
        raise ValueError(f"weights made for {sorted(filled ^ set(params))}"
                         " do not match the program's parameters")
    return model.requires_grad_(False)
