"""The system under test: the port's model classes, built at a
configuration file's sizes and filled with the benchmark's seed-made
weights.  The only module of the harness that names the program's model
entry points; every family a configuration can name is listed here.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from reference.weights import DTYPES, global_weights, layer_weights

#: family -> (module, config class, model class)
FAMILIES = {
    "dense": ("ray_tpu_torch.models.llama", "LlamaConfig", "Llama"),
}


def _module(config: Dict):
    import importlib

    return importlib.import_module(FAMILIES[config["family"]][0])


def port_config(config: Dict) -> Any:
    """The family's config class (``LlamaConfig(**port)``) in the served
    dtype."""
    name = FAMILIES[config["family"]][1]
    return getattr(_module(config), name)(
        **config["port"], dtype=DTYPES[config["dtype"]])


@torch.no_grad()
def build_model(config: Dict, seed: int, device):
    """The program's model module on ``device`` with the seed's weights
    (each group drawn once, copied into the parameters of that name)."""
    cfg = port_config(config)
    cls = getattr(_module(config), FAMILIES[config["family"]][2])
    model = cls(cfg, device)
    params = dict(model.named_parameters())
    filled = set()
    for name, t in global_weights(config, seed, device).items():
        params[name].copy_(t)
        filled.add(name)
    for i in range(config["port"]["n_layers"]):
        for name, t in layer_weights(config, seed, i, device).items():
            params[f"layers.{i}.{name}"].copy_(t)
            filled.add(f"layers.{i}.{name}")
    if filled != set(params):
        raise ValueError(f"weights made for {sorted(filled ^ set(params))}"
                         " do not match the program's parameters")
    return model.requires_grad_(False)
