"""Small MLP for the MNIST parity smoke test (port of
``ray_tpu/models/mlp.py``): ReLU hidden layers and a softmax cross-entropy
loss over class logits.

Parameters keep the JAX tree's names and ``[d_in, d_out]`` layout
(``layers.0.w`` is ``params["layers"][0]["w"]``), so ``mlp_params_from_jax``
copies arrays as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .llama import _generator, _load_tree, _normal_, _param


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: int = 256
    n_hidden: int = 2
    out_dim: int = 10
    dtype: torch.dtype = torch.float32


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device)


class MLPModel(nn.Module):
    """Weights of one MLP.  ``forward(x)`` is ``mlp_apply``."""

    def __init__(self, config: MLPConfig, device: torch.device):
        super().__init__()
        self.config = config
        dims = ([config.in_dim] + [config.hidden] * config.n_hidden
                + [config.out_dim])
        self.layers = nn.ModuleList(
            Dense(a, b, config.dtype, device)
            for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.config, self, x)


@torch.no_grad()
def mlp_init(config: MLPConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None, *, trainable: bool = False
             ) -> MLPModel:
    """He-normal weights (N(0, 2 / d_in)) and zero biases, as the JAX
    package draws them, from ``generator`` (seed 0 when omitted, on the
    target device).  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    generator = _generator(generator, dev)
    model = MLPModel(config, dev)
    for layer in model.layers:
        _normal_(layer.w, (2.0 / layer.w.shape[0]) ** 0.5, generator)
        layer.b.zero_()
    return model.requires_grad_(trainable)


@torch.no_grad()
def mlp_params_from_jax(config: MLPConfig, np_tree: Mapping[str, Any],
                        device: DeviceLike = None, *,
                        trainable: bool = False) -> MLPModel:
    """The port's MLP from ``jax.tree.map(np.asarray, params)`` of the JAX
    package's ``mlp_init``."""
    if len(np_tree["layers"]) != config.n_hidden + 1:
        raise ValueError(f"{len(np_tree['layers'])} layers for a config "
                         f"with {config.n_hidden} hidden layers")
    model = MLPModel(config, resolve_device(device))
    _load_tree(model, np_tree)
    return model.requires_grad_(trainable)


def mlp_apply(config: MLPConfig, params: MLPModel,
              x: torch.Tensor) -> torch.Tensor:
    """fp32 logits [N, out_dim] for inputs [N, in_dim]."""
    h = x.to(config.dtype)
    last = len(params.layers) - 1
    for i, layer in enumerate(params.layers):
        h = h @ layer.w + layer.b
        if i < last:
            h = torch.relu(h)
    return h.float()


def mlp_loss(config: MLPConfig, params: MLPModel, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy of int labels ``y`` [N]."""
    logits = mlp_apply(config, params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y[:, None].long())[:, 0]
    return (logz - gold).mean()
