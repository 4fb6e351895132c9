"""Policy model catalog: pluggable network architectures for the learners
(port of ``ray_tpu/rllib/models.py``).

Role-equivalent to the reference's RLModule / model catalog layer
(reference: rllib/core/rl_module/rl_module.py, rllib/models/catalog.py —
the algorithm is architecture-agnostic; obs space picks the default net,
conv nets for image observations per models/utils.py get_filter_config).

A model is a picklable description with:
    init(seed, device) -> params (an ``nn.Module`` on ``device``)
    apply(params, obs) -> (logits, value)
    from_jax(tree, device) -> params holding a JAX ``init`` tree's arrays
Learners and env runners only touch this surface, so MLP vs CNN (or a
custom user model) is a config swap, not a learner change.

Layout: observations arrive NHWC, as in the JAX package.  The CNN
convolves NCHW with OIHW kernels (cuDNN's layout; the NHWC batch permuted
to NCHW is a channels-last view, which cuDNN takes as it is) and flattens
(c, h, w); the JAX model flattens NHWC in (h, w, c) order, so
``cnn_params_from_jax`` permutes ``dense_w``'s rows to match.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from .learner import (_he_normal, _linear, _orthogonal, _set_linear,
                      init_policy, policy_forward, policy_params_from_jax)


class MLPModel:
    """Separate-torso tanh MLP — the classic-control default (same
    architecture the PPO/IMPALA learners always used; reference: rllib
    default fcnet with vf_share_layers=False)."""

    def __init__(self, obs_shape: Tuple[int, ...], num_actions: int,
                 hidden: int = 64):
        self.obs_shape = tuple(obs_shape)
        self.obs_size = int(np.prod(obs_shape))
        self.num_actions = num_actions
        self.hidden = hidden

    def init(self, seed: int = 0, device: DeviceLike = None):
        return init_policy(self.obs_size, self.num_actions, self.hidden,
                           seed, device)

    def apply(self, params, obs: torch.Tensor):
        if obs.ndim > 2:
            obs = obs.reshape(obs.shape[0], -1)
        return policy_forward(params, obs)

    def from_jax(self, tree, device: DeviceLike = None):
        return policy_params_from_jax(tree, device)


class CNNParams(nn.Module):
    """``conv[i]`` (``nn.Conv2d``, VALID, stride s_i), then ``dense`` over
    the (c, h, w)-flattened map and the ``pi`` / ``v`` heads."""

    def __init__(self, model: "CNNModel"):
        super().__init__()
        c_in = model.obs_shape[-1]
        convs = []
        for c_out, k, s in zip(model.channels, model.kernels, model.strides):
            convs.append(nn.utils.skip_init(nn.Conv2d, c_in, c_out, k,
                                            stride=s))
            c_in = c_out
        self.conv = nn.ModuleList(convs)
        h, w = model._conv_out_hw()
        self.dense = _linear(h * w * c_in, model.dense)
        self.pi = _linear(model.dense, model.num_actions)
        self.v = _linear(model.dense, 1)


class CNNModel:
    """Conv torso + dense policy/value heads for image observations
    (reference: rllib models/utils.py get_filter_config — conv stacks are
    the default for 2D/3D obs; benchmark_atari_ppo.py trains them at scale).
    Observations are (H, W, C) images, as in the JAX package."""

    def __init__(self, obs_shape: Tuple[int, ...], num_actions: int,
                 channels: Sequence[int] = (16, 32),
                 kernels: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1),
                 dense: int = 128):
        if len(obs_shape) == 2:
            obs_shape = (*obs_shape, 1)  # H,W -> H,W,1
        if len(obs_shape) != 3:
            raise ValueError(f"CNNModel wants (H, W, C), got {obs_shape}")
        if not len(channels) == len(kernels) == len(strides):
            raise ValueError("channels, kernels and strides differ in "
                             "length")
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.channels = tuple(channels)
        self.kernels = tuple(kernels)
        self.strides = tuple(strides)
        self.dense = dense

    def _conv_out_hw(self) -> Tuple[int, int]:
        h, w, _ = self.obs_shape
        for k, s in zip(self.kernels, self.strides):
            h = -(-(h - k + 1) // s)  # VALID conv then ceil-div stride
            w = -(-(w - k + 1) // s)
        if h <= 0 or w <= 0:
            raise ValueError("conv stack consumed the whole image")
        return h, w

    def init(self, seed: int = 0, device: DeviceLike = None) -> CNNParams:
        """He-normal convolutions and dense layer, orthogonal heads (0.01
        and 1.0), zero biases, as the JAX package draws them; drawn on the
        CPU from a ``torch.Generator`` seeded with ``seed``, then moved."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = CNNParams(self)
        with torch.no_grad():
            for conv in params.conv:
                _he_normal(conv.weight, conv.weight[0].numel(), gen)
                nn.init.zeros_(conv.bias)
            _he_normal(params.dense.weight, params.dense.in_features, gen)
            nn.init.zeros_(params.dense.bias)
            _orthogonal(params.pi, 0.01, gen)
            _orthogonal(params.v, 1.0, gen)
        return params.to(dev)

    def apply(self, params: CNNParams, obs: torch.Tensor):
        x = obs.float()
        if x.ndim == 3:  # missing channel dim: B,H,W -> B,H,W,1
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, channels-last strides
        for conv in params.conv:
            x = F.relu(conv(x))
        h = F.relu(params.dense(x.flatten(1)))
        logits = params.pi(h)
        value = params.v(h)[..., 0]
        return logits, value

    def from_jax(self, tree, device: DeviceLike = None) -> CNNParams:
        return cnn_params_from_jax(self, tree, device)


def cnn_params_from_jax(model: CNNModel, tree: Dict[str, Any],
                        device: DeviceLike = None) -> CNNParams:
    """The port's ``CNNParams`` holding a JAX ``CNNModel.init`` tree of
    numpy arrays: HWIO kernels to OIHW, ``[in, out]`` weights transposed,
    and ``dense_w``'s rows, which the JAX model indexes in (h, w, c) order,
    reordered to the (c, h, w) order of an NCHW flatten."""
    t = {k: np.array(v, np.float32) for k, v in tree.items()}
    params = CNNParams(model)
    with torch.no_grad():
        for i, conv in enumerate(params.conv):
            conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                t[f"conv{i}_w"].transpose(3, 2, 0, 1))))
            conv.bias.copy_(torch.from_numpy(t[f"conv{i}_b"]))
        h, w = model._conv_out_hw()
        c = model.channels[-1]
        dense_w = t["dense_w"].reshape(h, w, c, -1).transpose(2, 0, 1, 3)
        _set_linear(params.dense, dense_w.reshape(c * h * w, -1),
                    t["dense_b"])
        _set_linear(params.pi, t["pi_w"], t["pi_b"])
        _set_linear(params.v, t["v_w"], t["v_b"])
    return params.to(resolve_device(device))


def default_model(obs_shape: Tuple[int, ...], num_actions: int,
                  hidden: int = 64):
    """Obs-shape dispatch (reference: catalog.py _get_encoder_config —
    1D obs -> MLP, 2D/3D obs -> conv stack)."""
    if len(obs_shape) >= 2:
        return CNNModel(obs_shape, num_actions)
    return MLPModel(obs_shape, num_actions, hidden)
