"""PPO Learner: clip-objective minibatch SGD in PyTorch (port of
``ray_tpu/rllib/learner.py``).

Role-equivalent to the reference's Learner/TorchLearner
(reference: rllib/core/learner/learner.py:116 compute_gradients:448 /
apply_gradients:570; ppo_torch_learner computes the clip loss).  The
policy is an ``nn.Module`` of ``nn.Linear`` layers on the learner's device
(the card unless ``device="cpu"``); the rollout batch goes to the device
once per ``update_from_batch`` and minibatches are indexed there.  Under a
mesh each rank takes its rows of every minibatch and the gradients are
averaged over dp x fsdp before the clip (the gradient psum XLA inserts in
the JAX package's sharded update).

Also the pieces every learner of this package shares: optax's
``clip_by_global_norm`` rule, the Adam the learners step, the mesh's row
split and gradient mean, and the recompile sentinel's per-learner set of
seen minibatch signatures.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Hashable, List, Mapping, Sequence, Set

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..devtools import jitguard
from ..device import DeviceLike, resolve_device

#: The JAX ``PolicyParams`` fields, in order: a JAX tree (or the legacy flat
#: list of 12 arrays) maps onto the module by these names.
POLICY_FIELDS = ("pi_w1", "pi_b1", "pi_w2", "pi_b2", "pi_w3", "pi_b3",
                 "v_w1", "v_b1", "v_w2", "v_b2", "v_w3", "v_b3")


def _linear(d_in: int, d_out: int) -> nn.Linear:
    """An ``nn.Linear`` left uninitialised (its default init would draw from
    the global RNG; every caller sets the weights itself)."""
    return nn.utils.skip_init(nn.Linear, d_in, d_out)


def _orthogonal(layer: nn.Linear, gain: float, gen: torch.Generator):
    nn.init.orthogonal_(layer.weight, gain, generator=gen)
    nn.init.zeros_(layer.bias)


def _he_normal(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """JAX's ``he_normal``: a normal truncated at two standard deviations,
    scaled so the variance is 2 / fan_in."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class PolicyParams(nn.Module):
    """Separate actor and critic MLPs: with a shared torso, the unnormalized
    value loss (returns are O(episode length)) swamps the policy gradient
    (reference: rllib default models use separate value networks unless
    vf_share_layers is set).  ``pi[i]`` / ``v[i]`` hold the JAX tree's
    ``pi_w{i+1}`` transposed (``nn.Linear`` keeps ``[out, in]``) and
    ``pi_b{i+1}``."""

    def __init__(self, obs_size: int, num_actions: int, hidden: int = 64):
        super().__init__()
        self.pi = nn.ModuleList([_linear(obs_size, hidden),
                                 _linear(hidden, hidden),
                                 _linear(hidden, num_actions)])
        self.v = nn.ModuleList([_linear(obs_size, hidden),
                                _linear(hidden, hidden),
                                _linear(hidden, 1)])

    def forward(self, obs: torch.Tensor):
        return policy_forward(self, obs)


def init_policy(obs_size: int, num_actions: int, hidden: int = 64,
                seed: int = 0, device: DeviceLike = None) -> PolicyParams:
    """Orthogonal weights with the JAX package's gains (sqrt 2 for the
    torsos, 0.01 for the logits, 1.0 for the value) and zero biases, drawn
    on the CPU from a ``torch.Generator`` seeded with ``seed`` and then
    moved, so the same seed gives the same weights on every device.  Runs
    on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = PolicyParams(obs_size, num_actions, hidden)
    with torch.no_grad():
        for torso in (params.pi, params.v):
            _orthogonal(torso[0], math.sqrt(2), gen)
            _orthogonal(torso[1], math.sqrt(2), gen)
        _orthogonal(params.pi[2], 0.01, gen)
        _orthogonal(params.v[2], 1.0, gen)
    return params.to(dev)


def policy_forward(params: PolicyParams, obs: torch.Tensor):
    """Returns (logits, value)."""
    h = torch.tanh(params.pi[0](obs))
    h = torch.tanh(params.pi[1](h))
    logits = params.pi[2](h)
    hv = torch.tanh(params.v[0](obs))
    hv = torch.tanh(params.v[1](hv))
    value = params.v[2](hv)[..., 0]
    return logits, value


def _fields(tree, names: Sequence[str]) -> Dict[str, np.ndarray]:
    """A JAX NamedTuple (or the flat list of its fields) by field name."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    elif not isinstance(tree, Mapping):
        tree = dict(zip(names, tree))
    return {k: np.array(tree[k], np.float32) for k in names}


def _set_linear(layer: nn.Linear, w: np.ndarray, b: np.ndarray) -> None:
    """Copy a JAX ``[in, out]`` weight (transposed) and its bias."""
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
        layer.bias.copy_(torch.from_numpy(b))


def policy_params_from_jax(tree, device: DeviceLike = None) -> PolicyParams:
    """The port's ``PolicyParams`` holding a JAX ``PolicyParams`` of numpy
    arrays (``jax.tree.map(np.asarray, learner.params)``, or the flat list
    of its 12 fields), each ``[in, out]`` weight transposed."""
    f = _fields(tree, POLICY_FIELDS)
    obs_size, hidden = f["pi_w1"].shape
    params = PolicyParams(obs_size, f["pi_w3"].shape[1], hidden)
    for torso, p in ((params.pi, "pi"), (params.v, "v")):
        for i, layer in enumerate(torso):
            _set_linear(layer, f[f"{p}_w{i + 1}"], f[f"{p}_b{i + 1}"])
    return params.to(resolve_device(device))


def sample_categorical(logits, rng: np.random.Generator):
    """Gumbel-max action sampling on host + logp of the chosen actions —
    the shared per-step inference core of every env runner (numpy rng keeps
    rollouts reproducible, draw for draw the JAX package's, and avoids
    device PRNG churn per step).  The logsumexp runs in fp32, as
    ``jax.nn.logsumexp`` does on fp32 logits.

    Returns (actions [N] int32, logp [N] float32)."""
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().cpu().numpy()
    logits = np.asarray(logits, np.float32)
    gumbel = -np.log(-np.log(rng.random(logits.shape) + 1e-12) + 1e-12)
    actions = np.argmax(logits + gumbel, axis=-1).astype(np.int32)
    m = logits.max(axis=-1, keepdims=True)
    lse = np.log(np.exp(logits - m).sum(axis=-1, keepdims=True)) + m
    logp_all = logits - lse
    logp = np.take_along_axis(logp_all, actions[:, None], axis=1)[:, 0]
    return actions, logp


def compute_gae(rewards: np.ndarray, values: np.ndarray,
                bootstrap_values: np.ndarray, dones: np.ndarray,
                gamma: float, lam: float):
    """Generalized advantage estimation over [T, N] rollouts (reference:
    rllib postprocessing compute_gae_for_sample_batch).

    ``bootstrap_values[t]`` is V(s_{t+1}) with episode semantics applied:
    0 where terminated, V(true pre-reset next state) where truncated,
    V(next row) otherwise — so time-limit truncation doesn't bias values.
    ``dones`` (terminated|truncated) cuts the GAE recursion."""
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last_gae = np.zeros(N, np.float32)
    for t in range(T - 1, -1, -1):
        ended = dones[t].astype(np.float32)
        delta = rewards[t] + gamma * bootstrap_values[t] - values[t]
        last_gae = delta + gamma * lam * (1.0 - ended) * last_gae
        adv[t] = last_gae
    returns = adv + values
    return adv, returns


# ------------------------------------------------ shared by the learners


def make_adam(params, lr: float, eps: float,
              device: torch.device) -> torch.optim.Adam:
    """optax's ``adam`` (same moments, bias correction and eps placement).
    Fused on the card: one kernel steps every tensor, where the default
    foreach path launches a handful of kernels per op over the list.  On
    the CPU, torch's default (the single-tensor loop)."""
    return torch.optim.Adam(params, lr=lr, eps=eps,
                            fused=device.type == "cuda")


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: the gradients as they are
    when their global norm is below ``max_norm``, else g / norm * max_norm
    (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6 instead).
    Returns the norm, on the device: no host sync."""
    norm = torch.nn.utils.get_total_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def mesh_shard(mesh, batch: Dict[str, torch.Tensor],
               dim: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's block of every tensor of ``batch`` along ``dim``, split
    over dp x fsdp in rank order (JAX's ``P(("dp", "fsdp"))``).  A size that
    does not divide raises ``ValueError``, as placing the JAX batch on its
    sharding does."""
    from ..collective.mesh_ops import axis_index, axis_size

    axes = ("dp", "fsdp")
    k = axis_size(axes, mesh=mesh)
    i = axis_index(axes, mesh=mesh)
    n = next(iter(batch.values())).shape[dim]
    if n % k:
        raise ValueError(f"a batch of {n} along dim {dim} does not divide "
                         f"over dp x fsdp = {k} ranks")
    m = n // k
    return {key: v.narrow(dim, i * m, m) for key, v in batch.items()}


def mesh_mean_(mesh, tensors: List[torch.Tensor]) -> None:
    """Average ``tensors`` in place over dp x fsdp in one collective (the
    gradients of a loss that is a mean over equal blocks of the batch, and
    that loss's metrics)."""
    from ..collective.mesh_ops import allreduce

    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = allreduce(flat, ("dp", "fsdp"), "mean", mesh=mesh)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


class Program:
    """One learner's update program for the recompile sentinel: a new
    minibatch signature (the tensors' shapes, dtypes and devices, what a
    jit cache keys on) bumps ``jitguard``'s count for ``name`` once; a
    signature already seen does not, as a jitted function does not retrace
    on one.  Each learner keeps its own set, as each JAX learner has its
    own jit cache; constructing one re-registers the program, which stands
    an armed baseline down (a new learner compiles legitimately)."""

    def __init__(self, name: str):
        self.name = name
        self._seen: Set[Hashable] = set()
        jitguard.register_program(name)

    def __call__(self, batch: Mapping[str, torch.Tensor]) -> None:
        sig = jitguard.signature_of(dict(batch))
        key = tuple(sig.items())
        if key in self._seen:
            return
        # stacklevel 4: the caller of the learner's public update.  When
        # the armed sentinel raises the signature is not kept, so the next
        # call raises again, as a jit trace that failed is traced again.
        jitguard.bump(self.name, sig, stacklevel=4)
        self._seen.add(key)


def set_grads(params: Sequence[nn.Parameter],
              grads: Sequence[torch.Tensor]) -> None:
    """Hand ``grads`` to the optimizer, each in its parameter's strides:
    cuDNN returns a convolution's weight gradient in the channels-last
    layout of a channels-last input, and the fused Adam steps only tensors
    of one layout.  ``None`` (a parameter the loss does not use) leaves
    the parameter as Adam finds it."""
    for p, g in zip(params, grads):
        if g is not None and g.stride() != p.stride():
            g = torch.empty_like(p).copy_(g)
        p.grad = g


def sgd_step(params: nn.Module, opt: torch.optim.Optimizer,
             loss: torch.Tensor, aux: Dict[str, torch.Tensor],
             grad_clip: float, mesh=None) -> Dict[str, torch.Tensor]:
    """One step on ``loss``: its gradients (averaged over the mesh's dp x
    fsdp together with ``aux``, one collective), optax's global-norm clip,
    then the optimizer.  Returns ``aux`` detached, on the device."""
    ps = list(params.parameters())
    grads = list(torch.autograd.grad(loss, ps))
    aux = {k: v.detach() for k, v in aux.items()}
    if mesh is not None:
        mesh_mean_(mesh, grads + list(aux.values()))
    clip_by_global_norm_(grads, grad_clip)
    set_grads(ps, grads)
    opt.step()
    return aux


def host_floats(aux: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The 0-d device tensors of ``aux`` as floats, in one copy to the
    host."""
    vals = torch.stack([v.float() for v in aux.values()]).tolist()
    return dict(zip(aux, vals))


def to_device(batch: Mapping[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def params_state(params: nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of ``params``' state on its device: what
    ``get_weights`` returns and ``set_weights`` takes back."""
    return {k: v.detach().clone() for k, v in params.state_dict().items()}


def is_state(weights) -> bool:
    """Whether ``weights`` is a state dict of the port's (and not a JAX
    tree of numpy arrays)."""
    return (isinstance(weights, Mapping) and bool(weights)
            and all(isinstance(v, torch.Tensor) for v in weights.values()))


def ppo_loss(model, params: nn.Module, batch: Mapping[str, torch.Tensor],
             clip: float, vf_c: float, ent_c: float):
    """The clip objective: (total, {policy_loss, vf_loss, entropy})."""
    logits, value = model.apply(params, batch["obs"])
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["advantages"]
    pg = -torch.minimum(ratio * adv,
                        torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
    vf = 0.5 * torch.mean((value - batch["returns"]) ** 2)
    entropy = -torch.mean(torch.sum(F.softmax(logits, dim=-1) * logp_all,
                                    dim=-1))
    total = pg + vf_c * vf - ent_c * entropy
    return total, {"policy_loss": pg, "vf_loss": vf, "entropy": entropy}


class PPOLearner:
    """Holds params + optimizer state; ``update_from_batch`` runs
    clipped-PPO epochs on the learner's device (the card unless
    ``device="cpu"``)."""

    def __init__(
        self,
        obs_size: int,
        num_actions: int,
        *,
        lr: float = 3e-4,
        clip_param: float = 0.2,
        vf_coeff: float = 0.5,
        entropy_coeff: float = 0.01,
        grad_clip: float = 0.5,
        hidden: int = 64,
        seed: int = 0,
        mesh=None,
        model=None,
        device: DeviceLike = None,
    ):
        # Pluggable architecture (reference: rl_module.py — the learner is
        # model-agnostic).  Default = the classic separate-torso MLP; pass a
        # models.CNNModel for image observations.
        if model is None:
            from .models import MLPModel

            model = MLPModel((obs_size,), num_actions, hidden)
        self.device = resolve_device(device)
        self.model = model
        self.params = model.init(seed, device=self.device)
        self.opt = make_adam(self.params.parameters(), lr, 1e-5, self.device)
        self.clip_param = clip_param
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.grad_clip = grad_clip
        self.mesh = mesh
        self._program = Program("ppo_update")
        #: The last ``update_from_batch``'s host-to-device copy of the
        #: rollout batch: bytes, and host seconds (a pageable copy returns
        #: once its data is staged).
        self.last_copy = {"bytes": 0, "seconds": 0.0}

    def _update(self, mb: Dict[str, torch.Tensor]):
        """One minibatch step on device tensors; aux stays on the device."""
        self._program(mb)
        if self.mesh is not None:
            mb = mesh_shard(self.mesh, mb)
        total, aux = ppo_loss(self.model, self.params, mb, self.clip_param,
                              self.vf_coeff, self.entropy_coeff)
        aux["total_loss"] = total
        return sgd_step(self.params, self.opt, total, aux, self.grad_clip,
                        self.mesh)

    # -- API ----------------------------------------------------------------

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return params_state(self.params)

    def set_weights(self, weights) -> None:
        """The port's ``get_weights`` state, or a JAX tree of numpy arrays
        (the model's ``from_jax`` layout)."""
        if not is_state(weights):
            weights = self.model.from_jax(weights, device="cpu").state_dict()
        self.params.load_state_dict(weights)

    def update_from_batch(
        self,
        batch: Dict[str, np.ndarray],
        *,
        num_epochs: int = 10,
        minibatch_size: int = 128,
        seed: int = 0,
    ) -> Dict[str, float]:
        """Minibatch SGD over the rollout batch (reference:
        learner.py:922 update_from_batch minibatch loop): the advantages
        normalised once on the host, the batch copied to the device once,
        the JAX package's minibatch order (``default_rng(seed)``
        permutations, a ragged tail dropped), one host sync at the end."""
        n = len(batch["obs"])
        adv = batch["advantages"]
        batch = dict(batch)
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        t0 = time.perf_counter()
        dev = to_device(batch, self.device)
        self.last_copy = {
            "bytes": sum(v.numel() * v.element_size() for v in dev.values()),
            "seconds": time.perf_counter() - t0}
        rng = np.random.default_rng(seed)
        last_aux = None
        for _ in range(num_epochs):
            order = torch.from_numpy(rng.permutation(n)).to(self.device)
            for start in range(0, n, minibatch_size):
                idx = order[start:start + minibatch_size]
                if len(idx) < minibatch_size and start > 0:
                    break  # drop ragged tail (keeps minibatch shapes static)
                last_aux = self._update({k: v[idx] for k, v in dev.items()})
        # ONE host sync, after the epochs: reading aux inside the minibatch
        # loop would wait on the device every step.
        return {} if last_aux is None else host_floats(last_aux)
