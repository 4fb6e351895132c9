"""Search spaces + variant generation.

Role-equivalent to the reference's tune search-space API and
BasicVariantGenerator (reference: python/ray/tune/search/sample.py —
grid_search/choice/uniform/randint; search/basic_variant.py — grid
cross-product x num_samples random sampling).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Sequence


class Domain:
    """A sampled hyperparameter dimension."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.uniform(self.lower, self.upper)


class LogUniform(Domain):
    def __init__(self, lower: float, upper: float):
        import math

        self.log_lower, self.log_upper = math.log(lower), math.log(upper)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.log_lower, self.log_upper))


class RandInt(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng):
        return self.fn()


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Uniform:
    return Uniform(lower, upper)


def loguniform(lower: float, upper: float) -> LogUniform:
    return LogUniform(lower, upper)


def randint(lower: int, upper: int) -> RandInt:
    return RandInt(lower, upper)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> Dict[str, Any]:
    """Marker for exhaustive expansion (one trial per value, crossed with
    every other grid dimension; reference: tune/search/sample.py grid_search)."""
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def _collect_grids(space: Dict[str, Any], path=()) -> List[tuple]:
    """All grid_search dimensions in a (possibly nested) space as
    (key-path, values) pairs."""
    out = []
    for k, v in space.items():
        if _is_grid(v):
            out.append((path + (k,), v["grid_search"]))
        elif isinstance(v, dict):
            out.extend(_collect_grids(v, path + (k,)))
    return out


def _resolve(space: Dict[str, Any], grid_assign: Dict[tuple, Any],
             rng: random.Random, path=()) -> Dict[str, Any]:
    cfg: Dict[str, Any] = {}
    for k, v in space.items():
        p = path + (k,)
        if _is_grid(v):
            cfg[k] = grid_assign[p]
        elif isinstance(v, Domain):
            cfg[k] = v.sample(rng)
        elif isinstance(v, dict):
            cfg[k] = _resolve(v, grid_assign, rng, p)
        else:
            cfg[k] = v
    return cfg


def generate_variants(
    param_space: Dict[str, Any],
    num_samples: int = 1,
    seed: int = 0,
) -> List[Dict[str, Any]]:
    """Expand a param space into concrete trial configs: the cross-product
    of all grid dimensions (nested dicts included), repeated num_samples
    times with random dimensions re-sampled each repeat
    (reference: basic_variant.py)."""
    rng = random.Random(seed)
    grids = _collect_grids(param_space)
    grid_paths = [p for p, _ in grids]
    grid_values = [vals for _, vals in grids]
    variants: List[Dict[str, Any]] = []
    for _ in range(max(1, num_samples)):
        for combo in itertools.product(*grid_values) if grids else [()]:
            assign = dict(zip(grid_paths, combo))
            variants.append(_resolve(param_space, assign, rng))
    return variants


# ------------------------------------------------------- incremental search


class Searcher:
    """Suggest-based search algorithm (reference: tune/search/searcher.py
    Searcher — suggest/on_trial_complete).  Unlike `generate_variants`'
    eager expansion, a Searcher produces configs one at a time so it can
    condition later suggestions on earlier results."""

    def suggest(self, trial_id: str) -> Dict[str, Any] | None:
        """The next config to try, or None to signal 'nothing right now'
        (the Tuner retries later)."""
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Dict[str, Any] | None = None) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Adapts the eager variant expansion to the Searcher protocol
    (reference: tune/search/basic_variant.py BasicVariantGenerator)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: int = 0):
        self._variants = generate_variants(param_space, num_samples, seed)
        self._next = 0

    def suggest(self, trial_id: str):
        if self._next >= len(self._variants):
            return None
        cfg = self._variants[self._next]
        self._next += 1
        return cfg

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self._variants)


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions from the wrapped searcher (reference:
    tune/search/concurrency_limiter.py ConcurrencyLimiter) — needed when a
    conditioned searcher degrades to random sampling if too many trials run
    before any results arrive."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        assert max_concurrent >= 1
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_complete(self, trial_id: str, result=None):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result)


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator search (Bergstra et al. 2011 —
    the algorithm behind HyperOpt; reference: tune/search/hyperopt/
    hyperopt_search.py wraps the same method).  Native implementation over
    this module's Domain types, so no external dependency.

    After ``n_initial`` random trials, completed observations split at the
    ``gamma`` quantile into good/bad sets; per dimension, candidates drawn
    from a kernel density around the GOOD observations are ranked by the
    density ratio l(x)/g(x) and the best of ``n_candidates`` is suggested
    — search concentrates where good results cluster while the bad-set
    density keeps it exploring."""

    def __init__(self, param_space: Dict[str, Any], *, metric: str,
                 mode: str = "min", n_initial: int = 8,
                 gamma: float = 0.25, n_candidates: int = 24,
                 seed: int = 0):
        assert mode in ("min", "max")
        import numpy as np

        self.space = dict(param_space)
        self.metric = metric
        self.mode = mode
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.py_rng = random.Random(seed)      # Domain.sample's rng type
        self.rng = np.random.default_rng(seed)  # KDE math
        self._np = np
        self._suggested: Dict[str, Dict[str, Any]] = {}
        self._history: list = []  # (config, score)
        for key, dom in self.space.items():
            if not isinstance(dom, (Categorical, Uniform, LogUniform,
                                    RandInt)):
                raise TypeError(
                    f"TPESearcher supports Categorical/Uniform/LogUniform/"
                    f"RandInt domains; {key!r} is {type(dom).__name__}")

    # -- sampling helpers ----------------------------------------------------

    def _random_config(self) -> Dict[str, Any]:
        return {k: d.sample(self.py_rng) for k, d in self.space.items()}

    def _bounds(self, dom):
        """Numeric-space (lo, hi) for a dimension."""
        if isinstance(dom, LogUniform):
            return dom.log_lower, dom.log_upper
        if isinstance(dom, RandInt):
            return float(dom.lower), float(dom.upper - 1)
        return float(dom.lower), float(dom.upper)

    def _numeric_repr(self, dom, value):
        if isinstance(dom, LogUniform):
            return float(self._np.log(value))
        return float(value)

    def _from_numeric(self, dom, x):
        np = self._np
        lo, hi = self._bounds(dom)
        x = float(np.clip(x, lo, hi))
        if isinstance(dom, LogUniform):
            return float(np.exp(x))
        if isinstance(dom, RandInt):
            return int(round(x))
        return x

    def _propose_dim(self, dom, good, bad):
        """Best-of-candidates by the l/g density ratio for one dimension."""
        np = self._np
        if isinstance(dom, Categorical):
            cats = list(dom.categories)

            def weights(obs):
                w = np.ones(len(cats))  # +1 smoothing
                for v in obs:
                    w[cats.index(v)] += 1
                return w / w.sum()

            wl, wg = weights(good), weights(bad)
            idx = self.rng.choice(len(cats), size=self.n_candidates, p=wl)
            best = idx[int(np.argmax(wl[idx] / wg[idx]))]
            return cats[int(best)]
        g = np.array([self._numeric_repr(dom, v) for v in good])
        b = np.array([self._numeric_repr(dom, v) for v in bad])
        lo, hi = self._bounds(dom)
        span = max(hi - lo, 1e-12)
        bw_g = max(span / max(len(g), 1), span * 0.05)
        bw_b = max(span / max(len(b), 1), span * 0.05)

        def density(x, pts, bw):
            if len(pts) == 0:
                return np.full_like(x, 1.0 / span)
            d = (x[:, None] - pts[None, :]) / bw
            return np.exp(-0.5 * d * d).sum(axis=1) / (len(pts) * bw) \
                + 1e-12

        centers = self.rng.choice(g, size=self.n_candidates)
        cand = np.clip(centers + self.rng.normal(0, bw_g,
                                                 self.n_candidates),
                       lo, hi)
        ratio = density(cand, g, bw_g) / density(cand, b, bw_b)
        return self._from_numeric(dom, float(cand[int(np.argmax(ratio))]))

    # -- Searcher protocol ---------------------------------------------------

    def suggest(self, trial_id: str):
        if len(self._history) < self.n_initial:
            cfg = self._random_config()
        else:
            np = self._np
            scores = np.array([s for _, s in self._history])
            if self.mode == "max":
                scores = -scores
            cut = np.quantile(scores, self.gamma)
            configs = [c for c, _ in self._history]
            good = [c for c, s in zip(configs, scores) if s <= cut]
            bad = [c for c, s in zip(configs, scores) if s > cut]
            if not good or not bad:
                cfg = self._random_config()
            else:
                cfg = {
                    k: self._propose_dim(dom, [c[k] for c in good],
                                         [c[k] for c in bad])
                    for k, dom in self.space.items()
                }
        self._suggested[trial_id] = cfg
        return dict(cfg)

    def on_trial_complete(self, trial_id: str, result=None):
        cfg = self._suggested.pop(trial_id, None)
        if cfg is None or result is None or self.metric not in result:
            return
        self._history.append((cfg, float(result[self.metric])))
