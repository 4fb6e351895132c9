"""ray_tpu_torch.tune: hyperparameter search over trial actors (port of
``ray_tpu/tune/``).

Role-equivalent to Ray Tune (reference: python/ray/tune — Tuner,
TuneController, search spaces, ASHA scheduler, experiment resume): trials
are actors, trials that need a card reserve it via resources_per_trial
(``{"GPU": 1}``), and gang trials compose with ray_tpu_torch.train inside
the trainable (a ``TorchTrainer`` trial's workers each ask for their own
card).
"""

from .schedulers import (
    ASHAScheduler,
    HyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from .search import (
    BasicVariantGenerator,
    ConcurrencyLimiter,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    sample_from,
    uniform,
)
from .tuner import (
    Result,
    ResultGrid,
    TuneConfig,
    TuneError,
    TuneInterrupted,
    Tuner,
    get_checkpoint,
    get_trial_dir,
    report,
)

__all__ = [
    "Tuner", "TuneConfig", "TuneError", "TuneInterrupted",
    "Result", "ResultGrid", "report", "get_trial_dir", "get_checkpoint",
    "grid_search", "choice", "uniform", "loguniform", "randint",
    "TPESearcher",
    "sample_from", "ASHAScheduler", "HyperBandScheduler", "FIFOScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining", "Searcher", "BasicVariantGenerator",
    "ConcurrencyLimiter",
]
