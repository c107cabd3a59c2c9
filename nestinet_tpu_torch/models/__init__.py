import torch

from .base import init_params
from .experts import ExpertsNormEst  # noqa: F401
from .ms import MSNormEst  # noqa: F401
from .ss import SSNormEst  # noqa: F401
from .switching import SwitchingNormEst  # noqa: F401

MODELS = {
    "ss_norm_est": SSNormEst, "ss": SSNormEst,
    "ms_norm_est": MSNormEst, "ms": MSNormEst,
    "ms_sw_n_est": SwitchingNormEst, "switching": SwitchingNormEst,
    "experts_n_est": ExpertsNormEst, "experts": ExpertsNormEst,
}


def build_model(cfg, gmm, generator=None, *, init: bool = True):
    """Model factory keyed by the reference's model names, as JAX's
    (`nestinet_tpu/models/__init__.py`).  The weights are initialized from
    `generator` (default: one seeded with `cfg.seed`, as JAX inits from
    PRNGKey(cfg.seed)); with `init=False` nothing is drawn and every
    parameter and state tensor keeps the zeros or ones it was allocated
    with, for a caller that loads all of them (`infer/predict.py::load_run`).
    Under a `torch.device` context they are allocated on that device."""
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model: {cfg.model}")
    model = MODELS[cfg.model](cfg, gmm)
    if init:
        init_params(model, torch.Generator().manual_seed(cfg.seed) if generator is None
                    else generator)
    return model
