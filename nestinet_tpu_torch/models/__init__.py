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


def build_model(cfg, gmm, generator=None):
    """Model factory keyed by the reference's model names, as JAX's
    (`nestinet_tpu/models/__init__.py`); the weights are initialized from
    `generator` (default: one seeded with `cfg.seed`)."""
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model: {cfg.model}")
    return MODELS[cfg.model](cfg, gmm, generator)
