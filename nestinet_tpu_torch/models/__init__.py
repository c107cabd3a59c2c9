from .experts import ExpertsNormEst  # noqa: F401


def build_model(cfg, gmm, generator=None):
    """Model factory keyed by the reference's model names; the weights are
    initialized from `generator` (default: one seeded with `cfg.seed`).

    Only the mixture of experts is ported so far; the single-scale,
    multi-scale and noise-switching models are listed in ROADMAP.md.
    """
    name = cfg.model
    if name in ("experts_n_est", "experts"):
        return ExpertsNormEst(cfg, gmm, generator)
    if name in ("ss_norm_est", "ss", "ms_norm_est", "ms", "ms_sw_n_est", "switching"):
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (see ROADMAP.md, "
            "queue 1: ablations and variants)"
        )
    raise ValueError(f"unknown model: {name}")
