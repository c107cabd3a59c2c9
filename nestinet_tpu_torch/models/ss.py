"""Single-scale normal estimation (ablation model).

Counterpart of `nestinet_tpu/models/ss.py`: one patch radius, one 3DmFV
grid, `SS_BACKBONE` (six inception blocks with two max pools), FC
1024/256/128 with dropout at keep 0.7, 3 linear outputs.  The JAX model
ignores `cfg.tiny_backbone`; so does this one.
"""

from __future__ import annotations

from . import backbones
from .base import SingleNetNormEst


class SSNormEst(SingleNetNormEst):
    def __init__(self, cfg, gmm):
        if cfg.n_scales != 1:
            raise ValueError("the single-scale model takes a single patch radius")
        super().__init__(cfg, gmm, backbones.SS_BACKBONE)
