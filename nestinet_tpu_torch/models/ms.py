"""Multi-scale normal estimation (ablation model).

Counterpart of `nestinet_tpu/models/ms.py`: the grids of every patch radius
concatenated on channels (20 per radius), one CNN, `MS_BACKBONE_8G` on 8^3
Gaussian grids and `CONV_NET_3G` on 3^3 ones, FC 1024/256/128 with dropout
at keep 0.7, 3 linear outputs.  The JAX model ignores `cfg.tiny_backbone`;
so does this one.
"""

from __future__ import annotations

from . import backbones
from .base import SingleNetNormEst


class MSNormEst(SingleNetNormEst):
    def __init__(self, cfg, gmm):
        specs = {8: backbones.MS_BACKBONE_8G, 3: backbones.CONV_NET_3G}
        if gmm.resolution not in specs:
            raise ValueError("the multi-scale model supports 3^3 or 8^3 Gaussian grids "
                             "(parity: ms_norm_est.py:83-118)")
        super().__init__(cfg, gmm, specs[gmm.resolution])
