"""The NumPy helpers of `nestinet_tpu/viz/`.

Every draw function of the JAX package's `viz/` renders with matplotlib,
which the card's machine does not have, so none is ported (ROADMAP.md
queue 1, item 4: the matplotlib renders).  What is ported is the
arithmetic they are drawn from, equal to JAX's on the same inputs:
`normals.py` (`euclidean_to_spherical`, `normal2rgb`), `clouds.py`
(`normalize_to_unit_sphere`, `confusion_counts`) and `fv.py`
(`unit_sphere`).
"""

from .clouds import confusion_counts, normalize_to_unit_sphere  # noqa: F401
from .fv import unit_sphere  # noqa: F401
from .normals import euclidean_to_spherical, normal2rgb  # noqa: F401
