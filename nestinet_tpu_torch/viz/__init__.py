"""The port's `viz/`: the counterpart of `nestinet_tpu/viz/`, every
function of the same name, parameters and defaults, drawn on the NumPy
canvas of `canvas.py` (no matplotlib) and written as PNG by `png.py`;
`colors.py` holds the colormaps.  `normals.py`: normals as RGB, the
(phi, theta) domain plots; `clouds.py`: the cloud renders, the confusion
matrix, the per-shape export set; `fv.py`: the 3DmFV and GMM plots.
"""

from .clouds import (  # noqa: F401
    confusion_counts,
    draw_point_cloud,
    export_shape_visualizations,
    normalize_to_unit_sphere,
    visualize_confusion_matrix,
    visualize_pc_experts,
    visualize_pc_overlay,
)
from .fv import draw_gaussian_points, draw_gaussians, unit_sphere, visualize_fv  # noqa: F401
from .normals import (  # noqa: F401
    discrete_cmap,
    draw_line_segments,
    draw_phi_theta_domain,
    euclidean_to_spherical,
    normal2rgb,
    visualize_pc_normals,
)
