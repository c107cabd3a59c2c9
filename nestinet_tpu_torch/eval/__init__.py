"""Scoring of served `.normals` files (copies of the JAX package's host
modules)."""

from .evaluate import PCPNET_TEST_SETS, evaluate_dataset, evaluate_datasets  # noqa: F401
from .metrics import angle_errors_deg, pgp, rms_angle_deg  # noqa: F401
