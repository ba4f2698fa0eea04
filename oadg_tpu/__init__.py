"""oadg_tpu: object-detection + domain-generalization framework in JAX
(same capability surface as WoojuLee24/OA-DG, built on jax/XLA).

Importing the top-level package registers every component (datasets,
pipelines, models, hooks) so config-driven building works out of the box.
"""
__version__ = "0.1.0"

from . import data  # noqa: F401  (registers datasets + pipeline ops)
from . import models  # noqa: F401  (registers model zoo)
from .core import hook  # noqa: F401  (registers hooks)
