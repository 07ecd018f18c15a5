"""Typed configuration: the ``dvd_tpu`` dataclasses, re-exported.

``dvd_tpu/config.py`` is pure Python (dataclasses + json) and
``dvd_tpu/__init__.py`` imports nothing, so the port reads the same flag
names without importing JAX.
"""

from dvd_tpu.config import (  # noqa: F401
    DataConfig,
    DiffusionConfig,
    DvDConfig,
    ModelConfig,
    ParallelConfig,
    PathsConfig,
    TrainConfig,
    default_config,
)
