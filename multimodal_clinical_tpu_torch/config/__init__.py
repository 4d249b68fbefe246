from .merge import deep_merge, load_and_merge_yaml, load_yaml, safe_load
from .setup import (
    KNOWN_DATASETS,
    config_to_args,
    load_config,
    seed_everything,
    setup_configs,
)

__all__ = [
    "deep_merge",
    "load_and_merge_yaml",
    "load_yaml",
    "safe_load",
    "KNOWN_DATASETS",
    "config_to_args",
    "load_config",
    "seed_everything",
    "setup_configs",
]
