"""Per-model configuration loading (counterpart of sesa_tpu/configs.py).

A config has the reference's sections ``audio.*``, ``model.*``,
``training.*`` and ``inference.*``. ``load_config`` takes a dict, a
``.json`` file or a ``.yaml`` file and returns an :class:`AttrDict`, a
small attribute-access dict (the JAX package uses ml_collections). YAML is
imported only for a ``.yaml`` path.
"""

from __future__ import annotations

import json
from typing import Union


class AttrDict(dict):
    """dict with attribute access, nested dicts wrapped recursively."""

    def __init__(self, data=None):
        super().__init__()
        for k, v in dict(data or {}).items():
            self[k] = AttrDict(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def config_from_dict(data: dict) -> AttrDict:
    """``data`` as an :class:`AttrDict`, the type :func:`load_config` returns
    (sesa_tpu/configs.py ``config_from_dict``)."""
    return AttrDict(data)


def load_config(model_type: str, config: Union[str, dict]) -> AttrDict:
    """Load a config from a dict, a ``.json`` path or a ``.yaml``/``.yml`` path."""
    if isinstance(config, dict):
        return config_from_dict(config)
    path = str(config)
    if path.lower().endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError:
            raise RuntimeError(f"{path}: reading YAML configs needs pyyaml; "
                               "pass a .json config instead") from None
        with open(path) as f:
            return AttrDict(yaml.load(f, Loader=yaml.FullLoader))
    with open(path) as f:
        return AttrDict(json.load(f))
