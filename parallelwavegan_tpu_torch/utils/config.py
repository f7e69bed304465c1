"""Config loading (counterpart of parallelwavegan_tpu/utils/config.py).

``.json`` is read with the standard library; YAML needs PyYAML, which is
imported only when a YAML file is read, so a machine without it can still
decode from a JSON config.
"""

from __future__ import annotations

import json


def load_config(path: str) -> dict:
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    import yaml

    with open(path) as f:
        return yaml.load(f, Loader=yaml.SafeLoader)
