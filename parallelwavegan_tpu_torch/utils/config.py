"""Config loading and writing (counterpart of parallelwavegan_tpu/utils/config.py).

``.json`` is read with the standard library. Any other file is read as
YAML where PyYAML imports, and as JSON (a subset of YAML) where it does
not: ``write_config`` writes JSON on a machine without PyYAML, so a
training run's ``config.yml`` is readable there and, as YAML, by the JAX
package. A YAML file that is not JSON needs PyYAML.
"""

from __future__ import annotations

import json


def load_config(path: str) -> dict:
    if not path.endswith(".json"):
        try:
            import yaml
        except ImportError:
            yaml = None
        if yaml is not None:
            with open(path) as f:
                return yaml.load(f, Loader=yaml.SafeLoader)
    with open(path) as f:
        try:
            return json.load(f)
        except json.JSONDecodeError as e:
            if path.endswith(".json"):
                raise
            raise ImportError(
                f"{path} is not JSON, and reading it as YAML needs PyYAML, "
                "which is not installed") from e


def merge_args(config: dict, args, exclude: tuple = ("config",)) -> dict:
    """The config with an argparse namespace's values laid over it (the
    arguments win), ``exclude`` left out."""
    merged = dict(config)
    for k, v in vars(args).items():
        if k in exclude:
            continue
        merged[k] = v
    return merged


def write_config(path: str, config: dict) -> None:
    """``config`` as YAML where PyYAML imports, else as JSON."""
    try:
        import yaml
    except ImportError:
        yaml = None
    with open(path, "w") as f:
        if yaml is None:
            json.dump(config, f, indent=1, sort_keys=True)
        else:
            yaml.dump(config, f, Dumper=yaml.SafeDumper)
