"""YAML configs with a provenance snapshot and a write-back of the results
(port of crnn_tpu/infra/config.py).

The Cathode config flow (Cathode/src/header.jl:17-86,
crnn_cathode.jl:44-46): load a YAML into a case-config dataclass, copy it
into the results directory, and write the final losses back into that copy
when training ends. ``yaml`` is imported inside the functions that read or
write it, so the package imports without it.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Type, TypeVar

T = TypeVar("T")


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def config_from_yaml(cls: Type[T], path: str, **overrides: Any) -> T:
    """A case-config dataclass from a YAML file; unknown keys raise."""
    raw = load_yaml(path) or {}
    raw.update(overrides)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(raw) - names
    if unknown:
        raise ValueError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**raw)


def snapshot_config(config_path: str, results_dir: str) -> str:
    """Copy the config into the results dir (provenance, header.jl:86)."""
    os.makedirs(results_dir, exist_ok=True)
    dst = os.path.join(results_dir, os.path.basename(config_path))
    shutil.copyfile(config_path, dst)
    return dst


def writeback_results(config_path: str, updates: dict) -> None:
    """Add or overwrite result fields in a YAML snapshot
    (crnn_cathode.jl:44-46: the min train and val losses)."""
    import yaml

    data = load_yaml(config_path) or {}
    data.update(updates)
    with open(config_path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
