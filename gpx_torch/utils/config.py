"""Experiment config system — the port's own copy of
``gpx/utils/config.py`` (SURVEY.md §5: the reference hardcodes all
hyperparameters per example, with ``nIters`` from argv as the only flag).

Dataclass-based configs with CLI override (``--key value``, dotted keys for
nesting) and JSON round-trip — enough structure for the example entry points
without an external dependency.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
from typing import Any


def config(cls):
    """Decorate an experiment config dataclass."""
    return dataclasses.dataclass(cls)


def from_cli(cfg, argv=None):
    """Override config fields from ``--field value`` CLI args; values are
    parsed with the field's current type. Returns a new config."""
    argv = list(sys.argv[1:] if argv is None else argv)
    updates: dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            key = arg[2:].replace("-", "_")
            if i + 1 >= len(argv):
                raise SystemExit(f"missing value for {arg}")
            updates[key] = argv[i + 1]
            i += 2
        else:
            i += 1
    return replace_typed(cfg, updates)


def replace_typed(cfg, updates: dict):
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    coerced = {}
    for key, raw in updates.items():
        if key not in fields:
            raise SystemExit(f"unknown config field: {key}")
        current = getattr(cfg, key)
        if isinstance(current, bool):
            coerced[key] = str(raw).lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            coerced[key] = int(raw)
        elif isinstance(current, float):
            coerced[key] = float(raw)
        else:
            coerced[key] = raw
    return dataclasses.replace(cfg, **coerced)


def save(cfg, path):
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dataclasses.asdict(cfg), indent=2))
    return path


def load(cls, path):
    return cls(**json.loads(pathlib.Path(path).read_text()))
