"""Detector architectures, one module each: ``benchmark/archs/<arch>.py``,
named by a configuration file's ``"arch"`` key and found by that name, as
drivers and metric readers are. Nothing else in the harness knows an
architecture; ``README.md`` ("Adding to it") lists what a module provides.
"""

from __future__ import annotations

import importlib


def of(config: dict):
    """The architecture module that ``config`` names."""
    return importlib.import_module(f"{__name__}.{config['arch']}")
