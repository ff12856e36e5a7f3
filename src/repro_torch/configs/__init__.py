from .registry import (
    CONFIGS,
    SHAPES,
    all_cells,
    cell_applicable,
    get_config,
    input_specs,
    input_specs_for,
)

__all__ = [
    "CONFIGS",
    "SHAPES",
    "all_cells",
    "cell_applicable",
    "get_config",
    "input_specs",
    "input_specs_for",
]
