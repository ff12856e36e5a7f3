from .registry import CONFIGS, SHAPES, all_cells, cell_applicable, get_config

__all__ = ["CONFIGS", "SHAPES", "all_cells", "cell_applicable", "get_config"]
