from .xmlgen import QUERIES, DiscogsConfig, generate_discogs_tree

__all__ = ["DiscogsConfig", "QUERIES", "generate_discogs_tree"]
