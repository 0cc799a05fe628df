"""Device compute helpers for the hot paths: the tile-sparse Cholesky
behind cholmod's device path, and the exact-split products of
ops.ozaki."""

from .tile_chol import TileCholesky, tile_pattern_from_sparse  # noqa: F401
