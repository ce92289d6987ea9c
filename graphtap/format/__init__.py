from graphtap.format.tiles import TileSet, build_tileset

__all__ = ["TileSet", "build_tileset"]
