from repro_torch.parallel.packing import (
    Layout,
    LeafSlot,
    Packed,
    buffer_map,
    layout_of,
    leaf_segments,
    leaf_views,
    pack,
    packed_like,
    unpack,
    view_leaf,
)

__all__ = [
    "Layout",
    "LeafSlot",
    "Packed",
    "buffer_map",
    "layout_of",
    "leaf_segments",
    "leaf_views",
    "pack",
    "packed_like",
    "unpack",
    "view_leaf",
]
