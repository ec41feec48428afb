"""Core ANNS structures: distances, IVF index, quantization, LLSP, the
search engines (single-device and sharded) and the graph baseline.

The names below are exported lazily: the kernel modules import
``core.distance``, and an eager import of ``core.search`` here would run
before they finish."""
_NAMES = {
    "SearchConfig": "search", "serve_step": "search",
    "serve_leveled": "search", "make_sharded_serve": "search",
    "make_sharded_serve_quantized": "search",
    "NSWGraph": "graph_baseline", "SearchStats": "graph_baseline",
    "build_nsw_graph": "graph_baseline", "beam_search": "graph_baseline",
    "batch_search": "graph_baseline",
}

__all__ = list(_NAMES)


def __getattr__(name):
    if name in _NAMES:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"),
                       name)
    raise AttributeError(name)
