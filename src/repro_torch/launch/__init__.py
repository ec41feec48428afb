"""Launchers (port of ``repro.launch``): the serving daemon,
``python -m repro_torch.launch.serve`` (single node, or the sharded fabric
drill with ``--shards > 0``).

The names of :mod:`repro_torch.launch.serve` are exported lazily, so that
running the module with ``-m`` does not import it twice."""
_SERVE = ("Deployment", "deploy", "undeploy", "probe_recall", "make_obs",
          "finish_obs", "make_quality_stack", "emit_health",
          "finish_quality", "run_single_node", "run_fabric",
          "FABRIC_TIER_ERROR", "main")

__all__ = list(_SERVE)


def __getattr__(name):
    if name in _SERVE:
        from . import serve

        return getattr(serve, name)
    raise AttributeError(name)
