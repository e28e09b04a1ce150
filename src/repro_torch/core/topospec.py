"""Topology vocabulary, trimmed to what the serving router re-exports."""
from __future__ import annotations

# kinds whose [small, large] rungs serve different models and whose
# classifier can misroute (the router's semantic flip)
SEMANTIC_KINDS = ("semantic", "semantic_fleetopt", "moe_semantic")
