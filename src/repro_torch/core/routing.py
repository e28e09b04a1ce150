"""Routing topologies (paper §4-§5), trimmed to what the serving router
reads: the semantic-routing detection latency."""
from __future__ import annotations

# Decode tokens a semantic misroute generates in the small-model pool
# before the quality monitor catches it and escalates (shared by the
# analytical Semantic model and the serving-side router, so the two layers
# price the same detection latency).
ESCALATION_DETECT_TOKENS = 32
