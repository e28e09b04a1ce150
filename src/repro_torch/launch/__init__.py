"""Entry points: `serve` runs the context-routed serving path."""
