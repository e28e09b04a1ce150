"""Entry points: `serve` runs the context-routed serving path, `train` the
training launcher."""
