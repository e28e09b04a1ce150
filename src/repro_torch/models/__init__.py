"""Decoder model zoo in PyTorch: plain functions over parameter dicts.

This slice ports the dense attention + MLP stack (`model.py`); the other
block kinds of `spec.ArchConfig` raise NotImplementedError.
"""
