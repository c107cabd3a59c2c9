"""Streaming whole-shape inference and the shape-scatter writer."""
