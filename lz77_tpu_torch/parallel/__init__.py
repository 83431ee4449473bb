"""Mesh construction and the sharded encode pipelines."""
