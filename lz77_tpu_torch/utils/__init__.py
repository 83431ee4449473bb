"""Metrics and failure handling."""
