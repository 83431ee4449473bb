"""Codec pipelines: fused device encode, bytes-level codec, host references."""
