"""Quantizer formats, KV-cache storage formats and the backend registry."""
