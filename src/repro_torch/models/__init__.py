"""Model builders (dense decoder-only LMs in this slice)."""
