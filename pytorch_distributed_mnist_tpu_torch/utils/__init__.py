"""Observability and device helpers of the port."""
