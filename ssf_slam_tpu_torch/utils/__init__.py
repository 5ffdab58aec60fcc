"""Run logging."""
